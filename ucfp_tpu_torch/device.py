"""The one place that decides which device the port runs on.

Every entry point (EmbeddedBackend, the server's --device flag, the image
hash functions) passes its `device` argument through `resolve_device`.
No device named means the CUDA card; a missing card is an error, never a
silent move to the CPU. Callers that want the CPU (the tests) say so.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device (raises when there is none);
    anything else -> torch.device(device), checked for availability."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    return dev
