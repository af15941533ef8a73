"""The asymmetric sketch scan (port of asym_sketch_scores_tiled,
ucfp_tpu/ops/knn.py).

The sketch is lane-tiled, [C/128, W, 128] int32 (ops.knn.tile_sketch): row
g*128 + lane's word w sits at [g, w, lane]. A query's plan (ops.knn.
sketch_query_plan) gives its sign bits qsign [W], one bit mask per level
masks [L, W], the level weights wts [L] and plane counts cnt [L]. Per row

    d_l  = sum_w popcount((sketch[w] ^ qsign[w]) & masks[l, w])
    wsum = fma(w3, d3, fma(w2, d2, fma(w0, d0, w1 * d1)))
    out  = const - 2 * wsum,   const = fma(w3, n3, fma(w2, n2, fma(w1, n1, w0 * n0)))

The fused multiply-adds are the reference's as XLA compiles it on the
CPU: LLVM contracts the Pallas kernel's level sum acc + w_l * d_l (its
first add pairs the two leading products, contracting the first) and the
jitted sum(wts * cnt) into exactly these chains (tests/test_torch_sketch.py
holds both bit for bit). 2 * wsum is exact, so the last step rounds once.

Kernel (CUDA C++ for sm_90a, csrc/sketch_scan.cu): asym_sketch_scores_tiled.
Beside it sits its plain PyTorch version (`*_plain`): the CPU path, and
the yardstick the card's kernel is held bit-equal to. The wrapper takes
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .fused_scan import _check, _popcount32, _stream_ptr
from .imagehash import _fma_f32

LANES = 128
WORDS = 24  # ops.knn.SKETCH_WORDS
LEVELS = 4  # ops.knn.SKETCH_LEVELS

#: kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"asym_sketch_scores_tiled": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


_lib = None


def _kernels():
    """The built kernel library with the sketch entry point's signature."""
    global _lib
    if _lib is None:
        from .._build import kernel_library

        lib = kernel_library()
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.ucfp_sketch_scan.restype = ctypes.c_int
        lib.ucfp_sketch_scan.argtypes = [p, ll, p, p, p, p, p, p]
        _lib = lib
    return _lib


def _plain(tiled, qsign, masks, wts, cnt) -> torch.Tensor:
    x = torch.bitwise_xor(tiled, qsign[None, :, None])
    d = [_popcount32(torch.bitwise_and(x, masks[li][None, :, None])).sum(dim=1)
         .float().reshape(-1) for li in range(LEVELS)]
    wsum = _fma_f32(wts[0], d[0], wts[1] * d[1])
    wsum = _fma_f32(wts[3], d[3], _fma_f32(wts[2], d[2], wsum))
    const = _fma_f32(wts[1], cnt[1], wts[0] * cnt[0])
    const = _fma_f32(wts[3], cnt[3], _fma_f32(wts[2], cnt[2], const))
    return const - 2.0 * wsum


def _scores(tiled, qsign, masks, wts, cnt, plain: bool) -> torch.Tensor:
    name = "asym_sketch_scores_tiled"
    if tiled.dim() != 3 or tiled.dtype != torch.int32 or tiled.shape[1:] != (WORDS, LANES):
        raise ValueError(f"{name}: the sketch must be [C/128, {WORDS}, {LANES}] int32, "
                         f"got {tiled.dtype} {tuple(tiled.shape)}")
    if (qsign.shape != (WORDS,) or masks.shape != (LEVELS, WORDS)
            or wts.shape != (LEVELS,) or cnt.shape != (LEVELS,)):
        raise ValueError(f"{name}: the plan must be qsign [{WORDS}], masks "
                         f"[{LEVELS}, {WORDS}], wts [{LEVELS}], cnt [{LEVELS}]")
    dev = tiled.device
    if any(t.device != dev for t in (qsign, masks, wts, cnt)):
        raise ValueError(f"{name}: the plan must be on {dev}")
    qsign, masks = qsign.to(torch.int32).contiguous(), masks.to(torch.int32).contiguous()
    wts, cnt = wts.float().contiguous(), cnt.float().contiguous()
    if plain or dev.type == "cpu":
        return _plain(tiled, qsign, masks, wts, cnt)
    if not tiled.is_contiguous():
        raise ValueError(f"{name}: the sketch must be contiguous")
    out = torch.empty(tiled.shape[0] * LANES, dtype=torch.float32, device=dev)
    rc = _kernels().ucfp_sketch_scan(tiled.data_ptr(), tiled.shape[0], qsign.data_ptr(),
                                     masks.data_ptr(), wts.data_ptr(), cnt.data_ptr(),
                                     out.data_ptr(), _stream_ptr(tiled))
    _check(rc, name)
    _count(name)
    return out


def asym_sketch_scores_tiled(sk_tiled: torch.Tensor, qsign: torch.Tensor,
                             masks: torch.Tensor, wts: torch.Tensor,
                             cnt: torch.Tensor) -> torch.Tensor:
    """[C] f32 asymmetric scores (higher = closer) of the lane-tiled sketch
    [C/128, 24, 128] int32 under one query plan (qsign [24], masks [4, 24]
    int32 bit patterns, wts [4] and cnt [4] f32)."""
    return _scores(sk_tiled, qsign, masks, wts, cnt, plain=False)


def asym_sketch_scores_tiled_plain(sk_tiled: torch.Tensor, qsign: torch.Tensor,
                                   masks: torch.Tensor, wts: torch.Tensor,
                                   cnt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of asym_sketch_scores_tiled on any device."""
    return _scores(sk_tiled, qsign, masks, wts, cnt, plain=True)
