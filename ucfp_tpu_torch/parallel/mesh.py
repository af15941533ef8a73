"""Device meshes for sharded serving (port of ucfp_tpu/parallel/mesh.py).

The reference is single-controller: one server process owns every device
and each query's per-shard steps run inside one shard_map program. The port
keeps that shape without torch.distributed: a Mesh is an array of torch
devices with axis names, the sharded state is one tensor per shard held by
this process (parallel.sharded_knn.ShardedTensor), and a merge gathers the
shards' candidates onto the first device with .to(). So one code path
serves N cards, several shards on one card ([cuda:0] * 8) and CPU
"devices" in the tests ([torch.device("cpu")] * 8, the counterpart of the
reference tests' 8 virtual CPU devices).
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Mesh:
    """`devices`: an object array of torch.device, one axis per name in
    `axis_names`; shards are numbered row-major over it (major axis
    first), as the reference's P(axes) numbers them. Entries may repeat."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis "
                             f"names and at least one device, got {axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_pinned(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        shape = dict(zip(self.axis_names, self.devices.shape))
        return f"Mesh({shape}, {sorted({str(d) for d in self.devices.flat})})"


def _pinned(device) -> torch.device:
    """torch.device with a CUDA index filled in, so shard placement checks
    compare like with like."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _take(n: int, devices) -> list[torch.device]:
    """The first n of `devices`, or of the CUDA cards when None. Never
    fewer: a mesh larger than the devices named raises."""
    if devices is None:
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"a mesh of {n} devices needs {n} CUDA devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    devs = list(devices)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices needs {n}, {len(devs)} named")
    return devs[:n]


def data_mesh(n_devices: int | None = None, axis: str = "d", devices=None) -> Mesh:
    """1-D mesh over the first n devices: the first n CUDA cards, or the
    first n of `devices` (entries may repeat)."""
    devices = None if devices is None else list(devices)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if devices is None else len(devices)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    return Mesh(_take(n_devices, devices), (axis,))


def data_mesh_2d(n_slices: int, per_slice: int,
                 axes: tuple[str, str] = ("s", "d"), devices=None) -> Mesh:
    """2-D mesh [n_slices, per_slice]: the inner axis ("d") is merged first
    (the reference's ICI axis), the outer ("s") last."""
    need = n_slices * per_slice
    if need < 1:
        raise ValueError(f"mesh {n_slices}x{per_slice} has no device")
    devs = np.empty(need, dtype=object)
    devs[:] = _take(need, devices)
    return Mesh(devs.reshape(n_slices, per_slice), axes)


def serving_mesh(devices=None) -> Mesh | None:
    """The reference's activation rule (ucfp_tpu/index/embedded.py:433-457)
    over `devices` (default: the CUDA cards): None under UCFP_SHARD=off;
    UCFP_MESH_SHAPE=<s>x<d> gives a 2-D mesh (raising when the devices are
    too few); otherwise a 1-D mesh over the largest power of two of the
    device count, when there are at least two."""
    if os.environ.get("UCFP_SHARD", "auto").lower() == "off":
        return None
    shape = os.environ.get("UCFP_MESH_SHAPE", "").lower()
    devices = None if devices is None else list(devices)
    if "x" in shape:
        s_, d_ = (int(x) for x in shape.split("x", 1))
        return data_mesh_2d(s_, d_, devices=devices)
    n = torch.cuda.device_count() if devices is None else len(devices)
    if n >= 2:
        return data_mesh(1 << (n.bit_length() - 1), devices=devices)
    return None
