"""Row-sharded top-k with a cross-shard merge (port of
ucfp_tpu/parallel/sharded_knn.py, its serving functions).

The catalog [C, D] is cut into contiguous row blocks, one per mesh shard
(packed int4/int2 columns [D/den, C] into column blocks; the lane-tiled
sketch [C/128, W, 128] into tile-row blocks); the query is replicated.
Each shard runs the port's single-device step (ops.knn and the CUDA
scans) over its rows with k_local = min(k, shard rows), so any k <= C
stays exact; the shards' candidates then meet on the first shard's device
and one stable selection keeps the best k — the reference's two-stage
all_gather + lax.top_k. The merge concatenates the shards in shard order,
so ties go to the lower shard, then to the lower local rank, as the
reference's stable lax.top_k over [Q, n * kc] gives them; on a 2-D mesh it
merges the innermost axis first, then the outer one (sharded_knn.py:86-87).

Scores are the reference's sharded formulas, which differ from the
single-device paths': f32 cosine with per-shard norms and the denom == 0
guard; int8 single dots / max(|row|, 1e-9); int8 batch dots /
(max(|q|, 1e-9) * max(|row|, 1e-9)) on a query quantized in the shard; the
Hamming sentinel for invalid rows is 0x7FFFFFFF. The int4, int2 and sketch
shards run ops.knn's pipelines with the per-shard pools of the reference.

Design: one process holds every shard (see parallel.mesh); each shard's
step runs on its own device (under torch.cuda.device for a CUDA shard, so
the kernels launch on that card's stream), in shard order. A shard never
moves to another device: state that lives on the wrong device raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import fused_scan
from ..ops import imagehash
from ..ops import knn as knn_ops
from .mesh import Mesh

AXIS = "d"


class ShardedTensor:
    """One tensor cut into equal contiguous blocks along `dim`, block s on
    the s-th shard's device: the port's counterpart of a jax.Array placed
    with NamedSharding(mesh, P(axes)) on that dimension."""

    __slots__ = ("shards", "dim")

    def __init__(self, shards: list[torch.Tensor], dim: int = 0):
        self.shards = list(shards)
        self.dim = dim

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.dim] = sum(t.shape[self.dim] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __and__(self, other: "ShardedTensor") -> "ShardedTensor":
        return ShardedTensor([a & b for a, b in zip(self.shards, other.shards)], self.dim)

    def full(self) -> torch.Tensor:
        """The whole tensor on the first shard's device."""
        dev = self.shards[0].device
        return torch.cat([t.to(dev) for t in self.shards], dim=self.dim)


def _flat_shard_index(coords: tuple, sizes: tuple) -> int:
    """Flattened shard id of mesh coordinates over the sharded axes,
    row-major (major axis first), as P(axes, ...) numbers row blocks."""
    idx = 0
    for c, n in zip(coords, sizes):
        idx = idx * n + c
    return idx


def _shard_devices(mesh: Mesh, axes) -> tuple[list[torch.device], tuple]:
    """(device of each shard in shard order, the sharded axes' sizes).
    `axes` must name mesh axes in mesh order; an axis left out is
    replicated, so its first device stands for it."""
    axes = tuple(axes)
    names = mesh.axis_names
    if not axes or [a for a in names if a in axes] != list(axes):
        raise ValueError(f"axes {axes} must be mesh axes {names} in mesh order")
    devs = mesh.devices
    for ax in reversed(range(len(names))):
        if names[ax] not in axes:
            devs = np.take(devs, 0, axis=ax)
    sizes = devs.shape
    out = [None] * devs.size
    for coords in np.ndindex(*sizes):
        out[_flat_shard_index(coords, sizes)] = devs[coords]
    return out, sizes


def shard_tensor(x, mesh: Mesh, axes=(AXIS,), dim: int = 0) -> ShardedTensor:
    """x cut into one contiguous block per shard along `dim`, each block
    on its shard's device. A ShardedTensor passes through once its blocks
    are checked to sit on the mesh's devices."""
    devs, _ = _shard_devices(mesh, axes)
    if isinstance(x, ShardedTensor):
        if len(x.shards) != len(devs) or x.dim != dim:
            raise ValueError(f"{len(x.shards)} shards on dim {x.dim} for a mesh of "
                             f"{len(devs)} shards on dim {dim}")
        for s, (t, dev) in enumerate(zip(x.shards, devs)):
            if t.device != dev:
                raise ValueError(f"shard {s} lives on {t.device}, its mesh device is {dev}")
        return x
    n = len(devs)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{size} rows do not split evenly over {n} shards")
    step = size // n
    return ShardedTensor([x.narrow(dim, s * step, step).to(dev).contiguous()
                          for s, dev in enumerate(devs)], dim)


def shard_matrix(mesh: Mesh, matrix, valid, axes=(AXIS,)):
    """Place [C, D] rows and [C] validity across the mesh (C % n == 0)."""
    return shard_tensor(matrix, mesh, axes), shard_tensor(valid, mesh, axes)


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _merge_axis(vals: list, idx: list, k: int, largest: bool = True):
    """One two-stage merge step: the shards' [Q, kc] candidates side by
    side in shard order ([Q, n * kc] on the first one's device), then the
    best min(k, n * kc) by a stable sort (ties to the lower position, as
    lax.top_k; largest=False keeps the smallest, as top_k of the negated
    distances does)."""
    dev = vals[0].device
    v = torch.cat([x.to(dev) for x in vals], dim=1)
    i = torch.cat([x.to(dev) for x in idx], dim=1)
    order = torch.sort(v, dim=1, descending=largest, stable=True).indices
    order = order[:, :min(k, v.shape[1])]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


def _merge(vals: list, idx: list, sizes: tuple, k: int, largest: bool):
    """Hierarchical merge over the sharded axes, innermost first: shards
    are numbered row-major, so each run of sizes[-1] consecutive shards
    is one innermost group."""
    for n in reversed(sizes):
        merged = [_merge_axis(vals[g:g + n], idx[g:g + n], k, largest)
                  for g in range(0, len(vals), n)]
        vals, idx = [m[0] for m in merged], [m[1] for m in merged]
    return vals[0], idx[0]


def _sharded_topk(mesh: Mesh, axes, k: int, local, sharded, replicated=(),
                  largest: bool = True):
    """Run `local(rows, shard, *shard blocks, *replicated)` -> ([Q, kl]
    values, [Q, kl] shard-local rows) on every shard's device, offset the
    rows to global ones and merge. `sharded` lists (tensor, dim); the
    first one's blocks give the shard height."""
    devs, sizes = _shard_devices(mesh, axes)
    parts = [shard_tensor(x, mesh, axes, dim) for x, dim in sharded]
    vals, idx = [], []
    for s, dev in enumerate(devs):
        blocks = [p.shards[s] for p in parts]
        rows = blocks[0].shape[sharded[0][1]]
        with _on(dev):
            v, i = local(rows, s, *blocks, *[r.to(dev) for r in replicated])
        vals.append(v)
        idx.append(i.long() + s * rows)
    return _merge(vals, idx, sizes, k, largest)


def _one_axis(mesh: Mesh, name: str) -> tuple:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{name} merges along a 1-D mesh only, got {mesh}")
    return mesh.axis_names


def sharded_cosine_topk(query, matrix, valid, k: int, mesh: Mesh, axes=(AXIS,)):
    """query [Q, D] f32, matrix [C, D] row-sharded over `axes`, valid [C]
    -> ([Q, k] scores, [Q, k] global rows). Full float32 products (TF32
    off, ops.knn)."""
    def local(rows, s, m, v, q):
        scores = knn_ops._cosine_scores(q, m, v)
        return knn_ops._topk_stable(scores, min(k, rows), largest=True)

    return _sharded_topk(mesh, axes, k, local, [(matrix, 0), (valid, 0)], [query])


def sharded_hamming_topk(query, matrix, valid, k: int, mesh: Mesh, axes=(AXIS,)):
    """query [Q, W] int32 (u32 bits), matrix [C, W] row-sharded -> ([Q, k]
    int32 distances, [Q, k] global rows), smallest first; invalid rows
    0x7FFFFFFF."""
    def local(rows, s, m, v, q):
        return knn_ops.hamming_topk(q, m, v, min(k, rows))

    return _sharded_topk(mesh, axes, k, local, [(matrix, 0), (valid, 0)], [query],
                         largest=False)


def sharded_hamming_topk_fused(query, matrix, k: int, mesh: Mesh):
    """The fused candidate scan (kernel hamming_topk_fused) per shard +
    the merge, on a 1-D mesh. query [W] int32, matrix [C, W] row-sharded
    with (C / n) % 32768 == 0; no validity mask (callers keep the matrix
    dense). Each shard keeps its best k candidate cells -> ([k] int32
    distances, [k] global rows)."""
    axes = _one_axis(mesh, "sharded_hamming_topk_fused")

    def local(rows, s, m, q):
        d, i = fused_scan.hamming_topk_fused(q, m, k)
        return d[None], i[None]

    d, i = _sharded_topk(mesh, axes, k, local, [(matrix, 0)], [query], largest=False)
    return d[0], i[0]


def _int8_scores(dots, rn, v):
    """dots / max(|row|, 1e-9) where valid and |row| > 0, else -inf."""
    ok = v & (rn > 0.0)
    return torch.where(ok, dots.float() / torch.clamp(rn, min=1e-9), knn_ops.NEG_INF)


def sharded_cosine_int8_topk(q8, db8, row_norm, valid, k: int, mesh: Mesh):
    """int8 row-sharded scan on a 1-D mesh: q8 [D] int8 (pre-quantized:
    scores are dot / |row|; divide by |q8| outside), db8 [C, D8 >= D] int8
    row-sharded, row_norm / valid [C] -> ([k] scores, [k] global rows)."""
    axes = _one_axis(mesh, "sharded_cosine_int8_topk")

    def local(rows, s, m, rn, v, q):
        dots = knn_ops.int8_dots(q[None], m)[0]
        return knn_ops._topk_stable(_int8_scores(dots, rn, v)[None], min(k, rows),
                                    largest=True)

    vals, idx = _sharded_topk(mesh, axes, k, local,
                              [(db8, 0), (row_norm, 0), (valid, 0)], [q8])
    return vals[0], idx[0]


def sharded_cosine_int8_batch_topk(query, db8, row_norm, valid, k: int,
                                   mesh: Mesh, axes=(AXIS,)):
    """query [Q, D] f32 (quantized in each shard, the rule of
    ops.knn.cosine_topk_int8), db8 [C, D8 >= D] int8 row-sharded, row_norm /
    valid [C] -> ([Q, k] scores, [Q, k] global rows). Scores are dots /
    (max(|qq|, 1e-9) * max(|row|, 1e-9))."""
    def local(rows, s, m, rn, v, q):
        qq = knn_ops._quantize_query_rows(q)
        dots = knn_ops.int8_dots(qq, m).float()
        qn = knn_ops.int8_norms(qq)[:, None]
        denom = torch.clamp(qn, min=1e-9) * torch.clamp(rn, min=1e-9)[None, :]
        ok = v[None, :] & (rn[None, :] > 0.0) & (qn > 0.0)
        scores = torch.where(ok, dots / denom, knn_ops.NEG_INF)
        return knn_ops._topk_stable(scores, min(k, rows), largest=True)

    return _sharded_topk(mesh, axes, k, local,
                         [(db8, 0), (row_norm, 0), (valid, 0)], [query])


def sharded_cosine_sketch_topk(query, planes, db8, row_norm, sketch, valid,
                               k: int, cand: int, mesh: Mesh, axes=(AXIS,)):
    """Sketch-prefilter cosine: query [D] f32 replicated; db8, row_norm,
    valid row-sharded, the lane-tiled sketch [C/128, W, 128] sharded on
    its tile rows. Each shard rescores its proportional share of the pool,
    max(512, 16k, ceil(cand * rows / C)) capped at its rows -> ([k]
    scores, [k] global rows). (The reference also takes a row-major [C, W]
    sketch; the port's caches and scan hold the tiled layout only.)"""
    if len(sketch.shape) != 3:
        raise ValueError("sharded_cosine_sketch_topk takes the lane-tiled "
                         "[C/128, W, 128] sketch (ops.knn.tile_sketch)")
    total_c = db8.shape[0]

    def local(rows, s, m, rn, sk, v, q, pl):
        cand_local = min(rows, max(512, 16 * k, (cand * rows + total_c - 1) // total_c))
        vals, idx = knn_ops.cosine_sketch_topk(q, pl, m, rn, sk, v, min(k, rows),
                                               cand_local)
        return vals[None], idx[None]

    vals, idx = _sharded_topk(mesh, axes, k, local,
                              [(db8, 0), (row_norm, 0), (sketch, 0), (valid, 0)],
                              [query, planes])
    return vals[0], idx[0]


def _packed(kind: str):
    """(single pipeline, its pool, batched pipeline, its pool) of a tier."""
    if kind == "int2":
        return (knn_ops.cosine_int2_topk, knn_ops.int2_pool,
                knn_ops.cosine_int2_topk_batched, knn_ops.int2_batch_pool)
    return (knn_ops.cosine_int4_topk, knn_ops.int4_pool,
            knn_ops.cosine_int4_topk_batched, knn_ops.int4_batch_pool)


def _local_prefix(n_valid: int, s: int, rows: int) -> int:
    """A global prefix length as shard s's prefix (rows are contiguous
    blocks): clip(n - s * rows, 0, rows)."""
    return min(max(int(n_valid) - s * rows, 0), rows)


def _sharded_packed_topk(kind, query, db8, row_norm, packed_t, inv_n, valid,
                         k, mesh, axes, n_valid):
    topk_fn, pool_fn = _packed(kind)[:2]

    def local(rows, s, m, rn, pk, inv, v, q):
        # each shard keeps the tier's full fixed pool over its own rows
        n_local = None if n_valid is None else _local_prefix(n_valid, s, rows)
        vals, idx = topk_fn(q, m, rn, pk, inv, v, min(k, rows), pool_fn(rows, k),
                            n_valid=n_local)
        return vals[None], idx[None]

    vals, idx = _sharded_topk(
        mesh, axes, k, local,
        [(db8, 0), (row_norm, 0), (packed_t, 1), (inv_n, 0), (valid, 0)], [query])
    return vals[0], idx[0]


def sharded_cosine_int4_topk(query, db8, row_norm, packed_t, inv_n4, valid,
                             k: int, mesh: Mesh, axes=(AXIS,), n_valid=None):
    """Packed-int4 prefilter per shard: query [D] f32 replicated; db8
    [C, D8] row-sharded; packed_t [D/2, C] COLUMN-sharded over the same
    axes (catalog rows ride the columns); n_valid (a global prefix length,
    unfiltered queries) becomes each shard's prefix and selects the fused
    kernel -> ([k] scores, [k] global rows)."""
    return _sharded_packed_topk("int4", query, db8, row_norm, packed_t, inv_n4, valid,
                                k, mesh, axes, n_valid)


def sharded_cosine_int2_topk(query, db8, row_norm, packed_t, inv_n2, valid,
                             k: int, mesh: Mesh, axes=(AXIS,), n_valid=None):
    """sharded_cosine_int4_topk with the int2 pipeline, its fixed pool per
    shard and packed_t [D/4, C] column-sharded."""
    return _sharded_packed_topk("int2", query, db8, row_norm, packed_t, inv_n2, valid,
                                k, mesh, axes, n_valid)


def _sharded_packed_batch_topk(kind, query, db8, row_norm, packed_t, inv_n, n_valid,
                               k, mesh, axes):
    batched, pool_fn = _packed(kind)[2:]

    def local(rows, s, m, rn, pk, inv, q):
        return batched(q, m, rn, pk, inv, _local_prefix(n_valid, s, rows),
                       min(k, rows), pool_fn(rows, k))

    return _sharded_topk(mesh, axes, k, local,
                         [(db8, 0), (row_norm, 0), (packed_t, 1), (inv_n, 0)], [query])


def sharded_cosine_int4_batch_topk(query, db8, row_norm, packed_t, inv_n4, n_valid,
                                   k: int, mesh: Mesh, axes=(AXIS,)):
    """Batched packed-int4 prefilter per shard over prefix validity
    (valid == arange < n_valid globally; filtered batches take the int8
    path): query [Q, D] f32 -> ([Q, k] scores, [Q, k] global rows)."""
    return _sharded_packed_batch_topk("int4", query, db8, row_norm, packed_t, inv_n4,
                                      n_valid, k, mesh, axes)


def sharded_cosine_int2_batch_topk(query, db8, row_norm, packed_t, inv_n2, n_valid,
                                   k: int, mesh: Mesh, axes=(AXIS,)):
    """sharded_cosine_int4_batch_topk with the int2 batched pipeline
    (packed_t [D/4, C] column-sharded)."""
    return _sharded_packed_batch_topk("int2", query, db8, row_norm, packed_t, inv_n2,
                                      n_valid, k, mesh, axes)


def sharded_multihash_topk(query, matrix, valid, params, k: int, mesh: Mesh,
                           axes=(AXIS,)):
    """ops.imagehash.multihash_weighted_topk per shard + the merge: the
    reference runs the weighted compare on its sharded bundle cache as one
    program, whose top-k over the whole catalog this reproduces (scores
    are per row; ties to the lower row). query [Q, 134] int32 ->
    ([Q, k] scores, [Q, k] global rows)."""
    def local(rows, s, m, v, q, p):
        return imagehash.multihash_weighted_topk(q, m, v, p, min(k, rows))

    return _sharded_topk(mesh, axes, k, local, [(matrix, 0), (valid, 0)],
                         [query, params])
