"""Fused per-(tile, lane) candidate top-k scans (port of ucfp_tpu/ops/pallas_scan.py).

Candidate-set semantics, identical to the reference: the catalog is
viewed as [rows, 128] lanes; each tile keeps its best row PER LANE (ties:
the lowest row), and the final top-k selects across tiles x lanes. Exact
for k=1; for small k two true top-k entries collide in one (tile, lane)
cell with probability ~k^2/(2*tiles*128). Callers mark such responses
approximate.

Kernels (CUDA C++ for sm_90a, csrc/fused_scan.cu):
  * scores_topk_fused_batched  — per-cell argbest over precomputed
    scores, tiles of ROWS_PER_TILE=256 rows x 128 lanes;
    scores_topk_fused is its single-query [C] form (the same kernel at
    Q = 1, counted under its own name);
  * hamming_topk_fused_batched — the per-cell argmin of Hamming
    distances, tiles of ROWS_PER_TILE//2=128 rows x 128 lanes: below
    the path threshold (hamming_paths_info) a streaming XOR-popcount
    kernel, from it the distances as an exact int8 product on the
    tensor cores with the catalog read once per block of up to 64
    queries (_hamming_cells_mma_plain mirrors that formulation);
  * dots_norm_topk_fused_batched — int32 dots -> cosine (/|row| * 1/|q|)
    -> prefix validity -> per-cell argbest, tiles of 256 rows x 128
    lanes, QSEL queries per block so the row norms are read once per
    query block; dots_norm_topk_fused is its single-query [C] form;
  * hamming_topk_fused — one query's XOR-popcount + per-cell argmin with
    no validity mask, tiles of ROWS_PER_TILE=256 rows x 128 lanes (the
    per-shard scan of parallel.sharded_knn.sharded_hamming_topk_fused);
  * cosine_int8_topk_fused — one int8 query's dots against the [C, D]
    int8 catalog, each divided by max(|row|, 1e-9), then the per-cell
    argbest, tiles of ROWS_PER_TILE_C=128 rows x 128 lanes;
  * cosine_int8_topk_mxu — the catalog read as 128-byte lines of
    128 // D rows; per (tile, segment, slot) cell the best raw dot and
    its first line, then /|row| on those candidates only.

cosine_int8_topk_hybrid (the int8 product of ops.knn.int8_dots feeding
dots_norm_topk_fused) is the same function as cosine_int8_topk_fused
with no kernel of its own.

The final selection runs over the flat candidate array in the order
t*128 + lane (the reference's moveaxis/reshape order, NOT global row
order) and keeps the first k of a stable sort, so ties keep the lower
position exactly as lax.top_k does: on the card a kernel of its own
(select_topk, csrc/select.cu: radix select of a unique composite key,
then a sort of the k winners; one block per query, or for a few queries
over many candidates a thread-block cluster per query, whose partition
_select_cluster_plain mirrors; #1, #2, #3, #6 and #7 launch it with
their cells kernel from one host call), on the CPU the stable sort itself. Every
`*_plain` wrapper selects with the stable sort on any device, so the
card's selection is held against it too. Beside each kernel sits its
plain PyTorch version (`*_plain`): the CPU path, and the yardstick the
card's kernel is held bit-equal to. A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

LANES = 128
ROWS_PER_TILE = 256  # scores tile: ROWS_PER_TILE * 128 catalog rows
ROWS_PER_TILE_C = 128  # int8-cosine tile: ROWS_PER_TILE_C * 128 catalog rows
DN_SLICES = 8  # interleaved row slices of the dots-norm cells kernel (csrc/fused_scan.cu)
SUB = 8  # segments per int8-cosine line tile (cosine_int8_topk_mxu)
HAMMING_ROWS_PER_TILE = ROWS_PER_TILE // 2  # Hamming tile: 128 * 128 rows
QSEL = 8  # the reference's query block (pallas_scan.QSEL): the plain Hamming cells' chunk
# widest fingerprint (u32 words) the fused Hamming kernel takes; wider
# fingerprints ride the exact ops.knn.hamming_topk path
MAX_FUSED_HAMMING_WORDS = 16
# row widths the int8-cosine kernels take on the card (those the GPU
# smoke test holds bit-equal); the plain versions take any D
COSINE_I8_KERNEL_DIMS = (64,)
MXU_KERNEL_DIMS = (32, 64, 128)
_INVALID_DIST = 1 << 30
NEG_INF = float("-inf")

#: kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"scores_topk_fused_batched": 0, "hamming_topk_fused_batched": 0,
            "scores_topk_fused": 0, "dots_norm_topk_fused": 0,
            "dots_norm_topk_fused_batched": 0, "hamming_topk_fused": 0,
            "cosine_int8_topk_fused": 0, "cosine_int8_topk_mxu": 0,
            "select_topk": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(*names: str) -> None:
    with _count_lock:
        for name in names:
            LAUNCHES[name] += 1


_lib = None


def _kernels():
    """The built kernel library with its ctypes signatures (first call
    builds csrc/*.cu; a failed build raises)."""
    global _lib
    if _lib is None:
        from .._build import kernel_library

        lib = kernel_library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ucfp_scores_cells.restype = i
        lib.ucfp_scores_cells.argtypes = [p, i, i, i, ll, p, p, p]
        lib.ucfp_hamming_cells.restype = i
        lib.ucfp_hamming_cells.argtypes = [p, i, i, p, p, ll, p, p, i, p]
        lib.ucfp_hamming_batched_topk.restype = i
        lib.ucfp_hamming_batched_topk.argtypes = [p, i, i, p, p, ll, i, i, p, p, p, p, p, p]
        lib.ucfp_hamming_paths_info.restype = i
        lib.ucfp_hamming_paths_info.argtypes = [i, ctypes.POINTER(i)]
        lib.ucfp_dots_norm_cells.restype = i
        lib.ucfp_dots_norm_cells.argtypes = [p, i, ll, p, ll, p, p, p, p]
        lib.ucfp_dots_norm_blocks_per_sm.restype = i
        lib.ucfp_dots_norm_blocks_per_sm.argtypes = [i, ctypes.POINTER(i)]
        lib.ucfp_hamming_topk_cells.restype = i
        lib.ucfp_hamming_topk_cells.argtypes = [p, i, p, ll, p, p, p]
        lib.ucfp_cosine_i8_cells.restype = i
        lib.ucfp_cosine_i8_cells.argtypes = [p, i, p, ll, p, p, p, p]
        lib.ucfp_cosine_i8_mxu_cells.restype = i
        lib.ucfp_cosine_i8_mxu_cells.argtypes = [p, i, p, ll, i, p, p, p]
        lib.ucfp_select_topk_path.restype = i
        lib.ucfp_select_topk_path.argtypes = [p, p, i, i, i, i, i, p, p, p, i, p]
        lib.ucfp_select_cluster_info.restype = i
        lib.ucfp_select_cluster_info.argtypes = [ctypes.POINTER(i)]
        lib.ucfp_select_scratch.restype = ll
        lib.ucfp_select_scratch.argtypes = [i, i]
        lib.ucfp_scores_topk.restype = i
        lib.ucfp_scores_topk.argtypes = [p, i, i, i, ll, i, p, p, p, p, p, p]
        lib.ucfp_hamming_topk.restype = i
        lib.ucfp_hamming_topk.argtypes = [p, i, p, ll, i, p, p, p, p, p, p]
        lib.ucfp_cosine_i8_topk.restype = i
        lib.ucfp_cosine_i8_topk.argtypes = [p, i, p, ll, p, i, p, p, p, p, p, p]
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")


def _stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the raw handle the
    kernels launch on (what torch.cuda.current_stream(dev).cuda_stream
    returns, without building a Stream object: a wrapper's host time is
    most of a small scan's time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _pair_out(q: int, n: int, dtype, device):
    """[q, n] values in dtype and [q, n] int32 indices, from one
    allocation when the values take 4 bytes."""
    if dtype == torch.bfloat16:
        return (torch.empty((q, n), dtype=dtype, device=device),
                torch.empty((q, n), dtype=torch.int32, device=device))
    buf = torch.empty((2, q, n), dtype=torch.int32, device=device)
    return buf[0].view(dtype), buf[1]


# ---------------------------------------------------------------------------
# cells: [Q, tiles * 128] best value + flat catalog index per (tile, lane)
# ---------------------------------------------------------------------------


def _scores_cells_plain(scores: torch.Tensor, largest: bool,
                        rows_per_tile: int = ROWS_PER_TILE):
    """_qblock_argbest literally: max (or min) per cell, then the smallest
    row among the hits; the value is the winning row's own element."""
    q, c = scores.shape
    tiles = c // (rows_per_tile * LANES)
    s4 = scores.reshape(q, tiles, rows_per_tile, LANES)
    f = s4.float()
    best = f.amax(dim=2) if largest else f.amin(dim=2)
    rows = torch.arange(rows_per_tile, device=scores.device).view(1, 1, -1, 1)
    first = torch.where(f == best[:, :, None, :], rows,
                        rows_per_tile).amin(dim=2)  # [Q, T, 128]
    val = torch.gather(s4, 2, first[:, :, None, :]).squeeze(2)
    t_ix = torch.arange(tiles, device=scores.device).view(1, -1, 1)
    lanes = torch.arange(LANES, device=scores.device).view(1, 1, -1)
    gidx = (t_ix * rows_per_tile + first) * LANES + lanes
    return val.reshape(q, -1), gidx.to(torch.int32).reshape(q, -1)


def _scores_cells_cuda(scores: torch.Tensor, largest: bool,
                       name: str = "scores_topk_fused_batched"):
    q, c = scores.shape
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    scores = _aligned16(scores)  # 16-byte loads
    tiles = c // (ROWS_PER_TILE * LANES)
    best, gidx = _pair_out(q, tiles * LANES, scores.dtype, scores.device)
    rc = _kernels().ucfp_scores_cells(
        scores.data_ptr(), int(scores.dtype == torch.bfloat16), int(largest),
        q, c, best.data_ptr(), gidx.data_ptr(), _stream_ptr(scores),
    )
    _check(rc, name)
    _count(name)
    return best, gidx


def _scores_topk_cuda(scores: torch.Tensor, k: int, largest: bool, name: str):
    """#1 / #3 whole: the cells kernel and the selection kernel over its
    cells, launched from one host call (ucfp_scores_topk) -> values and
    int32 indices, [Q, k] (or [k] for one query's [C] scores). At one
    query these scans are host-bound, so the host work is kept short: one
    host call instead of two (the cells, then _select), and for float32
    the cells and the outputs share one allocation. PERF.md section 6 has
    the A/B against two calls and two allocations on an H100."""
    if not scores.is_contiguous():
        raise ValueError("scores must be contiguous")
    scores = _aligned16(scores)  # 16-byte loads
    c = scores.shape[-1]
    q = scores.numel() // c
    n = c // ROWS_PER_TILE  # (tile, lane) cells per query
    scratch = _select_scratch(q, n, k, scores.device)
    shape = (*scores.shape[:-1], k)
    dev = scores.device
    if scores.dtype == torch.bfloat16:
        best, gidx = _pair_out(q, n, scores.dtype, dev)  # kept alive to the launch
        cells = (best.data_ptr(), gidx.data_ptr())
        out_v = torch.empty(shape, dtype=scores.dtype, device=dev)
        out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    else:  # cells (values, indices), then the outputs (values, indices)
        ws = torch.empty(2 * q * (n + k), dtype=torch.int32, device=dev)
        cells = (ws.data_ptr(), ws.data_ptr() + 4 * q * n)
        out = ws[2 * q * n:].view(2, *shape)
        out_v, out_i = out[0].view(scores.dtype), out[1]
    rc = _kernels().ucfp_scores_topk(
        scores.data_ptr(), int(scores.dtype == torch.bfloat16), int(largest), q, c, k,
        *cells, out_v.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(), _stream_ptr(scores),
    )
    _check(rc, name)
    _count(name, "select_topk")
    return out_v, out_i


def _one_call_out(n: int, k: int, device, q: int = 1):
    """One int32 allocation for a fused function's n cells and k outputs
    per query: (cells' value and index pointers, outputs' value and index
    tensors, [k] for one query and [q, k] for a batch). The outputs'
    values are int32 views, to be viewed as the function's value type."""
    cells, out_v, out_i = torch.empty(2 * q * (n + k), dtype=torch.int32,
                                      device=device).split((2 * q * n, q * k, q * k))
    ptr = cells.data_ptr()
    if q > 1:
        out_v, out_i = out_v.view(q, k), out_i.view(q, k)
    return (ptr, ptr + 4 * q * n), out_v, out_i


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 bit patterns held in int32, computed in int64
    (the final multiply overflows int32)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _hamming_cells_plain(queries: torch.Tensor, db: torch.Tensor,
                         valid: torch.Tensor):
    """Per query block of QSEL: XOR-popcount over the words, invalid rows
    2^30, then min per cell and the smallest row among the hits."""
    q, w = queries.shape
    c = db.shape[0]
    tiles = c // (HAMMING_ROWS_PER_TILE * LANES)
    dev = db.device
    rows = torch.arange(HAMMING_ROWS_PER_TILE, device=dev).view(1, 1, -1, 1)
    t_ix = torch.arange(tiles, device=dev).view(1, -1, 1)
    lanes = torch.arange(LANES, device=dev).view(1, 1, -1)
    vals, idxs = [], []
    for q0 in range(0, q, QSEL):
        qb = queries[q0:q0 + QSEL]
        d = torch.zeros((qb.shape[0], c), dtype=torch.int64, device=dev)
        for wi in range(w):
            d += _popcount32(torch.bitwise_xor(qb[:, wi, None], db[None, :, wi]))
        d = torch.where(valid[None, :], d, _INVALID_DIST)
        d4 = d.view(qb.shape[0], tiles, HAMMING_ROWS_PER_TILE, LANES)
        best = d4.amin(dim=2)
        first = torch.where(d4 == best[:, :, None, :], rows,
                            HAMMING_ROWS_PER_TILE).amin(dim=2)
        vals.append(best.to(torch.int32).reshape(qb.shape[0], -1))
        gidx = (t_ix * HAMMING_ROWS_PER_TILE + first) * LANES + lanes
        idxs.append(gidx.to(torch.int32).reshape(qb.shape[0], -1))
    return torch.cat(vals), torch.cat(idxs)


def _hamming_cells_mma_plain(queries: torch.Tensor, db: torch.Tensor,
                             valid: torch.Tensor):
    """The tensor-core cells kernel's formulation in plain PyTorch, for the
    tests (the card never runs it): query bits as +1 / -1 and row bits as
    0 / 1, one exact integer product per (query, row), so dot = popc(q &
    b) - popc(~q & b); the kernel's row bytes are 128 * bit, so its sums
    are 128 * dot plus the accumulator input 127 - r, less 2^22 for an
    invalid row; each cell keeps its largest sum (the largest dot, then the
    lowest r), and its distance is popc(q) - dot, or (2^30, r = 0) when its
    best dot lies below -2^14 (no valid row)."""
    q, w = queries.shape
    c = db.shape[0]
    tiles = c // (HAMMING_ROWS_PER_TILE * LANES)
    dev = db.device
    shifts = torch.arange(32, device=dev)
    qbits = (queries[:, :, None] >> shifts) & 1  # [Q, W, 32], int32
    rbits = (db[:, :, None] >> shifts) & 1  # [C, W, 32]
    a = (2 * qbits - 1).reshape(q, 32 * w)
    # 128 * dot; a float64 product of these small integers (|sum| <= 2^16)
    # is exact, and BLAS runs it where an integer product has no fast path
    dot = (a.double() @ (128 * rbits).reshape(c, 32 * w).T.double()).to(torch.int64)
    r = torch.arange(HAMMING_ROWS_PER_TILE, device=dev).view(1, 1, -1, 1)
    acc = dot.view(q, tiles, HAMMING_ROWS_PER_TILE, LANES) + (HAMMING_ROWS_PER_TILE - 1 - r)
    acc = torch.where(valid.view(1, tiles, HAMMING_ROWS_PER_TILE, LANES), acc,
                      acc - (1 << 22))
    best = acc.amax(dim=2)  # [Q, T, 128]
    best_dot = best >> 7
    invalid = best_dot < -(1 << 14)
    pq = _popcount32(queries).sum(dim=1).view(q, 1, 1)
    dist = torch.where(invalid, _INVALID_DIST, pq - best_dot)
    first = torch.where(invalid, 0, HAMMING_ROWS_PER_TILE - 1 - (best & 127))
    t_ix = torch.arange(tiles, device=dev).view(1, -1, 1)
    lanes = torch.arange(LANES, device=dev).view(1, 1, -1)
    gidx = (t_ix * HAMMING_ROWS_PER_TILE + first) * LANES + lanes
    return dist.to(torch.int32).reshape(q, -1), gidx.to(torch.int32).reshape(q, -1)


def _check_hamming_card(queries: torch.Tensor, db: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """The card's #2 kernels' layout checks; returns valid 16-byte aligned
    (the tensor-core kernel copies it in 16-byte pieces)."""
    for name, t in (("queries", queries), ("db", db), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != db.device:
            raise ValueError(f"{name} must be on {db.device}")
    if db.data_ptr() % 16:
        raise ValueError("db must be 16-byte aligned (vector row loads)")
    return _aligned16(valid)


def _hamming_cells_cuda(queries: torch.Tensor, db: torch.Tensor,
                        valid: torch.Tensor, path: int = -1):
    """#2's cells kernel alone. path: -1 picks by Q (hamming_paths_info), 0
    the streaming kernel (Q <= its stream_max_q), 1 the tensor cores."""
    q, w = queries.shape
    c = db.shape[0]
    valid = _check_hamming_card(queries, db, valid)
    tiles = c // (HAMMING_ROWS_PER_TILE * LANES)
    dist, gidx = _pair_out(q, tiles * LANES, torch.int32, db.device)
    rc = _kernels().ucfp_hamming_cells(
        queries.data_ptr(), q, w, db.data_ptr(), valid.data_ptr(), c,
        dist.data_ptr(), gidx.data_ptr(), int(path), _stream_ptr(db),
    )
    _check(rc, "hamming_topk_fused_batched")
    _count("hamming_topk_fused_batched")
    return dist, gidx


def _hamming_batched_topk_cuda(queries: torch.Tensor, db: torch.Tensor,
                               valid: torch.Tensor, k: int, path: int = -1):
    """#2 whole: the cells kernel of the path (as _hamming_cells_cuda's)
    and the selection kernel over its cells from one host call
    (ucfp_hamming_batched_topk) into one allocation -> ([Q, k] int32
    distances, [Q, k] int32 indices)."""
    q, w = queries.shape
    c = db.shape[0]
    dev = db.device
    valid = _check_hamming_card(queries, db, valid)
    n = c // HAMMING_ROWS_PER_TILE  # (tile, lane) cells per query
    scratch = _select_scratch(q, n, k, dev)
    if k == 0:
        return (torch.empty((q, 0), dtype=torch.int32, device=dev),) * 2
    cells, out_d, out_i = _one_call_out(n, k, dev, q)
    rc = _kernels().ucfp_hamming_batched_topk(
        queries.data_ptr(), q, w, db.data_ptr(), valid.data_ptr(), c, k, int(path), *cells,
        out_d.data_ptr(), out_i.data_ptr(), None if scratch is None else scratch.data_ptr(),
        _stream_ptr(db),
    )
    _check(rc, "hamming_topk_fused_batched")
    _count("hamming_topk_fused_batched", "select_topk")
    return out_d.view(q, k), out_i.view(q, k)


def hamming_paths_info(w: int = 2) -> dict:
    """#2's path rule (csrc/fused_scan.cu) at w words a row: the
    tensor-core kernel from `mma_min_q` queries, the streaming kernel
    below it (it takes at most `stream_max_q`); a block of the tensor-core
    kernel serves `mma_block_q` queries, so it reads the catalog once per
    that many."""
    info = (ctypes.c_int * 3)()
    _check(_kernels().ucfp_hamming_paths_info(w, info), "hamming_paths_info")
    return dict(zip(("mma_min_q", "stream_max_q", "mma_block_q"), info))


def _hamming1_cells_plain(query: torch.Tensor, db: torch.Tensor):
    """_hamming_kernel literally: XOR-popcount over the words (no mask),
    then the scores cells' rule on the distances: min per (256-row tile,
    lane) cell and the smallest row among the hits."""
    d = torch.zeros(db.shape[0], dtype=torch.int64, device=db.device)
    for wi in range(db.shape[1]):
        d += _popcount32(torch.bitwise_xor(query[wi], db[:, wi]))
    # distances <= 512 compare exactly as float32 inside the cells rule
    return _scores_cells_plain(d.to(torch.int32)[None], largest=False)


def _check_hamming1_card(query: torch.Tensor, db: torch.Tensor) -> None:
    if not (query.is_contiguous() and db.is_contiguous()):
        raise ValueError("query and db must be contiguous")
    if query.device != db.device:
        raise ValueError(f"query must be on {db.device}")
    if db.data_ptr() % 16:
        raise ValueError("db must be 16-byte aligned (vector row loads)")


def _hamming1_cells_cuda(query: torch.Tensor, db: torch.Tensor):
    c, w = db.shape
    _check_hamming1_card(query, db)
    tiles = c // (ROWS_PER_TILE * LANES)
    dist = torch.empty((1, tiles * LANES), dtype=torch.int32, device=db.device)
    gidx = torch.empty((1, tiles * LANES), dtype=torch.int32, device=db.device)
    rc = _kernels().ucfp_hamming_topk_cells(
        query.data_ptr(), w, db.data_ptr(), c, dist.data_ptr(), gidx.data_ptr(),
        _stream_ptr(db),
    )
    _check(rc, "hamming_topk_fused")
    _count("hamming_topk_fused")
    return dist, gidx


def _hamming_topk_cuda(query: torch.Tensor, db: torch.Tensor, k: int):
    """#6 whole: the cells kernel and the selection kernel over its cells
    from one host call (ucfp_hamming_topk) into one allocation -> ([k]
    int32 distances, [k] int32 indices). At one query the scan is
    host-bound, so the host work is kept to one call."""
    c, w = db.shape
    dev = db.device
    _check_hamming1_card(query, db)
    n = c // ROWS_PER_TILE  # (tile, lane) cells
    scratch = _select_scratch(1, n, k, dev)
    if k == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),) * 2
    cells, out_d, out_i = _one_call_out(n, k, dev)
    rc = _kernels().ucfp_hamming_topk(
        query.data_ptr(), w, db.data_ptr(), c, k, *cells, out_d.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(), _stream_ptr(db),
    )
    _check(rc, "hamming_topk_fused")
    _count("hamming_topk_fused", "select_topk")
    return out_d, out_i


def _dots_norm_cells_plain(dots: torch.Tensor, row_norm: torch.Tensor,
                           n_valid: int, inv_q: torch.Tensor):
    """_dots_norm_kernel_batched literally: dots / max(|row|, 1e-9) *
    1/|q| where row < n and |row| > 0, else -inf; then _qblock_argbest
    (max per cell, the smallest row among the hits)."""
    q, c = dots.shape
    dev = dots.device
    ok = (torch.arange(c, device=dev) < n_valid) & (row_norm > 0.0)
    rn = torch.clamp(row_norm, min=1e-9)
    scores = torch.where(ok[None, :], dots.float() / rn[None, :] * inv_q[:, None],
                         NEG_INF)
    return _scores_cells_plain(scores, True)


def dots_norm_cells_sliced(dots: torch.Tensor, row_norm: torch.Tensor,
                           n_valid: int, inv_q: torch.Tensor):
    """The card's dots-norm cells kernel in its own order, in plain PyTorch:
    each of DN_SLICES interleaved row slices of a tile (rows s, s + 8, ...)
    keeps the first row of its best score (a strict '>' from -inf, rows
    ascending, so an all -inf slice keeps its first row); the slices'
    winners merge by the best score and, among equal scores (+-0.0
    included), the lowest row, with that row's own score. The CPU tests
    hold it equal to _dots_norm_cells_plain and the reference."""
    q, c = dots.shape
    dev = dots.device
    ok = (torch.arange(c, device=dev) < n_valid) & (row_norm > 0.0)
    rn = torch.clamp(row_norm, min=1e-9)
    s = torch.where(ok[None, :], dots.float() / rn[None, :] * inv_q[:, None], NEG_INF)
    tiles = c // (ROWS_PER_TILE * LANES)
    steps = ROWS_PER_TILE // DN_SLICES
    s5 = s.view(q, tiles, steps, DN_SLICES, LANES)  # row = step * DN_SLICES + slice
    step = torch.arange(steps, device=dev).view(1, 1, -1, 1, 1)
    first = torch.where(s5 == s5.amax(dim=2, keepdim=True), step, steps).amin(dim=2)
    val = torch.gather(s5, 2, first[:, :, None]).squeeze(2)  # [Q, T, slice, lane]
    row = first * DN_SLICES + torch.arange(DN_SLICES, device=dev).view(1, 1, -1, 1)
    best = torch.where(val == val.amax(dim=2, keepdim=True), row, ROWS_PER_TILE).amin(dim=2)
    v = torch.gather(s.view(q, tiles, ROWS_PER_TILE, LANES), 2, best[:, :, None]).squeeze(2)
    t_ix = torch.arange(tiles, device=dev).view(1, -1, 1)
    gidx = (t_ix * ROWS_PER_TILE + best) * LANES + torch.arange(LANES, device=dev)
    return v.reshape(q, -1), gidx.to(torch.int32).reshape(q, -1)


def _dots_norm_cells_cuda(dots: torch.Tensor, row_norm: torch.Tensor,
                          n_valid: int, inv_q: torch.Tensor, name: str):
    q, c = dots.shape
    for arg, t in (("dots", dots), ("row_norm", row_norm), ("inv_qnorm", inv_q)):
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if t.device != dots.device:
            raise ValueError(f"{arg} must be on {dots.device}")
    dots, row_norm = _aligned16(dots), _aligned16(row_norm)  # 16-byte copies
    tiles = c // (ROWS_PER_TILE * LANES)
    best = torch.empty((q, tiles * LANES), dtype=torch.float32, device=dots.device)
    gidx = torch.empty((q, tiles * LANES), dtype=torch.int32, device=dots.device)
    rc = _kernels().ucfp_dots_norm_cells(
        dots.data_ptr(), q, c, row_norm.data_ptr(), int(n_valid),
        inv_q.data_ptr(), best.data_ptr(), gidx.data_ptr(), _stream_ptr(dots),
    )
    _check(rc, name)
    _count(name)
    return best, gidx


def dots_norm_blocks_per_sm(q: int) -> int:
    """Blocks per SM of the card's dots-norm cells kernel (#4 / #5) for q
    queries, by cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    per_sm = ctypes.c_int(0)
    _check(_kernels().ucfp_dots_norm_blocks_per_sm(q, ctypes.byref(per_sm)),
           "dots_norm_blocks_per_sm")
    return per_sm.value


def _row_dots(q8: torch.Tensor, db8: torch.Tensor) -> torch.Tensor:
    """[D] int8 x [C, D] int8 -> [C] int32 exact dots, by the int8 product
    the served paths use (ops.knn.int8_dots: torch._int_mm on the card)."""
    from .knn import int8_dots  # ops.knn imports this module

    return int8_dots(q8[None], db8)[0]


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _cosine_i8_cells_plain(q8: torch.Tensor, db8: torch.Tensor,
                           row_norm: torch.Tensor):
    """_cosine_i8_kernel literally: each row's exact dot, as float32, over
    max(|row|, 1e-9), then the per-(tile, lane) argbest over 128-row
    tiles (the largest score, the smallest row among the hits)."""
    scores = _row_dots(q8, db8).float() / torch.clamp(row_norm, min=1e-9)
    return _scores_cells_plain(scores[None], True, ROWS_PER_TILE_C)


def _cosine_i8_cells_cuda(q8: torch.Tensor, db8: torch.Tensor,
                          row_norm: torch.Tensor):
    name = "cosine_int8_topk_fused"
    c, d = db8.shape
    tiles = c // (ROWS_PER_TILE_C * LANES)
    best = torch.empty((1, tiles * LANES), dtype=torch.float32, device=db8.device)
    gidx = torch.empty((1, tiles * LANES), dtype=torch.int32, device=db8.device)
    q = _aligned16(q8)
    rc = _kernels().ucfp_cosine_i8_cells(
        q.data_ptr(), d, db8.data_ptr(), c, row_norm.data_ptr(), best.data_ptr(),
        gidx.data_ptr(), _stream_ptr(db8),
    )
    _check(rc, name)
    _count(name)
    return best, gidx


def _cosine_i8_topk_cuda(q8: torch.Tensor, db8: torch.Tensor,
                         row_norm: torch.Tensor, k: int):
    """#7 whole: the cells kernel and the selection kernel over its cells
    from one host call (ucfp_cosine_i8_topk) into one allocation -> ([k]
    f32, [k] int32)."""
    name = "cosine_int8_topk_fused"
    c, d = db8.shape
    dev = db8.device
    n = c // ROWS_PER_TILE_C  # (tile, lane) cells
    scratch = _select_scratch(1, n, k, dev)
    if k == 0:
        return (torch.empty(0, dtype=torch.float32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    cells, out_v, out_i = _one_call_out(n, k, dev)
    q = _aligned16(q8)
    rc = _kernels().ucfp_cosine_i8_topk(
        q.data_ptr(), d, db8.data_ptr(), c, row_norm.data_ptr(), k, *cells,
        out_v.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(), _stream_ptr(db8),
    )
    _check(rc, name)
    _count(name, "select_topk")
    return out_v.view(torch.float32), out_i


def _pick_rpt(packed_rows: int) -> int:
    """Largest sublane-aligned tile height dividing the packed row count.
    Copied from ucfp_tpu/ops/pallas_scan.py."""
    for rpt in (1024, 800, 512, 320, 256, 160, 128, 96, 64, 32):
        if packed_rows % rpt == 0:
            return rpt
    raise ValueError(
        f"packed row count {packed_rows} has no 32-multiple tile divisor "
        f"<= 1024; pad the candidate set"
    )


def _mxu_layout(c: int, d: int) -> tuple[int, int, int]:
    """(rows per 128-byte line, lines, lines per tile), with the
    reference's errors in its order."""
    if LANES % d:
        raise ValueError(f"cosine_int8_topk_mxu requires 128 % D == 0, got D={d}")
    per = LANES // d
    if c % per:
        raise ValueError(f"C={c} must be a multiple of {per} for D={d}")
    lines = c // per
    return per, lines, _pick_rpt(lines)


def _cosine_i8_mxu_cells_plain(q8: torch.Tensor, db8: torch.Tensor):
    """_cosine_i8_mxu_kernel literally: per (tile, segment, slot) cell the
    largest raw dot and the first line among the hits -> ([cells] f32
    dots, [cells] int32 rows) in [tiles, SUB, per] order."""
    c, d = db8.shape
    per, lines, rpt = _mxu_layout(c, d)
    tiles, seg = lines // rpt, rpt // SUB
    dev = db8.device
    d4 = _row_dots(q8, db8).view(tiles, SUB, seg, per)
    best = d4.amax(dim=2)  # [T, SUB, per]
    rows = torch.arange(seg, device=dev).view(1, 1, -1, 1)
    first = torch.where(d4 == best[:, :, None, :], rows, seg).amin(dim=2)
    base = torch.arange(tiles, device=dev).view(-1, 1, 1) * rpt
    segs = torch.arange(SUB, device=dev).view(1, -1, 1) * seg
    slots = torch.arange(per, device=dev).view(1, 1, -1)
    gidx = per * (base + segs + first) + slots
    return best.float().reshape(-1), gidx.to(torch.int32).reshape(-1)


def _cosine_i8_mxu_cells_cuda(q8: torch.Tensor, db8: torch.Tensor):
    name = "cosine_int8_topk_mxu"
    c, d = db8.shape
    per, lines, rpt = _mxu_layout(c, d)
    n = lines // rpt * SUB * per
    best = torch.empty(n, dtype=torch.float32, device=db8.device)
    gidx = torch.empty(n, dtype=torch.int32, device=db8.device)
    q = _aligned16(q8)
    rc = _kernels().ucfp_cosine_i8_mxu_cells(
        q.data_ptr(), d, db8.data_ptr(), lines, rpt, best.data_ptr(), gidx.data_ptr(),
        _stream_ptr(db8),
    )
    _check(rc, name)
    _count(name)
    return best, gidx


# ---------------------------------------------------------------------------
# final selection (lax.top_k over the flat candidates, outside the kernels)
# ---------------------------------------------------------------------------


def _select_plain(vals: torch.Tensor, gidx: torch.Tensor, k: int, largest: bool):
    """First k of a stable sort: ties keep the lower candidate position,
    as lax.top_k does (torch.topk promises no order for ties)."""
    if k > vals.shape[1]:
        raise ValueError(f"k={k} exceeds the {vals.shape[1]} candidates")
    key = vals.float() if vals.dtype == torch.bfloat16 else vals
    order = torch.sort(key, dim=1, descending=largest, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(gidx, 1, order)


# value kinds of ucfp_select_topk
_SELECT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


@functools.lru_cache(maxsize=256)
def _scratch_keys(q: int, k: int) -> int:
    return _kernels().ucfp_select_scratch(q, k)


def _select_scratch(q: int, n: int, k: int, device):
    """For the selection kernel's top k of n candidates of q queries: the
    check of k, and the device-memory scratch csrc/select.cu asks for
    (None while k fits its shared-memory sort)."""
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} candidates")
    keys = _scratch_keys(q, k)
    return torch.empty(keys, dtype=torch.int64, device=device) if keys else None


def _select_cuda(vals: torch.Tensor, gidx: torch.Tensor, k: int, largest: bool,
                 cluster: int = -1):
    """The selection kernel over [Q, N] candidates. cluster: -1 lets
    csrc/select.cu pick its path from (Q, N); 0 asks for one block per
    query, 8 for a thread-block cluster of 8 CTAs per query (another size,
    or a cluster the card cannot schedule, raises)."""
    q, n = vals.shape
    if vals.dtype not in _SELECT_KINDS or gidx.dtype != torch.int32:
        raise ValueError(f"select_topk takes float32, bfloat16 or int32 values and "
                         f"int32 indices, got {vals.dtype} and {gidx.dtype}")
    if gidx.shape != vals.shape or gidx.device != vals.device:
        raise ValueError("values and indices must share shape and device")
    vals, gidx = vals.contiguous(), gidx.contiguous()
    scratch = _select_scratch(q, n, k, vals.device)
    out_v, out_i = _pair_out(q, k, vals.dtype, vals.device)
    if q == 0 or k == 0:
        return out_v, out_i
    rc = _kernels().ucfp_select_topk_path(
        vals.data_ptr(), gidx.data_ptr(), _SELECT_KINDS[vals.dtype], q, n, k,
        int(largest), out_v.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(), int(cluster), _stream_ptr(vals),
    )
    _check(rc, "select_topk")
    _count("select_topk")
    return out_v, out_i


def select_cluster_info() -> dict:
    """The selection kernel's path rule (csrc/select.cu) and what the
    runtime reports for the current card: a cluster of `cluster` CTAs per
    query where q * cluster <= sms and N >= min_n, else one block per
    query; `resident` clusters fit the card at once at the largest
    shared-memory size."""
    info = (ctypes.c_int * 4)()
    _check(_kernels().ucfp_select_cluster_info(info), "select_cluster_info")
    return dict(zip(("cluster", "min_n", "sms", "resident"), info))


def _order_words(vals: torch.Tensor, largest: bool) -> torch.Tensor:
    """csrc/select.cu's order words as int64 in [0, 2^32): the value order
    kept (largest first, or complemented for smallest first), -0.0 made
    +0.0."""
    if vals.dtype == torch.int32:
        u = vals.to(torch.int64) + (1 << 31)
    else:
        b = vals.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = torch.where(b == 0x80000000, 0, b)
        u = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    return u if largest else 0xFFFFFFFF - u


def _select_cluster_plain(vals: torch.Tensor, gidx: torch.Tensor, k: int,
                          largest: bool, ranks: int):
    """The cluster path of csrc/select.cu in plain PyTorch, for the tests
    (the card never runs it): rank r of `ranks` owns positions [r * span,
    (r + 1) * span), span = ceil(N / ranks); each radix pass sums the
    ranks' own 256-bin histograms and picks the bin of the k-th key (early
    stop when it is taken whole); each rank counts its keys above the
    threshold (its bins above every pass's pick) and equal to it (its count
    in the last pick); an exclusive prefix of those counts over the lower
    ranks gives every winner its slot in position order; the slots' keys,
    (order word, N - 1 - position), in descending order as _cluster_sorted
    places them, give the answer."""
    q, n = vals.shape
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} candidates")
    span = -(-n // ranks)
    bounds = [(min(n, r * span), min(n, (r + 1) * span)) for r in range(ranks)]
    words = _order_words(vals, largest)
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    out_v, out_i = [], []
    for row in range(q):
        w = words[row]
        prefix, mask, need = 0, 0, k
        above = [0] * ranks  # each rank's keys above the threshold
        equal = [0] * ranks  # ... and equal to it (the last pass's pick)
        for shift in (24, 16, 8, 0):
            digit = (w >> shift) & 0xFF
            hists = [torch.bincount(digit[lo:hi][(w[lo:hi] & mask) == prefix], minlength=256)
                     for lo, hi in bounds]
            hist = torch.stack(hists).sum(0)
            incl = torch.cumsum(hist.flip(0), 0)  # keys in this bin and the bins above
            top = int(torch.nonzero(incl >= need)[0])  # bins from the top
            d = 255 - top
            before = int(incl[top] - hist[d])
            for r, h in enumerate(hists):
                above[r] += int(h[d + 1:].sum())
                equal[r] = int(h[d])
            prefix |= d << shift
            mask |= 0xFF << shift
            need -= before
            if need == int(hist[d]):
                break
        m = w & mask
        slot = torch.full((n,), -1, dtype=torch.int64, device=vals.device)
        gt_before = eq_before = 0  # the exclusive prefix over the ranks
        for r, (lo, hi) in enumerate(bounds):
            gt, eq = m[lo:hi] > prefix, m[lo:hi] == prefix
            gb = gt_before + torch.cumsum(gt, 0) - gt.long()  # above, at lower positions
            eb = eq_before + torch.cumsum(eq, 0) - eq.long()
            s = torch.where(gt, gb + torch.clamp(eb, max=need),
                            torch.where(eq & (eb < need), gb + eb, -1))
            slot[lo:hi] = s
            gt_before += above[r]
            eq_before += equal[r]
        won = slot >= 0
        keys = torch.zeros(k, dtype=torch.int64, device=vals.device)
        keys[slot[won]] = ((w[won] - (1 << 31)) << 32) | (n - 1 - pos[won])
        order = n - 1 - (_cluster_sorted(keys, ranks) & 0xFFFFFFFF)
        out_v.append(vals[row, order])
        out_i.append(gidx[row, order])
    return torch.stack(out_v), torch.stack(out_i)


_SORT_CAP = 16384  # csrc/select.cu's shared-memory sort, in keys
_SPLIT_MIN_K = 513  # csrc/select.cu: from this k the cluster shares the sort


def _cluster_sorted(keys: torch.Tensor, ranks: int) -> torch.Tensor:
    """The k winners' keys (signed int64, unique) in descending order, as
    the cluster path orders them: below SPLIT_MIN_K, or above the
    shared-memory sort, one sort; else p slots (the sort's power of two)
    cut into `ranks` slices of p / ranks, each padded with keys below
    every real one and sorted, and each key placed at its index in its
    slice plus the keys above it in every other slice."""
    k = keys.shape[0]
    if k < _SPLIT_MIN_K or k > _SORT_CAP:
        return torch.sort(keys, descending=True).values
    p = 1 << (k - 1).bit_length()
    c = p // ranks
    padded = torch.full((p,), -(1 << 63), dtype=torch.int64, device=keys.device)
    padded[:k] = keys
    slices = torch.sort(padded.view(ranks, c), dim=1, descending=True).values
    ascending = slices.flip(1).contiguous()
    out = torch.empty(k, dtype=torch.int64, device=keys.device)
    for r in range(ranks):
        real = slices[r, :max(0, min(c, k - r * c))]
        place = torch.arange(real.shape[0], device=keys.device)
        for other in range(ranks):
            if other != r:  # keys above: c minus those at or below
                place += c - torch.searchsorted(ascending[other], real, right=True)
        out[place] = real
    return out


def _select(vals: torch.Tensor, gidx: torch.Tensor, k: int, largest: bool):
    """_select_plain's answer: the stable sort on the CPU, the selection
    kernel (csrc/select.cu) for CUDA tensors."""
    if vals.device.type == "cpu":
        return _select_plain(vals, gidx, k, largest)
    return _select_cuda(vals, gidx, k, largest)


def _check_tiles(name: str, c: int) -> None:
    """The reference's ValueError for a catalog that is not whole tiles."""
    if c % (ROWS_PER_TILE * LANES):
        raise ValueError(
            f"{name} requires C % {ROWS_PER_TILE * LANES} == 0, got {c}"
        )


def _check_scores(scores: torch.Tensor, largest: bool, approx: bool) -> None:
    if approx and not largest:
        raise ValueError("approx selection supports largest=True only")
    if scores.dim() != 2:
        raise ValueError(f"scores must be [Q, C], got {tuple(scores.shape)}")
    if scores.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scores must be float32 or bfloat16, got {scores.dtype}")
    _check_tiles("scores_topk_fused_batched", scores.shape[1])


def scores_topk_fused_batched(scores: torch.Tensor, k: int,
                              largest: bool = True, approx: bool = False):
    """scores [Q, C] f32 or bf16, C % 32768 == 0 -> ([Q, k] values in the
    input dtype, [Q, k] int32 catalog indices), best first.

    approx=True selects exactly: the reference's approx_max_k returns the
    exact top-k on the CPU, and the port keeps that answer everywhere."""
    _check_scores(scores, largest, approx)
    if scores.device.type != "cpu":
        return _scores_topk_cuda(scores, k, largest, "scores_topk_fused_batched")
    return _select_plain(*_scores_cells_plain(scores, largest), k, largest)


def scores_topk_fused_batched_plain(scores: torch.Tensor, k: int,
                                    largest: bool = True, approx: bool = False):
    """Plain PyTorch version of scores_topk_fused_batched on any device."""
    _check_scores(scores, largest, approx)
    vals, gidx = _scores_cells_plain(scores, largest)
    return _select_plain(vals, gidx, k, largest)


def _check_hamming(queries: torch.Tensor, db: torch.Tensor,
                   valid: torch.Tensor) -> None:
    if queries.dim() != 2 or db.dim() != 2 or queries.shape[1] != db.shape[1]:
        raise ValueError(
            f"queries [Q, W] and db [C, W] must share W, got "
            f"{tuple(queries.shape)} and {tuple(db.shape)}"
        )
    if queries.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError("queries and db hold u32 bit patterns as int32")
    if valid.dtype != torch.bool or valid.shape != (db.shape[0],):
        raise ValueError("valid must be a [C] bool tensor")
    w = db.shape[1]
    if w > MAX_FUSED_HAMMING_WORDS:
        raise ValueError(
            f"fused Hamming scan takes at most {MAX_FUSED_HAMMING_WORDS} "
            f"words, got {w} (wider fingerprints take the exact path)"
        )
    _check_tiles("hamming_topk_fused_batched", db.shape[0])


def hamming_topk_fused_batched(queries: torch.Tensor, db: torch.Tensor,
                               valid: torch.Tensor, k: int):
    """queries [Q, W] int32 (u32 bits), db [C, W] int32, valid [C] bool,
    C % 32768 == 0, W <= 16 -> ([Q, k] int32 distances, [Q, k] int32
    catalog indices), smallest first; invalid rows score 2^30."""
    _check_hamming(queries, db, valid)
    if db.device.type != "cpu":
        return _hamming_batched_topk_cuda(queries, db, valid, k)
    return _select_plain(*_hamming_cells_plain(queries, db, valid), k, largest=False)


def hamming_topk_fused_batched_plain(queries: torch.Tensor, db: torch.Tensor,
                                     valid: torch.Tensor, k: int):
    """Plain PyTorch version of hamming_topk_fused_batched on any device."""
    _check_hamming(queries, db, valid)
    dist, gidx = _hamming_cells_plain(queries, db, valid)
    return _select_plain(dist, gidx, k, largest=False)


def _check_hamming1(query: torch.Tensor, db: torch.Tensor) -> None:
    if query.dim() != 1 or db.dim() != 2 or query.shape[0] != db.shape[1]:
        raise ValueError(
            f"query [W] and db [C, W] must share W, got {tuple(query.shape)} "
            f"and {tuple(db.shape)}"
        )
    if query.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError("query and db hold u32 bit patterns as int32")
    if db.shape[1] > MAX_FUSED_HAMMING_WORDS:
        raise ValueError(
            f"fused Hamming scan takes at most {MAX_FUSED_HAMMING_WORDS} "
            f"words, got {db.shape[1]}"
        )
    _check_tiles("hamming_topk_fused", db.shape[0])


def hamming_topk_fused(query: torch.Tensor, db: torch.Tensor, k: int):
    """query [W] int32 (u32 bits), db [C, W] int32, C % 32768 == 0, W <= 16
    -> ([k] int32 distances, [k] int32 catalog indices), smallest first.
    No validity mask: every row is a candidate (callers keep db dense)."""
    _check_hamming1(query, db)
    if db.device.type != "cpu":
        return _hamming_topk_cuda(query, db, k)
    d, i = _select_plain(*_hamming1_cells_plain(query, db), k, largest=False)
    return d[0], i[0]


def hamming_topk_fused_plain(query: torch.Tensor, db: torch.Tensor, k: int):
    """Plain PyTorch version of hamming_topk_fused on any device."""
    _check_hamming1(query, db)
    d, i = _select_plain(*_hamming1_cells_plain(query, db), k, largest=False)
    return d[0], i[0]


def _check_scores_1d(scores: torch.Tensor) -> None:
    if scores.dim() != 1 or scores.dtype != torch.float32:
        raise ValueError(
            f"scores must be a [C] float32 vector, got {scores.dtype} "
            f"{tuple(scores.shape)}"
        )
    _check_tiles("scores_topk_fused", scores.shape[0])


def scores_topk_fused(scores: torch.Tensor, k: int, largest: bool = True):
    """scores [C] f32, C % 32768 == 0 -> ([k] f32 values, [k] int32
    catalog indices), best first (smallest first for largest=False)."""
    _check_scores_1d(scores)
    if scores.device.type != "cpu":
        return _scores_topk_cuda(scores, k, largest, "scores_topk_fused")
    v, i = _select_plain(*_scores_cells_plain(scores[None, :], largest), k, largest)
    return v[0], i[0]


def scores_topk_fused_plain(scores: torch.Tensor, k: int, largest: bool = True):
    """Plain PyTorch version of scores_topk_fused on any device."""
    _check_scores_1d(scores)
    v, i = _select_plain(*_scores_cells_plain(scores[None, :], largest), k, largest)
    return v[0], i[0]


def _check_dots_norm(name: str, dots: torch.Tensor, row_norm: torch.Tensor,
                     inv_q: torch.Tensor) -> None:
    if dots.dim() != 2 or dots.dtype != torch.int32:
        raise ValueError(f"{name}: dots must be int32, got {dots.dtype} "
                         f"{tuple(dots.shape)}")
    q, c = dots.shape
    if row_norm.dtype != torch.float32 or row_norm.shape != (c,):
        raise ValueError(f"{name}: row_norm must be a [C={c}] float32 vector")
    if inv_q.dtype != torch.float32 or inv_q.shape != (q,):
        raise ValueError(f"{name}: inv_qnorm must be float32, one per query")
    _check_tiles(name, c)


def _dots_norm_topk(name: str, dots, row_norm, n_valid, inv_q, k: int,
                    plain: bool):
    _check_dots_norm(name, dots, row_norm, inv_q)
    if plain:
        vals, gidx = _dots_norm_cells_plain(dots, row_norm, int(n_valid), inv_q)
        return _select_plain(vals, gidx, k, largest=True)
    if dots.device.type == "cpu":
        vals, gidx = _dots_norm_cells_plain(dots, row_norm, int(n_valid), inv_q)
    else:
        vals, gidx = _dots_norm_cells_cuda(dots, row_norm, int(n_valid), inv_q, name)
    return _select(vals, gidx, k, largest=True)


def _dots_norm_single(dots, row_norm, n_valid, inv_qnorm, k: int, plain: bool):
    if dots.dim() != 1:
        raise ValueError(f"dots must be a [C] vector, got {tuple(dots.shape)}")
    inv_q = torch.as_tensor(inv_qnorm, dtype=torch.float32,
                            device=dots.device).reshape(1)
    v, i = _dots_norm_topk("dots_norm_topk_fused", dots[None, :], row_norm,
                           n_valid, inv_q, k, plain)
    return v[0], i[0]


def dots_norm_topk_fused(dots: torch.Tensor, row_norm: torch.Tensor,
                         n_valid: int, inv_qnorm, k: int):
    """Single-query cosine top-k off the int8 product: dots [C] int32,
    row_norm [C] f32, rows >= n_valid score -inf, inv_qnorm the float32
    1/|q| -> ([k] f32, [k] int32), best first. Zero-norm rows score
    -inf."""
    return _dots_norm_single(dots, row_norm, n_valid, inv_qnorm, k, plain=False)


def dots_norm_topk_fused_plain(dots: torch.Tensor, row_norm: torch.Tensor,
                               n_valid: int, inv_qnorm, k: int):
    """Plain PyTorch version of dots_norm_topk_fused on any device."""
    return _dots_norm_single(dots, row_norm, n_valid, inv_qnorm, k, plain=True)


def dots_norm_topk_fused_batched(dots: torch.Tensor, row_norm: torch.Tensor,
                                 n_valid: int, inv_qnorm: torch.Tensor, k: int):
    """Batched dots_norm_topk_fused: dots [Q, C] int32, inv_qnorm [Q] f32
    -> ([Q, k] f32, [Q, k] int32)."""
    return _dots_norm_topk("dots_norm_topk_fused_batched", dots, row_norm,
                           n_valid, inv_qnorm, k, plain=False)


def dots_norm_topk_fused_batched_plain(dots: torch.Tensor, row_norm: torch.Tensor,
                                       n_valid: int, inv_qnorm: torch.Tensor,
                                       k: int):
    """Plain PyTorch version of dots_norm_topk_fused_batched on any device."""
    return _dots_norm_topk("dots_norm_topk_fused_batched", dots, row_norm,
                           n_valid, inv_qnorm, k, plain=True)


def _check_cosine_i8(name: str, q8: torch.Tensor, db8: torch.Tensor,
                     row_norm: torch.Tensor, kernel_dims: tuple = ()) -> None:
    """Shapes and types; for the card's kernel (kernel_dims given) also its
    row widths, one device, contiguity and 16-byte row alignment."""
    if q8.dim() != 1 or db8.dim() != 2 or q8.shape[0] != db8.shape[1]:
        raise ValueError(f"{name}: q8 [D] and db8 [C, D] must share D, got "
                         f"{tuple(q8.shape)} and {tuple(db8.shape)}")
    if q8.dtype != torch.int8 or db8.dtype != torch.int8:
        raise ValueError(f"{name}: q8 and db8 must be int8")
    if row_norm.dtype != torch.float32 or row_norm.shape != (db8.shape[0],):
        raise ValueError(f"{name}: row_norm must be a [C={db8.shape[0]}] float32 vector")
    if not kernel_dims:
        return
    if db8.shape[1] not in kernel_dims:
        raise ValueError(f"{name}: the kernel takes D in {kernel_dims}, got {db8.shape[1]}")
    for arg, t in (("q8", q8), ("db8", db8), ("row_norm", row_norm)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != db8.device:
            raise ValueError(f"{name}: {arg} must be on {db8.device}")
    if db8.data_ptr() % 16:
        raise ValueError(f"{name}: db8 must be 16-byte aligned (vector row loads)")


def _cosine_i8_fused(q8, db8, row_norm, k: int, plain: bool):
    name = "cosine_int8_topk_fused"
    plain = plain or db8.device.type == "cpu"
    _check_cosine_i8(name, q8, db8, row_norm, () if plain else COSINE_I8_KERNEL_DIMS)
    c = db8.shape[0]
    if c % (ROWS_PER_TILE_C * LANES):
        raise ValueError(f"{name} requires C % {ROWS_PER_TILE_C * LANES} == 0, got {c}")
    if not plain:
        return _cosine_i8_topk_cuda(q8, db8, row_norm, k)
    v, i = _select_plain(*_cosine_i8_cells_plain(q8, db8, row_norm), k, largest=True)
    return v[0], i[0]


def cosine_int8_topk_fused(q8: torch.Tensor, db8: torch.Tensor,
                           row_norm: torch.Tensor, k: int):
    """q8 [D] int8 (the quantized query), db8 [C, D] int8 with C % 16384
    == 0, row_norm [C] f32 -> ([k] f32 dot / max(|row|, 1e-9) -- divide
    by |q8| outside -- and [k] int32 rows), best first: the best row of
    each (128-row tile, lane) cell, then the top k of those."""
    return _cosine_i8_fused(q8, db8, row_norm, k, plain=False)


def cosine_int8_topk_fused_plain(q8: torch.Tensor, db8: torch.Tensor,
                                 row_norm: torch.Tensor, k: int):
    """Plain PyTorch version of cosine_int8_topk_fused on any device."""
    return _cosine_i8_fused(q8, db8, row_norm, k, plain=True)


def _cosine_i8_mxu(q8, db8, row_norm, k: int, plain: bool):
    name = "cosine_int8_topk_mxu"
    plain = plain or db8.device.type == "cpu"
    _check_cosine_i8(name, q8, db8, row_norm, () if plain else MXU_KERNEL_DIMS)
    c, d = db8.shape
    per, lines, rpt = _mxu_layout(c, d)
    pool = lines // rpt * SUB * per
    if k > pool:
        raise ValueError(
            f"k={k} exceeds the candidate pool {pool} (grid {lines // rpt} x "
            f"{SUB} segments x {per} rows/line)"
        )
    if plain:
        dots, gidx = _cosine_i8_mxu_cells_plain(q8, db8)
    else:
        dots, gidx = _cosine_i8_mxu_cells_cuda(q8, db8)
    # only the candidates are normalized (pallas_scan.py:767)
    cand = dots / torch.clamp(row_norm[gidx.long()], min=1e-9)
    v, i = (_select_plain if plain else _select)(cand[None], gidx[None], k, largest=True)
    return v[0], i[0]


def cosine_int8_topk_mxu(q8: torch.Tensor, db8: torch.Tensor,
                         row_norm: torch.Tensor, k: int):
    """q8 [D] int8 with 128 % D == 0, db8 [C, D] int8 read as 128-byte
    lines of 128 // D rows, row_norm [C] f32 -> ([k] f32 dot / max(|row|,
    1e-9) -- divide by |q8| outside -- and [k] int32 rows), best first:
    per (tile, segment, slot) cell the row of the best raw dot, then the
    top k of those candidates by dot / |row|."""
    return _cosine_i8_mxu(q8, db8, row_norm, k, plain=False)


def cosine_int8_topk_mxu_plain(q8: torch.Tensor, db8: torch.Tensor,
                               row_norm: torch.Tensor, k: int):
    """Plain PyTorch version of cosine_int8_topk_mxu on any device."""
    return _cosine_i8_mxu(q8, db8, row_norm, k, plain=True)


def cosine_int8_topk_hybrid(q8: torch.Tensor, db8: torch.Tensor,
                            row_norm: torch.Tensor, k: int):
    """The int8 product (ops.knn.int8_dots) fed to dots_norm_topk_fused:
    q8 [D] int8, db8 [C, D] int8 with C % 32768 == 0, row_norm [C] f32 ->
    ([k] f32 dot / max(|row|, 1e-9), [k] int32 rows), best first;
    zero-norm rows score -inf. No kernel of its own."""
    dots = _row_dots(q8, db8)
    return dots_norm_topk_fused(dots, row_norm, db8.shape[0], 1.0, k)
