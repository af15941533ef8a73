"""The tensor-core formulation of the batched Hamming scan (kernel #2), on
the CPU.

csrc/fused_scan.cu serves a batch of queries from HAMMING_MMA_MIN_Q on with
an exact int8 product (mma.sync.m16n8k32, s8 x u8): each query bit becomes
an s8 +1 (a 1) or -1 (a 0), each row bit a u8 128 * bit, so a sum is 128 *
dot with dot = popc(q & b) - popc(~q & b) and the Hamming distance is
popc(q) - dot. The accumulator's input carries the tie rule and the
validity: 127 - r, less 2^22 for an invalid row, so the largest sum of a
(128-row tile, lane) cell is the largest dot at the lowest r, and a best
dot below -2^14 means the cell held no valid row (2^30, r = 0).
`fused_scan._hamming_cells_mma_plain` is that formulation in plain PyTorch
(the card never runs it). Integer work throughout: held EQUAL, no
tolerance, to `_hamming_cells_plain` cell for cell, and its top-k to
ucfp_tpu.ops.pallas_scan.hamming_topk_fused_batched in interpret mode, on
numpy inputs from a seed: W = 1, 2, 3, 4 and 16 words, Q = 1, 5, 16, 17
and 33 (past one and two m16 tiles), duplicated rows in a cell and across
tiles, an all-invalid tile, tie-heavy catalogs, k = 1, 10 and 16. The
card's kernels are held bit-equal to the plain cells by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_scan
from ucfp_tpu_torch.ops import fused_scan

TILE = fused_scan.ROWS_PER_TILE * fused_scan.LANES  # the fused path's floor, 32,768 rows
HTILE = fused_scan.HAMMING_ROWS_PER_TILE * fused_scan.LANES  # one Hamming tile


def _case(c, q, w, seed, ties=False, dead_tile=True):
    rng = np.random.default_rng(seed)
    if ties:
        # three distinct rows: equal distances in every cell, across lanes
        # and tiles
        base = rng.integers(0, 2**32, size=(3, w), dtype=np.uint32)
        db = base[rng.integers(0, 3, c)]
    else:
        db = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
        db[100:300] = db[7]  # copies inside one cell (rows 7 + 128j) and its tile
        db[c - 500:c - 300] = db[7]  # ...and in the last tile
    valid = rng.random(c) < 0.9
    if dead_tile:
        valid[HTILE:2 * HTILE] = False  # every cell of tile 1 holds no valid row
    qs = db[rng.integers(0, c, q)].copy()
    qs[0] ^= np.uint32(1)  # one query a bit off a row
    if q > 1:
        qs[-1] = ~qs[-1]  # one query far from every row
    return qs, db, valid


def _rows(w):
    # four Hamming tiles, two at the widest rows (the time is the plain
    # versions' on the CPU)
    return TILE if w >= 4 else 2 * TILE


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _cells(qs, db, valid):
    args = (_t(qs), _t(db), torch.from_numpy(valid))
    return fused_scan._hamming_cells_mma_plain(*args), fused_scan._hamming_cells_plain(*args)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("q", [1, 5, 16, 17, 33])
def test_mma_cells_equal_plain_cells(w, q):
    qs, db, valid = _case(_rows(w), q, w, seed=100 * w + q)
    (d, i), (d_ref, i_ref) = _cells(qs, db, valid)
    assert d.dtype == torch.int32 and i.dtype == torch.int32
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    # tile 1 (cells 128..255) had no valid row: (2^30, r = 0)
    dead = slice(fused_scan.LANES, 2 * fused_scan.LANES)
    assert (d[:, dead] == 2**30).all()
    assert torch.equal(i[:, dead] % HTILE, torch.arange(fused_scan.LANES).expand(q, -1))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("q,k", [(1, 10), (33, 16)])
def test_mma_topk_matches_pallas(w, q, k):
    qs, db, valid = _case(_rows(w), q, w, seed=7 * w + q + k)
    d, i = fused_scan._hamming_cells_mma_plain(_t(qs), _t(db), torch.from_numpy(valid))
    dist, idx = fused_scan._select_plain(d, i, k, largest=False)
    d_ref, i_ref = pallas_scan.hamming_topk_fused_batched(qs, db, valid, k)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("w", [2, 16])
@pytest.mark.parametrize("q", [5, 17])
def test_mma_ties_across_lanes_and_tiles(w, q):
    qs, db, valid = _case(_rows(w), q, w, seed=31 + w + q, ties=True, dead_tile=False)
    (d, i), (d_ref, i_ref) = _cells(qs, db, valid)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    dist, idx = fused_scan._select_plain(d, i, 16, largest=False)
    p_d, p_i = pallas_scan.hamming_topk_fused_batched(qs, db, valid, 16)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(p_d))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_i))
    # three distinct rows: most cells tie, and the position order decides
    assert len(set(dist.numpy()[0].tolist())) < 16


@pytest.mark.parametrize("w", [2, 3])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_mma_at_the_fused_floor(w, k):
    # C = 32,768: two Hamming tiles, the second without a valid row
    qs, db, valid = _case(TILE, 33, w, seed=11 * w + k)
    (d, i), (d_ref, i_ref) = _cells(qs, db, valid)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    dist, idx = fused_scan._select_plain(d, i, k, largest=False)
    d_ref, i_ref = pallas_scan.hamming_topk_fused_batched(qs, db, valid, k)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))


def test_mma_lowest_row_wins_a_cell_tie():
    # rows 7, 135, 263 (r = 0, 1, 2 of lane 7 in tile 0) are copies: the
    # query equal to them finds distance 0 at r = 0 of that cell, and the
    # copies of tile 3 at its own lowest r
    qs, db, valid = _case(TILE, 1, 2, seed=3, dead_tile=False)
    qs[0] = db[7]
    valid[:] = True
    (d, i), _ = _cells(qs, db, valid)
    assert int(d[0, 7]) == 0 and int(i[0, 7]) == 7
    # an invalid r = 0 hands the cell to the next copy
    valid[7] = False
    (d, i), (d_ref, i_ref) = _cells(qs, db, valid)
    assert int(d[0, 7]) == 0 and int(i[0, 7]) == 135
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)


@pytest.mark.parametrize("q", [1, 3])
def test_one_call_out_layout(q):
    # the one allocation of a fused one-call function: q * n cells (values,
    # then indices) and then the [k] or [q, k] outputs
    n, k = 256, 10
    (v_ptr, i_ptr), out_v, out_i = fused_scan._one_call_out(n, k, torch.device("cpu"), q)
    assert i_ptr - v_ptr == 4 * q * n
    assert out_v.data_ptr() == v_ptr + 8 * q * n
    assert out_i.data_ptr() == out_v.data_ptr() + 4 * q * k
    assert out_v.shape == out_i.shape == ((k,) if q == 1 else (q, k))
    assert out_v.dtype == out_i.dtype == torch.int32
