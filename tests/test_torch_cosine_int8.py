"""The int8-cosine scans of ucfp_tpu_torch.ops.fused_scan (plain PyTorch
versions, CPU) against ucfp_tpu.ops.pallas_scan (Pallas, interpret mode on
the CPU): cosine_int8_topk_fused, cosine_int8_topk_mxu and
cosine_int8_topk_hybrid.

The dots are exact integers and the rest is one float32 conversion, one
division per score and comparisons, so values must be bit-equal and ids
equal -- no tolerance -- including the tie-heavy catalogs (duplicated rows
inside a cell and across cells) and the all-zero query, under which every
score ties and the cell and candidate position rules decide. A k equal to
the whole candidate pool compares every cell. The CUDA kernels are held
bit-equal to these same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_scan
from ucfp_tpu_torch.ops import fused_scan

TILE_C = fused_scan.ROWS_PER_TILE_C * fused_scan.LANES  # 16,384 rows


def _catalog(c, d, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # four distinct rows: equal scores in every cell and across cells
        db8 = rng.integers(-128, 128, size=(4, d), dtype=np.int8)[rng.integers(0, 4, c)]
    else:
        db8 = rng.integers(-128, 128, size=(c, d), dtype=np.int8)
        db8[128 * 5 + 3::128 * 7][:9] = db8[3]  # row 3 again in its lane, later tiles
        db8[200:260] = db8[7]  # row 7 in neighbouring lanes of its tile
        db8[c - 64:] = db8[7]  # ...and in the last tile
        db8[11] = 0  # a zero row: norm 0, floored to 1e-9
    rn = np.sqrt((db8.astype(np.int64) ** 2).sum(axis=1)).astype(np.float32)
    q8 = db8[7].copy()
    q8[0] = np.int8(-q8[0]) if q8[0] != -128 else np.int8(127)
    return q8, db8, rn


def _port(fn, q8, db8, rn, k):
    v, i = fn(torch.from_numpy(q8), torch.from_numpy(db8), torch.from_numpy(rn), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


def _assert_same(got, ref):
    v, i = got
    rv, ri = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(v.view(np.int32), rv.view(np.int32))
    np.testing.assert_array_equal(i, ri)


@pytest.mark.parametrize("c", [TILE_C, 2 * TILE_C])
@pytest.mark.parametrize("d", [64, 48])
@pytest.mark.parametrize("k", [1, 8, 16])
def test_fused_plain_matches_pallas(c, d, k):
    q8, db8, rn = _catalog(c, d, seed=c + d + k)
    ref = pallas_scan.cosine_int8_topk_fused(q8, db8, rn, k)
    _assert_same(_port(fused_scan.cosine_int8_topk_fused, q8, db8, rn, k), ref)
    _assert_same(_port(fused_scan.cosine_int8_topk_fused_plain, q8, db8, rn, k), ref)


@pytest.mark.parametrize("ties,zero_query", [(True, False), (False, True), (True, True)])
def test_fused_ties_every_cell(ties, zero_query):
    c = 2 * TILE_C
    q8, db8, rn = _catalog(c, 64, seed=41, ties=ties)
    if zero_query:
        q8[:] = 0  # every score is 0: positions decide
    k = c // fused_scan.ROWS_PER_TILE_C  # the whole pool: every cell
    ref = pallas_scan.cosine_int8_topk_fused(q8, db8, rn, k)
    got = _port(fused_scan.cosine_int8_topk_fused, q8, db8, rn, k)
    _assert_same(got, ref)
    if zero_query:
        # every cell keeps its first row, the cells come in position order
        pos = np.arange(k)
        np.testing.assert_array_equal(got[1], pos // 128 * TILE_C + pos % 128)


# line counts whose _pick_rpt is 1024, 800, 320 and 32
@pytest.mark.parametrize("lines,rpt", [(2048, 1024), (1600, 800), (320, 320), (224, 32)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_mxu_plain_matches_pallas(lines, rpt, d):
    assert fused_scan._pick_rpt(lines) == rpt
    per = 128 // d
    c = lines * per
    q8, db8, rn = _catalog(c, d, seed=lines + d)
    pool = lines // rpt * fused_scan.SUB * per
    for k in sorted({1, min(10, pool), min(16, pool), pool}):
        ref = pallas_scan.cosine_int8_topk_mxu(q8, db8, rn, k)
        _assert_same(_port(fused_scan.cosine_int8_topk_mxu, q8, db8, rn, k), ref)
        _assert_same(_port(fused_scan.cosine_int8_topk_mxu_plain, q8, db8, rn, k), ref)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("ties,zero_query", [(True, False), (False, True)])
def test_mxu_ties_every_cell(d, ties, zero_query):
    per = 128 // d
    lines = 1600
    q8, db8, rn = _catalog(lines * per, d, seed=d, ties=ties)
    if zero_query:
        q8[:] = 0
    pool = lines // 800 * fused_scan.SUB * per
    ref = pallas_scan.cosine_int8_topk_mxu(q8, db8, rn, pool)
    _assert_same(_port(fused_scan.cosine_int8_topk_mxu, q8, db8, rn, pool), ref)


@pytest.mark.parametrize("k", [1, 10])
def test_hybrid_matches_pallas(k):
    c = 1 << 16
    q8, db8, rn = _catalog(c, 64, seed=k)
    ref = pallas_scan.cosine_int8_topk_hybrid(q8, db8, rn, k)
    _assert_same(_port(fused_scan.cosine_int8_topk_hybrid, q8, db8, rn, k), ref)
    # top-1 is exact under the fused scan's cells: the same best score
    fused = _port(fused_scan.cosine_int8_topk_fused, q8, db8, rn, k)
    assert fused[0][:1].view(np.int32) == np.asarray(ref[0])[:1].view(np.int32)


@pytest.mark.parametrize("fn_name,c,d,k", [
    ("cosine_int8_topk_fused", TILE_C + 128, 64, 4),  # C not whole 128-row tiles
    ("cosine_int8_topk_mxu", 1024, 48, 4),  # 128 % D != 0
    ("cosine_int8_topk_mxu", 1025, 64, 4),  # C % per != 0
    ("cosine_int8_topk_mxu", 200, 64, 4),  # 100 lines: no rpt divides them
    ("cosine_int8_topk_mxu", 64, 64, 17),  # k above the 16-candidate pool
])
def test_reference_value_errors(fn_name, c, d, k):
    q8 = np.ones(d, np.int8)
    db8 = np.ones((c, d), np.int8)
    rn = np.ones(c, np.float32)
    with pytest.raises(ValueError):
        getattr(pallas_scan, fn_name)(q8, db8, rn, k)
    for fn in (getattr(fused_scan, fn_name), getattr(fused_scan, fn_name + "_plain")):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(q8), torch.from_numpy(db8), torch.from_numpy(rn), k)


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    q8, db8, rn = _catalog(TILE_C, 64, seed=3)
    fused_scan.reset_launch_counts()
    a = _port(fused_scan.cosine_int8_topk_fused, q8, db8, rn, 8)
    b = _port(fused_scan.cosine_int8_topk_fused_plain, q8, db8, rn, 8)
    m = _port(fused_scan.cosine_int8_topk_mxu, q8, db8, rn, 8)
    mp = _port(fused_scan.cosine_int8_topk_mxu_plain, q8, db8, rn, 8)
    _port(fused_scan.cosine_int8_topk_hybrid, q8, np.concatenate([db8, db8]),
          np.concatenate([rn, rn]), 8)
    assert all(n == 0 for n in fused_scan.LAUNCHES.values())
    _assert_same(a, b)
    _assert_same(m, mp)


@pytest.mark.parametrize("name,dims,d,ok", [
    ("cosine_int8_topk_fused", fused_scan.COSINE_I8_KERNEL_DIMS, 64, True),
    ("cosine_int8_topk_fused", fused_scan.COSINE_I8_KERNEL_DIMS, 48, False),
    ("cosine_int8_topk_fused", fused_scan.COSINE_I8_KERNEL_DIMS, 128, False),
    ("cosine_int8_topk_mxu", fused_scan.MXU_KERNEL_DIMS, 32, True),
    ("cosine_int8_topk_mxu", fused_scan.MXU_KERNEL_DIMS, 128, True),
    ("cosine_int8_topk_mxu", fused_scan.MXU_KERNEL_DIMS, 16, False),
])
def test_card_checks_take_only_the_held_widths(name, dims, d, ok):
    """The card's kernels take only the row widths the GPU smoke test holds
    bit-equal; the plain versions (no kernel_dims) take any."""
    q8, db8, rn = (torch.ones(d, dtype=torch.int8), torch.ones((256, d), dtype=torch.int8),
                   torch.ones(256))
    fused_scan._check_cosine_i8(name, q8, db8, rn)
    if ok:
        fused_scan._check_cosine_i8(name, q8, db8, rn, dims)
    else:
        with pytest.raises(ValueError, match="the kernel takes D"):
            fused_scan._check_cosine_i8(name, q8, db8, rn, dims)
