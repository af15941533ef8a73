"""ucfp_tpu_torch.ops.fused_scan (plain PyTorch versions, CPU) against
ucfp_tpu.ops.pallas_scan (Pallas, interpret mode on the CPU).

The candidate cells and the final selection are integer / comparison
work, so values and indices must be EQUAL — no tolerance — including the
tie-heavy cases (duplicated rows, all-zero scores, equal Hamming
distances across lanes and tiles) where the lowest-row and lowest-
position rules decide. The CUDA kernels are held bit-equal to these same
plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_scan
from ucfp_tpu_torch.ops import fused_scan

TILE = fused_scan.ROWS_PER_TILE * fused_scan.LANES


def _np(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _t2np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _hamming_case(c, q, w, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct rows: equal distances everywhere, across lanes
        # and tiles
        base = rng.integers(0, 2**32, size=(4, w), dtype=np.uint32)
        db = base[rng.integers(0, 4, c)]
    else:
        db = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
        db[100:300] = db[7]  # duplicated rows inside one tile
        db[c - 500:c - 300] = db[7]  # ...and in another tile
    valid = rng.random(c) < 0.9
    qs = db[rng.integers(0, c, q)].copy()
    qs[0] ^= np.uint32(1)  # one query off by a bit
    return qs, db, valid


def _torch_u32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("c", [TILE, 2 * TILE])
@pytest.mark.parametrize("q", [1, 3, 8, 11])
@pytest.mark.parametrize("w", [2, 16])
def test_hamming_plain_matches_pallas(c, q, w):
    qs, db, valid = _hamming_case(c, q, w, seed=c + 10 * q + w)
    k = 16
    d_ref, i_ref = pallas_scan.hamming_topk_fused_batched(qs, db, valid, k)
    d, i = fused_scan.hamming_topk_fused_batched(
        _torch_u32(qs), _torch_u32(db), torch.from_numpy(valid), k)
    assert d.dtype == torch.int32 and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("w", [2, 16])
def test_hamming_ties_across_lanes_and_tiles(w):
    qs, db, valid = _hamming_case(2 * TILE, 11, w, seed=99, ties=True)
    d_ref, i_ref = pallas_scan.hamming_topk_fused_batched(qs, db, valid, 16)
    d, i = fused_scan.hamming_topk_fused_batched(
        _torch_u32(qs), _torch_u32(db), torch.from_numpy(valid), 16)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    # many equal distances: the order is the candidate-position order
    assert len(set(d.numpy()[0].tolist())) < 16


def test_hamming_all_invalid_rows_score_2_pow_30():
    qs, db, _ = _hamming_case(TILE, 3, 2, seed=5)
    valid = np.zeros(TILE, bool)
    d_ref, i_ref = pallas_scan.hamming_topk_fused_batched(qs, db, valid, 4)
    d, i = fused_scan.hamming_topk_fused_batched(
        _torch_u32(qs), _torch_u32(db), torch.from_numpy(valid), 4)
    assert (d.numpy() == 2**30).all()
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


def _scores_case(c, q, seed, zeros=False):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(q, c)).astype(np.float32)
    if zeros:
        s[:] = 0.0  # every cell ties: lowest row, lowest position
    else:
        s[:, 1000:1300] = s[:, 5:6]  # duplicated values in one tile
        s[:, -700:-400] = np.float32(-np.inf)
    return s


@pytest.mark.parametrize("c", [TILE, 2 * TILE])
@pytest.mark.parametrize("q", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_plain_matches_pallas(c, q, dtype):
    s = _scores_case(c, q, seed=c + q)
    sj = jnp.asarray(s).astype(dtype)
    st = torch.from_numpy(s).to(getattr(torch, dtype))
    v_ref, i_ref = pallas_scan.scores_topk_fused_batched(sj, 16)
    v, i = fused_scan.scores_topk_fused_batched(st, 16)
    assert v.dtype == st.dtype
    np.testing.assert_array_equal(_t2np(v), _np(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_all_zero_ties(largest, dtype):
    s = _scores_case(2 * TILE, 11, seed=3, zeros=True)
    v_ref, i_ref = pallas_scan.scores_topk_fused_batched(
        jnp.asarray(s).astype(dtype), 16, largest)
    v, i = fused_scan.scores_topk_fused_batched(
        torch.from_numpy(s).to(getattr(torch, dtype)), 16, largest)
    np.testing.assert_array_equal(_t2np(v), _np(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    # position order, not row order: lane 0..15 of tile 0's row 0
    assert i.numpy()[0].tolist() == list(range(16))


def test_scores_smallest_first():
    s = _scores_case(TILE, 3, seed=4)
    v_ref, i_ref = pallas_scan.scores_topk_fused_batched(jnp.asarray(s), 8, False)
    v, i = fused_scan.scores_topk_fused_batched(torch.from_numpy(s), 8, False)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scores_approx_selects_exactly(dtype):
    s = _scores_case(2 * TILE, 8, seed=8)
    v_ref, i_ref = pallas_scan.scores_topk_fused_batched(
        jnp.asarray(s).astype(dtype), 16, True, True)
    v, i = fused_scan.scores_topk_fused_batched(
        torch.from_numpy(s).to(getattr(torch, dtype)), 16, True, True)
    np.testing.assert_array_equal(_t2np(v), _np(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    v2, i2 = fused_scan.scores_topk_fused_batched_plain(
        torch.from_numpy(s).to(getattr(torch, dtype)), 16)
    np.testing.assert_array_equal(i.numpy(), i2.numpy())


def test_error_cases():
    with pytest.raises(ValueError, match="largest=True only"):
        fused_scan.scores_topk_fused_batched(torch.zeros(1, TILE), 4, False, True)
    with pytest.raises(ValueError, match="C % 32768"):
        fused_scan.scores_topk_fused_batched(torch.zeros(1, TILE + 128), 4)
    with pytest.raises(ValueError, match="C % 32768"):
        fused_scan.hamming_topk_fused_batched(
            torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(TILE // 2, 2, dtype=torch.int32),
            torch.ones(TILE // 2, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="at most 16 words"):
        fused_scan.hamming_topk_fused_batched(
            torch.zeros(1, 17, dtype=torch.int32),
            torch.zeros(TILE, 17, dtype=torch.int32),
            torch.ones(TILE, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="k=.* exceeds"):
        fused_scan.scores_topk_fused_batched(torch.zeros(1, TILE), 257)
    # the same limits as the reference
    with pytest.raises(ValueError):
        pallas_scan.scores_topk_fused_batched(jnp.zeros((1, TILE)), 4, False, True)


def test_plain_wrappers_match_public_on_cpu():
    qs, db, valid = _hamming_case(TILE, 3, 2, seed=12)
    args = (_torch_u32(qs), _torch_u32(db), torch.from_numpy(valid), 8)
    a = fused_scan.hamming_topk_fused_batched(*args)
    b = fused_scan.hamming_topk_fused_batched_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    before = dict(fused_scan.LAUNCHES)
    fused_scan.scores_topk_fused_batched(torch.zeros(2, TILE), 4)
    # the CPU path is the plain version: no kernel launch is counted
    assert fused_scan.LAUNCHES == before


def test_popcount_matches_bin_count():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    got = fused_scan._popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(got, want)


# -- the int8 tier's kernels: #3 scores_topk_fused, #4 dots_norm_topk_fused,
#    #5 dots_norm_topk_fused_batched. Their scores are one division and one
#    product of exact float32 values (|dot| <= 127^2 * 768 < 2^24), each
#    correctly rounded in XLA and in PyTorch, so values are bit-equal too.

DOT_MAX = 127 * 127 * 768


def _dots_case(c, q, seed, ties=False):
    """int32 dots up to +-127^2*768, |int8 row| norms (sqrt of an integer,
    5% zero-norm rows), float32 1/|q|; ties=True makes every dot and every
    norm equal."""
    rng = np.random.default_rng(seed)
    if ties:
        dots = np.full((q, c), 4321, np.int32)
        rn = np.full(c, np.sqrt(np.float32(5000)), np.float32)
    else:
        dots = rng.integers(-DOT_MAX, DOT_MAX + 1, (q, c)).astype(np.int32)
        rn = np.sqrt(rng.integers(1, DOT_MAX, c).astype(np.float32))
        rn[rng.random(c) < 0.05] = 0.0
        # duplicated rows inside one tile and in another tile
        dots[:, 1000:1300] = dots[:, 5:6]
        rn[1000:1300] = rn[5]
        dots[:, c - 500:c - 300] = dots[:, 5:6]
        rn[c - 500:c - 300] = rn[5]
    inv_q = (np.float32(1.0) / np.sqrt(
        rng.integers(1, DOT_MAX, q).astype(np.float32))).astype(np.float32)
    return dots, rn, inv_q


def _n_values(c):
    # the whole catalog, all but the last row, mid-tile, one row
    return (c, c - 1, c - TILE // 2 - 77, 1)


@pytest.mark.parametrize("c", [TILE, 2 * TILE])
@pytest.mark.parametrize("q", [1, 3, 8, 11])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_dots_norm_batched_plain_matches_pallas(c, q, k):
    dots, rn, inv_q = _dots_case(c, q, seed=c + 7 * q + k)
    for n in _n_values(c):
        v_ref, i_ref = pallas_scan.dots_norm_topk_fused_batched(
            jnp.asarray(dots), jnp.asarray(rn), jnp.int32(n), jnp.asarray(inv_q), k)
        v, i = fused_scan.dots_norm_topk_fused_batched(
            torch.from_numpy(dots), torch.from_numpy(rn), n, torch.from_numpy(inv_q), k)
        assert v.dtype == torch.float32 and i.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        assert (i.numpy()[np.isfinite(v.numpy())] < n).all()


@pytest.mark.parametrize("c", [TILE, 2 * TILE])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_dots_norm_single_plain_matches_pallas(c, k):
    dots, rn, inv_q = _dots_case(c, 1, seed=c + k)
    for n in _n_values(c):
        v_ref, i_ref = pallas_scan.dots_norm_topk_fused(
            jnp.asarray(dots[0]), jnp.asarray(rn), jnp.int32(n),
            jnp.float32(inv_q[0]), k)
        v, i = fused_scan.dots_norm_topk_fused(
            torch.from_numpy(dots[0]), torch.from_numpy(rn), n, inv_q[0], k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
        v2, i2 = fused_scan.dots_norm_topk_fused_plain(
            torch.from_numpy(dots[0]), torch.from_numpy(rn), n, inv_q[0], k)
        assert torch.equal(v, v2) and torch.equal(i, i2)


@pytest.mark.parametrize("q", [1, 11])
def test_dots_norm_ties_and_rows_beyond_n(q):
    """Every dot and norm equal: the order is the candidate-position
    order; rows beyond n and whole -inf cells keep their first row."""
    c = 2 * TILE
    dots, rn, inv_q = _dots_case(c, q, seed=q, ties=True)
    for n in (c, 200, 1):
        v_ref, i_ref = pallas_scan.dots_norm_topk_fused_batched(
            jnp.asarray(dots), jnp.asarray(rn), jnp.int32(n), jnp.asarray(inv_q), 16)
        v, i = fused_scan.dots_norm_topk_fused_batched(
            torch.from_numpy(dots), torch.from_numpy(rn), n, torch.from_numpy(inv_q), 16)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    # n = 1: one finite candidate, then -inf cells in position order
    assert i.numpy()[0].tolist() == list(range(16))
    assert np.isneginf(v.numpy()[:, 1:]).all()


@pytest.mark.parametrize("q", [1, 3, 11])
@pytest.mark.parametrize("ties", [False, True])
def test_dots_norm_row_slices_match_pallas(q, ties):
    """The card kernel's order (dots_norm_cells_sliced: 8 interleaved row
    slices, then a merge by score and lowest row) gives the reference's
    cells and top-k, with duplicated rows, ties everywhere, rows beyond n
    and whole -inf cells."""
    c = 2 * TILE
    dots, rn, inv_q = _dots_case(c, q, seed=5 * q + ties, ties=ties)
    td, tr, ti = torch.from_numpy(dots), torch.from_numpy(rn), torch.from_numpy(inv_q)
    for n in (*_n_values(c), 200):
        cells = fused_scan.dots_norm_cells_sliced(td, tr, n, ti)
        plain = fused_scan._dots_norm_cells_plain(td, tr, n, ti)
        assert torch.equal(cells[0].view(torch.int32), plain[0].view(torch.int32))
        assert torch.equal(cells[1], plain[1])
        v, i = fused_scan._select_plain(*cells, 16, largest=True)
        v_ref, i_ref = pallas_scan.dots_norm_topk_fused_batched(
            jnp.asarray(dots), jnp.asarray(rn), jnp.int32(n), jnp.asarray(inv_q), 16)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_dots_norm_row_slices_signed_zeros():
    """A zero 1/|q| makes every score +-0.0: each cell keeps its lowest
    row and that row's own sign, in the slices' merge as in the plain
    cells."""
    c = TILE
    rng = np.random.default_rng(3)
    dots = torch.from_numpy(rng.integers(-3, 4, (2, c)).astype(np.int32))
    rn = torch.ones(c)
    inv_q = torch.zeros(2)
    cells = fused_scan.dots_norm_cells_sliced(dots, rn, c, inv_q)
    plain = fused_scan._dots_norm_cells_plain(dots, rn, c, inv_q)
    assert torch.equal(cells[0].view(torch.int32), plain[0].view(torch.int32))
    assert torch.equal(cells[1], plain[1])
    assert bool((cells[1] == torch.arange(fused_scan.LANES)).all())  # row 0 of the tile
    assert bool(torch.signbit(cells[0]).any()) and bool((cells[0] == 0).all())


@pytest.mark.parametrize("c", [TILE, 2 * TILE])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_scores_single_plain_matches_pallas(c, largest, k):
    s = _scores_case(c, 1, seed=c + k + largest)[0]
    v_ref, i_ref = pallas_scan.scores_topk_fused(jnp.asarray(s), k, largest)
    v, i = fused_scan.scores_topk_fused(torch.from_numpy(s), k, largest)
    assert v.shape == (k,) and i.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    v2, i2 = fused_scan.scores_topk_fused_plain(torch.from_numpy(s), k, largest)
    assert torch.equal(v, v2) and torch.equal(i, i2)


@pytest.mark.parametrize("largest", [True, False])
def test_scores_single_ties(largest):
    s = _scores_case(2 * TILE, 1, seed=5, zeros=True)[0]
    v_ref, i_ref = pallas_scan.scores_topk_fused(jnp.asarray(s), 16, largest)
    v, i = fused_scan.scores_topk_fused(torch.from_numpy(s), 16, largest)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert i.numpy().tolist() == list(range(16))


def test_int8_kernel_error_cases():
    rn = torch.ones(TILE + 128)
    for fn, args, jfn, jargs in (
        (fused_scan.scores_topk_fused, (torch.zeros(TILE + 128), 4),
         pallas_scan.scores_topk_fused, (jnp.zeros(TILE + 128), 4)),
        (fused_scan.dots_norm_topk_fused,
         (torch.zeros(TILE + 128, dtype=torch.int32), rn, 5, 1.0, 4),
         pallas_scan.dots_norm_topk_fused,
         (jnp.zeros(TILE + 128, jnp.int32), jnp.ones(TILE + 128), 5, 1.0, 4)),
        (fused_scan.dots_norm_topk_fused_batched,
         (torch.zeros(2, TILE + 128, dtype=torch.int32), rn, 5, torch.ones(2), 4),
         pallas_scan.dots_norm_topk_fused_batched,
         (jnp.zeros((2, TILE + 128), jnp.int32), jnp.ones(TILE + 128), 5,
          jnp.ones(2), 4)),
    ):
        # the reference's message, word for word
        with pytest.raises(ValueError) as want:
            jfn(*jargs)
        with pytest.raises(ValueError) as got:
            fn(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="int32"):
        fused_scan.dots_norm_topk_fused_batched(
            torch.zeros(2, TILE), torch.ones(TILE), 5, torch.ones(2), 4)
    with pytest.raises(ValueError, match="one per query"):
        fused_scan.dots_norm_topk_fused_batched(
            torch.zeros(2, TILE, dtype=torch.int32), torch.ones(TILE), 5,
            torch.ones(3), 4)


def test_int8_kernels_count_no_launch_on_cpu():
    before = dict(fused_scan.LAUNCHES)
    dots, rn, inv_q = _dots_case(TILE, 2, seed=1)
    fused_scan.dots_norm_topk_fused_batched(
        torch.from_numpy(dots), torch.from_numpy(rn), TILE, torch.from_numpy(inv_q), 4)
    fused_scan.dots_norm_topk_fused(
        torch.from_numpy(dots[0]), torch.from_numpy(rn), TILE, 0.5, 4)
    fused_scan.scores_topk_fused(torch.zeros(TILE), 4)
    assert fused_scan.LAUNCHES == before
    assert {"scores_topk_fused", "dots_norm_topk_fused",
            "dots_norm_topk_fused_batched"} <= set(before)
