"""The port's sketch tier (ucfp_tpu_torch.ops.knn, .sketch_scan) against
ucfp_tpu's (ops/knn.py, the Pallas scan in interpret mode) on the CPU.

Exact, bit for bit: the planes (numpy, copied), the sketch build (q8 @
planes sums integers below 2^24, so its signs are exact), the tiling, and
the scan on the same plan — the reference's scan and its sum(wts * cnt)
as XLA compiles them on the CPU contract into fused multiply-adds, and
the port computes exactly those (ops/sketch_scan.py). The held reference
is the jitted function, as the served pipeline runs it.

Within a tolerance: the query plan. Its projection query @ planes is a
float32 sum whose last bits depend on the summation order, so the level
weights agree to WTS_RTOL relative; its sign bits, level masks and
counts must be equal. The pipelines are held to the same ids and
bit-equal scores (the final scores are exact int8 cosines).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import knn as J
from ucfp_tpu_torch.ops import knn as T
from ucfp_tpu_torch.ops import sketch_scan

#: relative tolerance of the plan's level weights (float32 sums of 768
#: terms in another order; measured below 6e-7)
WTS_RTOL = 4e-6


def _bits(x):
    return np.ascontiguousarray(np.asarray(x), np.float32).view(np.int32)


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)).view(np.int32).copy())


def _q8(c, d, seed):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(c, d)).astype(np.float32)
    rows[3] = 0.0
    q8, rn = J.quantize_rows_int8(rows)
    return rows, np.array(q8), np.array(rn)


@pytest.mark.parametrize("dim", [16, 64, 768])
def test_planes_bit_equal(dim):
    p = T.sketch_planes(dim)
    assert p.dtype == np.float32 and p.shape == (dim, T.SKETCH_BITS)
    np.testing.assert_array_equal(p, J.sketch_planes(dim))
    assert (T.SKETCH_BITS, T.SKETCH_WORDS, T.SKETCH_LEVELS, T.SKETCH_SEG, T.SKETCH_LANES,
            T.DEFAULT_POOL_FRAC) == (
        J.SKETCH_BITS, J.SKETCH_WORDS, J.SKETCH_LEVELS, J.SKETCH_SEG, J.SKETCH_LANES,
        J.DEFAULT_POOL_FRAC)


@pytest.mark.parametrize("d", [16, 96])
def test_sketch_build_and_tiling_bit_equal(d):
    _, q8, _ = _q8(1280, d, seed=d)
    planes = J.sketch_planes(d)
    ref = np.asarray(J.sketch_rows_int8(jnp.asarray(q8), jnp.asarray(planes)))
    got = T.sketch_rows_int8(torch.from_numpy(q8), torch.from_numpy(planes))
    assert got.dtype == torch.int32 and got.shape == (1280, T.SKETCH_WORDS)
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))
    chunked = T.build_sketch_chunked(torch.from_numpy(q8), torch.from_numpy(planes), chunk=500)
    assert torch.equal(chunked, got)
    np.testing.assert_array_equal(
        chunked.numpy(), np.asarray(J.build_sketch_chunked(
            jnp.asarray(q8), jnp.asarray(planes), chunk=500)).view(np.int32))
    tiled = T.tile_sketch(got)
    assert tiled.shape == (10, T.SKETCH_WORDS, 128) and tiled.is_contiguous()
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(J.tile_sketch(jnp.asarray(ref))))
    # the backend sketches q8m[:, :D] out of its wider device matrix
    wide = torch.zeros((1280, d + 8), dtype=torch.int8)
    wide[:, :d] = torch.from_numpy(q8)
    assert torch.equal(T.sketch_rows_int8(wide[:, :d], torch.from_numpy(planes)), got)


def test_query_plan_within_tolerance():
    d = 768
    planes = J.sketch_planes(d)
    rng = np.random.default_rng(4)
    qs = rng.normal(size=(60, d)).astype(np.float32)
    qs[1] = 0.0
    qs[1, 0] = 5.0  # one-hot: every |projection| equal, one level
    qs[2] = np.round(qs[2] * 4)  # integer query: an exact projection
    worst = 0.0
    for q in qs:
        ref = J.sketch_query_plan(jnp.asarray(q), jnp.asarray(planes))
        got = T.sketch_query_plan(torch.from_numpy(q), torch.from_numpy(planes))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]).view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]).view(np.int32))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=WTS_RTOL, atol=0)
        np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=WTS_RTOL)
        w_ref = np.asarray(ref[2]).astype(np.float64)
        nz = w_ref != 0
        worst = max(worst, float(np.max(np.abs(got[2].numpy()[nz] - w_ref[nz]) / w_ref[nz])))
    one = T.sketch_query_plan(torch.from_numpy(qs[1]), torch.from_numpy(planes))
    assert one[3].tolist() == [0.0, 0.0, 0.0, 768.0] and int((one[2] == 0).sum()) == 3
    assert worst < WTS_RTOL


def _plan_pair(q, planes):
    """The reference's plan, and the same plan as the port's tensors."""
    ref = J.sketch_query_plan(jnp.asarray(q), jnp.asarray(planes))[:4]
    return ref, (_i32(ref[0]), _i32(ref[1]), torch.from_numpy(np.array(ref[2])),
                 torch.from_numpy(np.array(ref[3])))


@pytest.mark.parametrize("case", ["random", "onehot", "duplicates"])
def test_scan_plain_matches_pallas(case):
    """#15's plain version bit-equal to the jitted Pallas scan (interpret
    mode) on the reference's own plan."""
    c, d = 4096, 64
    _, q8, _ = _q8(c, d, seed=7)
    planes = J.sketch_planes(d)
    packed = np.asarray(J.sketch_rows_int8(jnp.asarray(q8), jnp.asarray(planes)))
    if case == "duplicates":
        packed = packed[np.random.default_rng(1).integers(0, 4, c)]  # 4 distinct rows
    q = np.random.default_rng(8).normal(size=d).astype(np.float32) * 3
    if case == "onehot":
        q = np.zeros(d, np.float32)
        q[5] = 5.0
    tiled_ref = J.tile_sketch(jnp.asarray(packed))
    ref_plan, plan = _plan_pair(q, planes)
    ref = np.asarray(jax.jit(J.asym_sketch_scores_tiled)(tiled_ref, *ref_plan))
    tiled = torch.from_numpy(np.asarray(tiled_ref).copy())
    got = sketch_scan.asym_sketch_scores_tiled(tiled, *plan)
    assert got.dtype == torch.float32 and got.shape == (c,)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    plain = sketch_scan.asym_sketch_scores_tiled_plain(tiled, *plan)
    assert torch.equal(plain.view(torch.int32), got.view(torch.int32))
    if case == "duplicates":
        assert len(np.unique(_bits(got))) <= 4


def test_scan_error_cases_and_no_cpu_launch():
    before = dict(sketch_scan.LAUNCHES)
    tiled = torch.zeros((2, 24, 128), dtype=torch.int32)
    plan = (torch.zeros(24, dtype=torch.int32), torch.zeros((4, 24), dtype=torch.int32),
            torch.ones(4), torch.full((4,), 192.0))
    out = sketch_scan.asym_sketch_scores_tiled(tiled, *plan)
    assert torch.equal(out, torch.full((256,), 4.0 * 192))
    assert sketch_scan.LAUNCHES == before == {"asym_sketch_scores_tiled": 0}
    with pytest.raises(ValueError, match="sketch must be"):
        sketch_scan.asym_sketch_scores_tiled(torch.zeros((256, 24), dtype=torch.int32), *plan)
    with pytest.raises(ValueError, match="plan must be"):
        sketch_scan.asym_sketch_scores_tiled(tiled, plan[0][:8], *plan[1:])


@pytest.mark.parametrize("c,d,k,pool", [
    (8192, 64, 10, 2048),    # the served floor pool: segment quotas of 8
    (8192, 64, 10, 2500),    # a quota above the floor
    (8192, 64, 10, 4096),    # pool * 2 >= C: exhaustive rescore
    (4096 + 128, 32, 5, 700),  # C not a multiple of 512: -inf padding
])
def test_cosine_sketch_topk_equal(c, d, k, pool):
    rows, q8, rn = _q8(c, d, seed=c + pool)
    planes = J.sketch_planes(d)
    tiled = np.asarray(J.tile_sketch(J.build_sketch_chunked(jnp.asarray(q8),
                                                            jnp.asarray(planes))))
    rng = np.random.default_rng(pool)
    n = c - 100
    valid = np.arange(c) < n
    fvalid = valid.copy()
    fvalid[::3] = False  # a filter
    fvalid[777] = True
    wide = np.zeros((c, d + 8), np.int8)
    wide[:, :d] = q8
    queries = [rows[777] + 0.05 * rng.normal(size=d).astype(np.float32)]
    queries += [rng.normal(size=d).astype(np.float32) for _ in range(3)]
    for qi, q in enumerate(queries):
        for vv in (valid, fvalid):
            s_ref, i_ref = J.cosine_sketch_topk(
                jnp.asarray(q), jnp.asarray(planes), jnp.asarray(q8), jnp.asarray(rn),
                jnp.asarray(tiled), jnp.asarray(vv), k, pool)
            s, i = T.cosine_sketch_topk(
                torch.from_numpy(q), torch.from_numpy(planes), torch.from_numpy(wide),
                torch.from_numpy(rn), torch.from_numpy(tiled.view(np.int32).copy()),
                torch.from_numpy(vv), k, pool)
            np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
            np.testing.assert_array_equal(_bits(s), _bits(s_ref))
            if qi == 0:
                assert int(i[0]) == 777


def test_pool_and_env(monkeypatch):
    for cap, k in ((1024, 10), (8192, 1), (1 << 22, 10), (1 << 22, 100)):
        for frac in (None, 0.0066, 0.021):
            assert T.sketch_pool(cap, k, frac) == J.sketch_pool(cap, k, frac)
    monkeypatch.setenv("UCFP_SKETCH_POOL_FRAC", "0.3")
    assert T.sketch_pool(1 << 20, 10) == J.sketch_pool(1 << 20, 10) == int(0.3 * (1 << 20))
