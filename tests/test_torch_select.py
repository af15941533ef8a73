"""The candidate selection of ucfp_tpu_torch.ops.fused_scan on the CPU.

On the card every fused scan selects its top k with a kernel of its own
(csrc/select.cu), which keys each candidate by a unique 64-bit integer:
the value's order-preserving bits (-0.0 made +0.0 first; complemented for
smallest-first) above the reversed position, so the k largest keys, in
order, are the first k of the stable sort. `_composite_topk` below is a
plain mirror of that key; it is held EQUAL, value bits and indices, to
`_select_plain` (the stable sort that is the CPU path and the card's
yardstick) over tie-heavy inputs: all-zero rows, values duplicated inside
and across 128-candidate tiles, mixes of +-0.0 and +-inf.

The fused wrappers' plain versions are also held to ucfp_tpu.ops.pallas_scan
(Pallas, interpret mode) at the large k the served paths ask for: the int4
single-query pool (k = 2048 of 16,384 candidates, #3) and the int4 batch
pool over bf16 scores (k = 640, #1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucfp_tpu.ops import pallas_scan
from ucfp_tpu_torch.ops import fused_scan

N = 4096  # candidates per query: 32 tiles of 128 lanes


def _order_word(vals: torch.Tensor, largest: bool) -> torch.Tensor:
    """The kernel's high word, as int64 in [0, 2^32): value order kept."""
    if vals.dtype == torch.int32:
        u = vals.to(torch.int64) + (1 << 31)
    else:
        b = vals.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        b = torch.where(b == 0x80000000, 0, b)  # -0.0 ties with +0.0
        u = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    return u if largest else 0xFFFFFFFF - u


def _composite_topk(vals: torch.Tensor, gidx: torch.Tensor, k: int, largest: bool):
    """Maximum k of the unique keys (order word, N - 1 - position)."""
    n = vals.shape[1]
    pos = torch.arange(n, dtype=torch.int64)
    key = ((_order_word(vals, largest) - (1 << 31)) << 32) | (n - 1 - pos)
    order = torch.topk(key, k, dim=1, sorted=True).indices
    return torch.gather(vals, 1, order), torch.gather(gidx, 1, order)


def _bits(t: torch.Tensor) -> np.ndarray:
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _case(kind: str, q: int, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:  # Hamming distances: few values, many ties
        v = rng.integers(0, 40, (q, N)).astype(np.int32)
        if kind == "zeros":
            v[:] = 0
        elif kind == "signed":
            v[:, ::7] = 1 << 30  # invalid rows' distance
        return torch.from_numpy(v)
    v = rng.normal(size=(q, N)).astype(np.float32)
    if kind == "zeros":
        v[:] = 0.0
    elif kind == "dups":
        v[:, 5:40] = v[:, 3:4]  # inside tile 0
        v[:, 1000:1300] = v[:, 3:4]  # across tiles
        v[:, -300:] = v[:, 3:4]
    elif kind == "signed":
        pick = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5], np.float32)
        v = pick[rng.integers(0, len(pick), (q, N))]
    return torch.from_numpy(v).to(dtype)


@pytest.mark.parametrize("kind", ["random", "zeros", "dups", "signed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("q", [1, 5, 64])
def test_composite_key_equals_stable_sort(kind, dtype, largest, q):
    vals = _case(kind, q, dtype, seed=q * 31 + len(kind))
    gidx = torch.from_numpy(
        np.random.default_rng(q).permutation(q * N).astype(np.int32).reshape(q, N))
    for k in (1, 10, 16, N // 2, N):
        v_ref, i_ref = fused_scan._select_plain(vals, gidx, k, largest)
        v, i = _composite_topk(vals, gidx, k, largest)
        assert v.dtype == vals.dtype and v.shape == (q, k)
        np.testing.assert_array_equal(_bits(v), _bits(v_ref))
        np.testing.assert_array_equal(i.numpy(), i_ref.numpy())
        # _select is the stable sort itself on the CPU
        v2, i2 = fused_scan._select(vals, gidx, k, largest)
        np.testing.assert_array_equal(_bits(v2), _bits(v_ref))
        np.testing.assert_array_equal(i2.numpy(), i_ref.numpy())


def test_signed_zeros_keep_their_sign_and_position_order():
    vals = torch.tensor([[0.0, -0.0, 0.0, -0.0, -1.0]])
    gidx = torch.arange(5, dtype=torch.int32)[None]
    for largest in (True, False):
        v, i = fused_scan._select_plain(vals, gidx, 5, largest)
        vc, ic = _composite_topk(vals, gidx, 5, largest)
        assert torch.equal(i, ic) and torch.equal(v.view(torch.int32), vc.view(torch.int32))
    v, i = fused_scan._select_plain(vals, gidx, 4, True)
    assert i.tolist() == [[0, 1, 2, 3]]  # +-0.0 tie: position order
    assert torch.signbit(v).tolist() == [[False, True, False, True]]


def test_select_refuses_k_above_candidates():
    vals = torch.zeros((1, 8))
    gidx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds"):
        fused_scan._select(vals, gidx, 9, True)


def test_cpu_select_counts_no_launch():
    before = dict(fused_scan.LAUNCHES)
    fused_scan._select(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32), 3, True)
    assert fused_scan.LAUNCHES == before
    assert "select_topk" in before


@pytest.mark.parametrize("largest", [True, False])
def test_scores_topk_fused_pool_matches_pallas(largest):
    """#3 at the int4 single-query pool: k = 2048 of 16,384 candidates."""
    c = 16384 * fused_scan.ROWS_PER_TILE
    rng = np.random.default_rng(11)
    s = rng.normal(size=c).astype(np.float32)
    s[1000:1300] = s[5]  # ties inside one tile
    s[c - 500:c - 300] = s[5]
    s[-70000:-40000] = -np.inf if largest else np.inf
    v_ref, i_ref = pallas_scan.scores_topk_fused(jnp.asarray(s), 2048, largest)
    st = torch.from_numpy(s)
    v, i = fused_scan.scores_topk_fused_plain(st, 2048, largest)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    v2, i2 = fused_scan.scores_topk_fused(st, 2048, largest)
    assert torch.equal(v2, v) and torch.equal(i2, i)


@pytest.mark.parametrize("zeros", [False, True])
def test_scores_topk_fused_batched_bf16_pool_matches_pallas(zeros):
    """#1 at the int4 batch pool: k = 640 over bf16 scores."""
    q, c = 5, 1 << 20
    rng = np.random.default_rng(12)
    s = np.zeros((q, c), np.float32) if zeros else rng.normal(size=(q, c)).astype(np.float32)
    if not zeros:
        s[:, 1000:1300] = s[:, 5:6]
        s[:, -70000:-40000] = -np.inf
    sj = jnp.asarray(s).astype(jnp.bfloat16)
    v_ref, i_ref = pallas_scan.scores_topk_fused_batched(sj, 640)
    st = torch.from_numpy(s).to(torch.bfloat16)
    v, i = fused_scan.scores_topk_fused_batched_plain(st, 640)
    assert v.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_ref.astype(jnp.float32)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    v2, i2 = fused_scan.scores_topk_fused_batched(st, 640)
    assert torch.equal(v2.view(torch.int16), v.view(torch.int16)) and torch.equal(i2, i)
