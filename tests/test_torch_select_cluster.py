"""The cluster path of the card's candidate selection, mirrored on the CPU.

For a few queries over many candidates csrc/select.cu spreads each query
over a thread-block cluster: rank r owns the positions [r * span, (r + 1) *
span), span = ceil(N / ranks); the ranks' histograms are summed for every
radix pass; each rank counts its keys above and equal to the threshold,
and an exclusive prefix of those counts over the lower ranks gives each
winner its slot, so ties still go to the lower position. The kernel runs
only on the card; `fused_scan._select_cluster_plain` is its partition in
plain PyTorch. Here it is held EQUAL, value bits and indices, to the
stable sort (`_select_plain`, the CPU path and the card's yardstick) and to
the maximum k of the unique composite keys, for 1, 8 and 16 ranks, N that
the rank count does not divide, all-equal values, +-0.0 and +-inf, ties
that straddle a rank boundary, and k below, at and above one rank's range.
"""

import numpy as np
import pytest
import torch

from ucfp_tpu_torch.ops import fused_scan


def _composite_topk(vals: torch.Tensor, gidx: torch.Tensor, k: int, largest: bool):
    """Maximum k of the unique keys (order word, N - 1 - position)."""
    n = vals.shape[1]
    pos = torch.arange(n, dtype=torch.int64)
    key = ((fused_scan._order_words(vals, largest) - (1 << 31)) << 32) | (n - 1 - pos)
    order = torch.topk(key, k, dim=1, sorted=True).indices
    return torch.gather(vals, 1, order), torch.gather(gidx, 1, order)


def _bits(t: torch.Tensor) -> np.ndarray:
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _case(kind: str, q: int, n: int, ranks: int, dtype, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    span = -(-n // ranks)
    if dtype == torch.int32:  # Hamming distances: few values, many ties
        v = rng.integers(0, 40, (q, n)).astype(np.int32)
        if kind == "zeros":
            v[:] = 0
        elif kind == "signed":
            v[:, ::7] = 1 << 30  # invalid rows' distance
        elif kind == "straddle":
            v[:, max(0, span - 8):span + 8] = 0  # the best distance, across rank 0 | 1
        return torch.from_numpy(v)
    v = rng.normal(size=(q, n)).astype(np.float32)
    if kind == "zeros":
        v[:] = 0.0
    elif kind == "signed":
        pick = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5], np.float32)
        v = pick[rng.integers(0, len(pick), (q, n))]
    elif kind == "straddle":
        v[:, max(0, span - 8):span + 8] = 4.0  # equal best values across rank 0 | 1
        last = (ranks - 1) * span
        v[:, max(0, last - 8):last + 8] = -4.0  # equal worst values across the last boundary
    return torch.from_numpy(v).to(dtype)


def _assert_same(got, want):
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("kind", ["random", "zeros", "signed", "straddle"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n", [4096, 4099])
@pytest.mark.parametrize("ranks", [1, 8, 16])
def test_partition_equals_stable_sort(kind, dtype, largest, n, ranks):
    q = 2
    vals = _case(kind, q, n, ranks, dtype, seed=n * 7 + ranks + len(kind))
    gidx = torch.from_numpy(
        np.random.default_rng(n + ranks).permutation(q * n).astype(np.int32).reshape(q, n))
    span = -(-n // ranks)
    for k in sorted(k for k in {1, 10, span - 1, span, span + 1, n} if k <= n):
        want = fused_scan._select_plain(vals, gidx, k, largest)
        got = fused_scan._select_cluster_plain(vals, gidx, k, largest, ranks)
        assert got[0].dtype == vals.dtype and got[0].shape == (q, k)
        _assert_same(got, want)
        _assert_same(_composite_topk(vals, gidx, k, largest), want)


@pytest.mark.parametrize("ranks", [8, 16])
@pytest.mark.parametrize("n", [39040, 78080])
def test_partition_at_the_card_sizes(n, ranks):
    """#6's candidates at 9,994,240 x 64-bit and #7's at 10M x 64, with k
    at the served pools and above the kernel's shared-memory sort."""
    rng = np.random.default_rng(n + ranks)
    v = rng.normal(size=(1, n)).astype(np.float32)
    v[0, 1000:1300] = v[0, 3]
    vals = torch.from_numpy(v)
    gidx = torch.from_numpy(rng.permutation(n).astype(np.int32)[None])
    for k in (10, 2048, 20000):
        _assert_same(fused_scan._select_cluster_plain(vals, gidx, k, True, ranks),
                     fused_scan._select_plain(vals, gidx, k, True))


def test_partition_refuses_k_above_candidates():
    with pytest.raises(ValueError, match="exceeds"):
        fused_scan._select_cluster_plain(torch.zeros((1, 8)),
                                         torch.zeros((1, 8), dtype=torch.int32), 9, True, 8)


def test_order_words_keep_the_order():
    """-0.0 is +0.0, and the words sort as the values (or reversed)."""
    v = torch.tensor([[-np.inf, -1.5, -0.0, 0.0, 1e-30, 1.5, np.inf]], dtype=torch.float32)
    w = fused_scan._order_words(v, True)[0]
    assert w[2] == w[3] and bool((w[1:] >= w[:-1]).all())
    assert torch.equal(fused_scan._order_words(v, False), 0xFFFFFFFF - w[None])
    i = torch.tensor([[-(1 << 31), -1, 0, 1, (1 << 31) - 1]], dtype=torch.int32)
    assert fused_scan._order_words(i, True)[0].tolist() == [0, (1 << 31) - 1, 1 << 31,
                                                          (1 << 31) + 1, (1 << 32) - 1]
