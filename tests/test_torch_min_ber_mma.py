"""The min-BER kernel's formulation (csrc/min_ber.cu) in plain PyTorch,
ucfp_tpu_torch.ops.audio.haitsma._min_ber_mma_plain, against the port's
plain search (min_ber_batch_plain) and ucfp_tpu's min_ber_batch on the CPU.

The twin computes errs = S + Pq - 2 D: D through the query shifted a word
a column (the binary tensor-core product's B operand) in 8-word k-steps
and the kernel's register slot order, S through prefix sums of the row
words' popcounts, query passes of MMA_QCHUNK words. Tolerance: none. The
BER is one IEEE float32 division of an integer error count in every
version, so BER bits and offsets must be equal. Inputs come from numpy
with a seed; the words past each row's length and past the query's live
words are nonzero, since the kernel reads past both and must not depend
on them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ucfp_tpu.ops.audio import haitsma as jh
from ucfp_tpu_torch.ops.audio import haitsma as th


def _inputs(seed: int, r: int, tb: int, qb: int, q_true: int, ties: bool = False):
    """Random u32 rows with random words past their lengths, dead rows,
    rows shorter than the query, full rows, and a query cut from a live
    row with a tenth of its words scrambled, random words past q_true.
    With ties, half the rows have period 4 and the query matches them at
    every 4th offset."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, (r, tb), dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, tb + 1, r).astype(np.int32)
    lens[0] = 0  # dead
    lens[1] = tb
    lens[2] = max(q_true - 1, 0)  # shorter than the query
    lens[3] = min(tb, q_true + 3)
    q_pad = rng.integers(0, 2**32, qb, dtype=np.uint64).astype(np.uint32)
    if ties:
        period = np.array([0x0F0F0F0F, 0x33333333, 0x0F0F0F0F, 0x55555555], np.uint32)
        db[::2] = period[np.arange(tb) % 4]
        lens[4::2] = tb - np.arange(len(lens[4::2]))  # long enough for the query
        q_pad[:q_true] = period[np.arange(q_true) % 4]
    else:
        src = min(5, tb - q_true)
        q_pad[:q_true] = db[1, src:src + q_true]
        q_pad[:q_true] ^= np.where(rng.random(q_true) < 0.1,
                                   rng.integers(0, 2**32, q_true, dtype=np.uint64), 0
                                   ).astype(np.uint32)
    return db, lens, q_pad


def _three(db, lens, q_pad, q_true):
    want = jh.min_ber_batch(jnp.asarray(db), jnp.asarray(lens), jnp.asarray(q_pad),
                            jnp.int32(q_true))
    args = (torch.from_numpy(db.view(np.int32)), torch.from_numpy(lens),
            torch.from_numpy(q_pad.view(np.int32)), q_true)
    plain = th.min_ber_batch_plain(*args)
    twin = th._min_ber_mma_plain(*args)
    return [np.asarray(a) for a in want], [a.numpy() for a in plain], [a.numpy() for a in twin]


def _assert_equal(got, want):
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
    assert np.array_equal(got[1], want[1])


# (rows, Tb, Qb, q_true): Tb - Qb + 1 offsets, none a multiple of 128
CASES = [
    (12, 264, 64, 0),
    (12, 264, 64, 1),
    (12, 264, 64, 7),
    (12, 264, 64, 8),
    (12, 264, 64, 9),
    (10, 456, 256, 255),
    (10, 456, 256, 256),
    (10, 712, 512, 257),
    (10, 712, 512, 359),
    # passes of MMA_QCHUNK query words: 2 (the second of 88) and 3
    (6, 700, 600, 600),
    (5, 1300, 1100, 1100),
    # several warp tiles and blocks of offsets on one row
    (5, 2600, 64, 40),
]


@pytest.mark.parametrize("r,tb,qb,q_true", CASES)
def test_mma_twin_equals_reference(r, tb, qb, q_true):
    db, lens, q_pad = _inputs(q_true + tb, r, tb, qb, q_true)
    want, plain, twin = _three(db, lens, q_pad, q_true)
    _assert_equal(plain, want)
    _assert_equal(twin, want)
    assert twin[1][0] == (0 if q_true == 0 else -1)  # the dead row
    if q_true > 1:
        assert twin[1][2] == -1 and np.isinf(twin[0][2])  # shorter than the query
    if q_true:
        assert twin[1][1] == min(5, tb - q_true)  # the query's source row


@pytest.mark.parametrize("r,tb,qb,q_true", [(12, 264, 64, 12), (10, 712, 512, 359),
                                            (6, 1200, 1024, 513)])
def test_mma_twin_ties_take_the_first_offset(r, tb, qb, q_true):
    db, lens, q_pad = _inputs(q_true, r, tb, qb, q_true, ties=True)
    want, plain, twin = _three(db, lens, q_pad, q_true)
    _assert_equal(plain, want)
    _assert_equal(twin, want)
    live = [i for i in range(0, r, 2) if lens[i] >= q_true]
    assert live and all(twin[1][i] == 0 and twin[0][i] == 0.0 for i in live)


def test_mma_twin_ignores_the_padding():
    """The words past lens and past q_true change; the answer does not."""
    db, lens, q_pad = _inputs(3, 10, 712, 512, 359)
    base = _three(db, lens, q_pad, 359)[2]
    rng = np.random.default_rng(4)
    for i, n in enumerate(lens):
        db[i, n:] = rng.integers(0, 2**32, 712 - n, dtype=np.uint64).astype(np.uint32)
    q_pad[359:] = ~q_pad[359:]
    want, plain, twin = _three(db, lens, q_pad, 359)
    _assert_equal(twin, want)
    _assert_equal(twin, base)


def test_mma_twin_query_as_long_as_the_rows():
    """q_true = Tb: one offset, on the full rows only."""
    db, lens, q_pad = _inputs(5, 8, 320, 320, 320)
    want, plain, twin = _three(db, lens, q_pad, 320)
    _assert_equal(twin, want)
    assert all(o == (0 if n == 320 else -1) for o, n in zip(twin[1], lens))
