"""The port's Haitsma words and minimum-BER search
(ucfp_tpu_torch.ops.audio.haitsma) against ucfp_tpu's on the CPU.

Tolerance: bit-equal. Words are integers; the BER is one IEEE float32
division of an integer error count by 32 * q_true in both packages, so
the BER bits and the offsets must match exactly. On the CPU min_ber_batch
is the plain version (min_ber_batch_plain); chip_smoke.py holds the card's
kernel (csrc/min_ber.cu) bit-equal to it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import enable_x64

from ucfp_tpu.ops.audio import dsp as jdsp
from ucfp_tpu.ops.audio import haitsma as jh
from ucfp_tpu_torch.ops.audio import haitsma as th


def _clip5k(seed: int, secs: float = 2.0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.3, int(secs * 5000)).astype(np.float32)


@pytest.mark.parametrize("fft", [False, True])
@pytest.mark.parametrize("band", [(300.0, 2000.0), (200.0, 1800.0), (1900.0, 2000.0)])
def test_haitsma_words_bit_equal(fft, band):
    q = jdsp.quantize_samples_i16(_clip5k(1))
    with enable_x64():
        want = np.asarray(jh.haitsma_words(jnp.asarray(q), *band, fft))
    got = th.haitsma_words(torch.from_numpy(q), *band, fft)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("fft", [False, True])
def test_fingerprint_frames_and_batch_equal(fft):
    cfg_j, cfg_t = jh.HaitsmaConfig(fft=fft), th.HaitsmaConfig(fft=fft)
    x = _clip5k(2, 1.5)
    for sr in (5000, 8000, 44100):
        want = jh.fingerprint_frames(x, sr, cfg_j)
        got = th.fingerprint_frames(x, sr, cfg_t, device="cpu")
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    stack = np.stack([_clip5k(s, 1.0) for s in (3, 4, 5)])
    batch = th.fingerprint_frames_batch(stack, cfg_t, device="cpu")
    for i in range(3):
        assert np.array_equal(batch[i], jh.fingerprint_frames(stack[i], 5000, cfg_j))
    short = th.fingerprint_frames_batch(stack[:, :2000], cfg_t, device="cpu")
    assert [len(s) for s in short] == [0, 0, 0]


def _catalog(seed: int, r: int, tb: int):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, (r, tb), dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, tb + 1, r).astype(np.int32)
    lens[0] = 0  # a dead row
    lens[1] = 3  # shorter than most queries
    lens[2] = tb
    db[3, :] = 0xAAAAAAAA  # periodic: every offset ties
    lens[3] = tb // 2
    db[4, :] = np.tile(np.array([1, 2, 3, 4], np.uint32), tb // 4)  # period-4 ties
    for i in range(r):
        db[i, lens[i]:] = 0
    return db, lens


def _both(db, lens, q_pad, q_true):
    want = jh.min_ber_batch(jnp.asarray(db), jnp.asarray(lens), jnp.asarray(q_pad),
                            jnp.int32(q_true))
    got = th.min_ber_batch(torch.from_numpy(db.view(np.int32)), torch.from_numpy(lens),
                           torch.from_numpy(q_pad.view(np.int32)), q_true)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("q_true,qb", [(1, 64), (5, 64), (40, 64), (64, 64), (100, 128),
                                       (256, 256)])
def test_min_ber_batch_plain_bit_equal(q_true, qb):
    db, lens = _catalog(7, 33, 256)
    rng = np.random.default_rng(q_true)
    q_pad = np.zeros(qb, np.uint32)
    src = db[2, 17:17 + q_true] if q_true <= 256 - 17 else db[2, :q_true]
    q_pad[:q_true] = src ^ (rng.random(q_true) < 0.1).astype(np.uint32)
    (wb, wo), (gb, go) = _both(db, lens, q_pad, q_true)
    assert gb.dtype == np.float32 and go.dtype == np.int32
    assert np.array_equal(wb.view(np.int32), gb.view(np.int32))
    assert np.array_equal(wo, go)
    assert go[0] == -1 and np.isinf(gb[0])  # the dead row


def test_min_ber_ties_take_the_first_offset():
    db, lens = _catalog(8, 9, 128)
    q_pad = np.zeros(64, np.uint32)
    q_pad[:12] = 0xAAAAAAAA
    (wb, wo), (gb, go) = _both(db, lens, q_pad, 12)
    assert np.array_equal(wb.view(np.int32), gb.view(np.int32)) and np.array_equal(wo, go)
    assert go[3] == 0 and gb[3] == 0.0  # the periodic row: every offset ties at 0
    q_pad[:12] = np.tile(np.array([3, 4, 1, 2], np.uint32), 3)
    (wb, wo), (gb, go) = _both(db, lens, q_pad, 12)
    assert np.array_equal(wo, go) and go[4] == 2  # the first exact match


def test_min_ber_query_longer_than_rows():
    db, lens = _catalog(9, 6, 64)
    q_pad = np.arange(64, dtype=np.uint32)
    (wb, wo), (gb, go) = _both(db, lens, q_pad, 64)
    assert np.array_equal(wo, go)
    assert np.array_equal(wb.view(np.int32), gb.view(np.int32))
    assert all(o == -1 for o, n in zip(go, lens) if n < 64)


def test_min_ber_host_wrapper_equal():
    rng = np.random.default_rng(10)
    for t, q in ((100, 60), (2000, 359), (5, 9), (64, 64), (1, 1)):
        stream = rng.integers(0, 2**32, t, dtype=np.uint64).astype(np.uint32)
        query = stream[t // 3:t // 3 + q].copy() if q <= t - t // 3 else \
            rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
        assert th.min_ber(stream, query, device="cpu") == jh.min_ber(stream, query)


def test_min_ber_checks_its_inputs():
    db = torch.zeros((2, 64), dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        th.min_ber_batch(db, lens, torch.zeros(128, dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        th.min_ber_batch(db, lens, torch.zeros(64, dtype=torch.int32), 65)
    with pytest.raises(ValueError):
        th.min_ber_batch(db.long(), lens, torch.zeros(64, dtype=torch.int32), 1)
