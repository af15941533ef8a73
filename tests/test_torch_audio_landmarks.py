"""The port's peak picker and landmark hashing
(ucfp_tpu_torch.ops.audio.constellation) against ucfp_tpu's on the CPU.

Tolerance: bit-equal. Peak positions, validity, hashes and times are
integers; the float32 spectrogram the picker compares is the exact
integer one converted once (round to nearest even), so the comparisons,
exact ties included, see the same values in both packages.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import enable_x64

from ucfp_tpu.ops.audio import constellation as jc
from ucfp_tpu.ops.audio import dsp as jdsp
from ucfp_tpu_torch.ops.audio import constellation as tc
from ucfp_tpu_torch.ops.audio import dsp as tdsp

SR = 8000
SLAB = SR // 256


def _tones(secs: float = 2.0) -> np.ndarray:
    t = np.arange(int(secs * SR)) / SR
    x = (0.4 * np.sin(2 * math.pi * 440 * t)
         + 0.25 * np.sin(2 * math.pi * 1200 * t) * (np.sin(2 * math.pi * 0.7 * t) > 0)
         + 0.1 * np.sin(2 * math.pi * 2500 * t) * (t > 1.0))
    return x.astype(np.float32)


def _plateau(secs: float = 3.0) -> np.ndarray:
    """Two tones on exact bins whose phase advances a whole turn per hop
    (bins 64 and 128 at n_fft 1024, hop 256): every interior frame is the
    same integer spectrum, so each slab holds 31 equal peaks on the louder
    ridge and the 30th and 31st largest candidates tie."""
    n = np.arange(16)  # one period of both tones, tiled exactly
    period = (0.4 * np.sin(2 * math.pi * 64 * n / 1024)
              + 0.2 * np.sin(2 * math.pi * 128 * n / 1024)).astype(np.float32)
    return np.tile(period, int(secs * SR) // 16)


def _noise(secs: float = 2.0) -> np.ndarray:
    return np.random.default_rng(11).normal(0, 0.2, int(secs * SR)).astype(np.float32)


CLIPS = {"tones": _tones, "plateau": _plateau, "noise": _noise}


def _power(x):
    q = jdsp.quantize_samples_i16(x)
    with enable_x64():
        ref = jdsp.stft_power_int(jnp.asarray(q), 1024, 256, True).astype(jnp.float32)
    got = tdsp.stft_power_int(torch.from_numpy(q), 1024, 256, True).to(torch.float32)
    assert np.array_equal(np.asarray(ref), got.numpy())
    return ref, got


def _peaks(name, local_floor):
    ref, got = _power(CLIPS[name]())
    want = [np.asarray(a) for a in jc.pick_peaks(ref, SLAB, 30, -50.0, local_floor)]
    have = [a.numpy() for a in tc.pick_peaks(got, SLAB, 30, -50.0, local_floor)]
    return want, have, got


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("local_floor", [False, True])
def test_pick_peaks_bit_equal(name, local_floor):
    want, have, _ = _peaks(name, local_floor)
    for w, h in zip(want, have):
        assert np.array_equal(w, h)


def test_plateau_ties_at_the_cap_go_to_the_lower_index():
    want, have, power = _peaks("plateau", False)
    t, f, valid = have
    slab = 1  # an interior slab: frames 31..61
    ridge = power[slab * SLAB:(slab + 1) * SLAB, 64]
    assert bool((ridge == ridge[0]).all())  # 31 equal peaks in the slab
    sel = t[slab * 30:(slab + 1) * 30][valid[slab * 30:(slab + 1) * 30]]
    # the cap keeps the first 30 frames of the ridge, as lax.top_k does
    assert sel.tolist() == list(range(slab * SLAB, slab * SLAB + 30))
    assert np.array_equal(want[0], t)


def _pairs_args(name):
    _want, (t, f, v), _ = _peaks(name, False)
    return (jnp.asarray(t), jnp.asarray(f), jnp.asarray(v)), tuple(
        torch.from_numpy(a) for a in (t, f, v))


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("zone", [(10, 63, 64), (4, 32, 32)])
def test_wang_pairs_bit_equal(name, zone):
    jargs, targs = _pairs_args(name)
    want = [np.asarray(a) for a in jc.wang_pairs(*jargs, *zone)]
    have = [a.numpy() for a in tc.wang_pairs(*targs, *zone)]
    assert np.array_equal(want[2], have[2]) and want[2].any()
    for w, h in zip(want[:2], have[:2]):
        assert np.array_equal(w.astype(np.int64), h)


@pytest.mark.parametrize("name", sorted(CLIPS))
@pytest.mark.parametrize("zone", [(5, 96, 96), (2, 40, 50)])
def test_panako_triplets_bit_equal(name, zone):
    jargs, targs = _pairs_args(name)
    want = [np.asarray(a) for a in jc.panako_triplets(*jargs, *zone)]
    have = [a.numpy() for a in tc.panako_triplets(*targs, *zone)]
    assert np.array_equal(want[2], have[2])
    for w, h in zip(want[:2], have[:2]):
        assert np.array_equal(w.astype(np.int64), h)


@pytest.mark.parametrize("lf", [False, True])
def test_extract_landmarks_and_panako_equal(lf):
    for x in (_tones(), _plateau(2.0)):
        a = jc.extract_landmarks(x, SR, jc.WangConfig(local_floor=lf))
        b = tc.extract_landmarks(x, SR, tc.WangConfig(local_floor=lf), device="cpu")
        assert all(np.array_equal(u, v) and v.dtype == np.uint32 for u, v in zip(a, b))
        a = jc.extract_panako(x, SR, jc.PanakoConfig())
        b = tc.extract_panako(x, SR, tc.PanakoConfig(), device="cpu")
        assert all(np.array_equal(u, v) and v.dtype == np.uint32 for u, v in zip(a, b))


def test_batch_forms_equal_single():
    stack = np.stack([_tones(), _plateau(2.0), _noise(), _tones()[::-1].copy()])
    ref, _ = _power(stack[0])
    powers = tdsp.stft_power_int(
        torch.from_numpy(jdsp.quantize_samples_i16(stack)), 1024, 256, True).float()
    bt, bf, bv = tc.pick_peaks(powers, SLAB, 30, -50.0, True)
    for i in range(len(stack)):
        st, sf, sv = tc.pick_peaks(powers[i], SLAB, 30, -50.0, True)
        assert torch.equal(bt[i], st) and torch.equal(bf[i], sf) and torch.equal(bv[i], sv)
        for fn, zone in ((tc.wang_pairs, (10, 63, 64)), (tc.panako_triplets, (5, 96, 96))):
            batch = fn(bt, bf, bv, *zone)
            one = fn(st, sf, sv, *zone)
            assert all(torch.equal(b[i], o) for b, o in zip(batch, one))
    wang = tc.extract_landmarks_batch(stack, SR, tc.WangConfig(), device="cpu")
    pan = tc.extract_panako_batch(stack, SR, tc.PanakoConfig(), device="cpu")
    for i in range(len(stack)):
        for got, fn, cfg in ((wang, jc.extract_landmarks, jc.WangConfig()),
                             (pan, jc.extract_panako, jc.PanakoConfig())):
            want = fn(stack[i], SR, cfg)
            assert all(np.array_equal(u, v) for u, v in zip(want, got[i]))
