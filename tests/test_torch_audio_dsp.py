"""The port's audio spectrograms (ucfp_tpu_torch.ops.audio.dsp / intfft)
against ucfp_tpu's on the CPU.

Tolerance: bit-equal for every integer function (stft_power_int,
stft_power_int_fft, the quantizer, the host tables): the whole
fingerprint path is integer arithmetic. The float inspect-path
spectrogram (stft_power, mel_spectrogram), which feeds no fingerprint,
is held at rtol 1e-5: two float32 products of the same length sum in
another order in the two libraries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import enable_x64

from ucfp_tpu.ops.audio import dsp as jdsp
from ucfp_tpu.ops.audio import intfft as jfft
from ucfp_tpu_torch.ops import knn
from ucfp_tpu_torch.ops.audio import dsp as tdsp
from ucfp_tpu_torch.ops.audio import intfft as tfft


def _clip(seed: int, n: int, specials: bool = False) -> np.ndarray:
    x = np.random.default_rng(seed).normal(0, 0.3, n).astype(np.float32)
    if specials:
        x[3], x[4], x[5] = np.nan, np.inf, -np.inf
        x[6], x[7] = 1.5, -2.0
        # half-to-even boundaries: k + 0.5 quanta after the scale
        for i, k in enumerate((0, 1, 2, 101, -7, 8190)):
            x[10 + i] = np.float32((k + 0.5) / 16383.0)
    return x


def _ref_stft(x, n_fft, hop, center, shift):
    with enable_x64():
        return np.asarray(jdsp.stft_power_int(jnp.asarray(x), n_fft, hop, center, shift))


@pytest.mark.parametrize("form", ["f32", "i16"])
@pytest.mark.parametrize("n_fft,hop,shift", [(1024, 256, 8), (2048, 64, 14)])
@pytest.mark.parametrize("center", [True, False])
def test_stft_power_int_bit_equal(form, n_fft, hop, shift, center):
    x = _clip(1, 9000, specials=True)
    inp = x if form == "f32" else jdsp.quantize_samples_i16(x)
    got = tdsp.stft_power_int(torch.from_numpy(inp), n_fft, hop, center, shift)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), _ref_stft(inp, n_fft, hop, center, shift))


@pytest.mark.parametrize("n", [1, 2, 300, 512, 513, 1500])
def test_short_clips_reflect_like_numpy(n):
    """Centre padding of clips shorter than the half frame reflects back
    and forth, as numpy's (and jnp's) mode="reflect" does."""
    x = _clip(2, n)
    got = tdsp.reflect_pad(torch.from_numpy(x), 512).numpy()
    assert np.array_equal(got, np.pad(x, (512, 512), mode="reflect"))
    q = jdsp.quantize_samples_i16(x)
    assert np.array_equal(tdsp.stft_power_int(torch.from_numpy(q)).numpy(),
                          _ref_stft(q, 1024, 256, True, 8))


def test_stft_power_int_batch_rows_equal_single():
    stack = np.stack([_clip(s, 4000) for s in (3, 4, 5)])
    q = jdsp.quantize_samples_i16(stack)
    batch = tdsp.stft_power_int(torch.from_numpy(q), 2048, 64, False, 14)
    for i in range(3):
        one = tdsp.stft_power_int(torch.from_numpy(q[i].copy()), 2048, 64, False, 14)
        assert torch.equal(batch[i], one)


def test_quantizer_and_host_tables_equal():
    x = _clip(6, 5000, specials=True)
    assert np.array_equal(tdsp.quantize_samples_i16(x), jdsp.quantize_samples_i16(x))
    s16 = np.random.default_rng(6).integers(-32768, 32768, 5000).astype(np.int16)
    assert np.array_equal(tdsp.quantize_samples_i16(s16), jdsp.quantize_samples_i16(s16))
    # the device quantizer of float input equals the host's
    dq = tdsp.quantize_device(torch.from_numpy(x)).numpy()
    assert np.array_equal(dq, jdsp.quantize_samples_i16(x).astype(np.int32))
    for n_fft in (1024, 2048):
        for a, b in zip(tdsp.dft_basis_int_limbs(n_fft), jdsp.dft_basis_int_limbs(n_fft)):
            assert np.array_equal(a, b)
    assert np.array_equal(tdsp.mel_filterbank(64, 1024, 8000, 0.0, 4000.0),
                          jdsp.mel_filterbank(64, 1024, 8000, 0.0, 4000.0))
    y = _clip(6, 5000)
    for sr_in, sr_out in ((44100, 5000), (16000, 8000), (8000, 8000)):
        assert np.array_equal(tdsp.resample_linear(y, sr_in, sr_out),
                              jdsp.resample_linear(y, sr_in, sr_out))


def test_i8_matmul_exact_on_cpu():
    """The spectrogram's int8 product (ops.knn.int8_dots) at the extremes of
    its limbs, and the combined basis padded with zero rows to 2,056 /
    4,104 (a multiple of 8) that change no dot."""
    rng = np.random.default_rng(7)
    a = rng.integers(-128, 128, (19, 2048)).astype(np.int8)
    a[0] = -128
    b = rng.integers(-128, 128, (24, 2048)).astype(np.int8)
    b[0] = -128
    got = knn.int8_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)
    for n_fft, width in ((1024, 2056), (2048, 4104)):
        cols = tdsp._basis_cols(n_fft)
        basis = jdsp.dft_basis_int_combined(n_fft)
        assert cols.shape == (width, n_fft)
        assert np.array_equal(cols[:basis.shape[1]], basis.T)
        assert not cols[basis.shape[1]:].any()


def _ref_fft(x, center=False):
    with enable_x64():
        return np.asarray(jfft.stft_power_int_fft(jnp.asarray(x), 2048, 64, center))


@pytest.mark.parametrize("form", ["f32", "i16", "quiet"])
@pytest.mark.parametrize("center", [False, True])
def test_stft_power_int_fft_bit_equal(form, center):
    """Against the JAX function and the reference's plain-int64 mirror; a
    quiet clip takes a smaller block exponent."""
    x = _clip(8, 7000, specials=form != "quiet")
    inp = {"f32": x, "i16": jdsp.quantize_samples_i16(x), "quiet": x * 0.002}[form]
    got = tfft.stft_power_int_fft(torch.from_numpy(inp), 2048, 64, center).numpy()
    assert np.array_equal(got, _ref_fft(inp, center))
    assert np.array_equal(got, jfft.stft_power_int_fft_mirror(inp, 2048, 64, center))


def test_stft_power_int_fft_batch_keeps_each_clips_exponent():
    x = _clip(9, 6000)
    stack = jdsp.quantize_samples_i16(np.stack([x, x * 0.003, x[::-1] * 0.5]))
    batch = tfft.stft_power_int_fft(torch.from_numpy(stack))
    for i in range(3):
        assert np.array_equal(batch[i].numpy(), _ref_fft(stack[i]))


def test_float_spectrogram_and_mel_close():
    """rtol 1e-5 (float32 sums in another order, see the module doc)."""
    x = _clip(10, 6000)
    want = np.array(jdsp.stft_power(jnp.asarray(x), 1024, 256, True))
    got = tdsp.stft_power(torch.from_numpy(x), 1024, 256, True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
    mel_want = np.asarray(jdsp.mel_spectrogram(jnp.asarray(want), 64, 1024, 8000))
    mel_got = tdsp.mel_spectrogram(torch.from_numpy(want), 64, 1024, 8000).numpy()
    np.testing.assert_allclose(mel_got, mel_want, rtol=1e-5, atol=1e-5 * mel_want.max())
