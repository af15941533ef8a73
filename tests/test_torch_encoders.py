"""The port's stand-in encoders (models/encoders.py, models/jaxrand.py)
and local-weights encoders (models/hf_local.py) against ucfp_tpu.

  * threefry bits, split keys and uniforms: bit-equal to jax.random;
  * the normals: bit-equal too (the stated bound is 0 ulp), and so are
    the four stand-in weight matrices;
  * StandinMLP.from_jax_params and the default weights give the same
    module output;
  * image and neural embeddings at cosine >= 0.999999 against ucfp_tpu
    (PARITY.md's bar for the float families);
  * hf_local on tiny random transformers models saved under tmp_path
    (nothing is downloaded): the same embeddings as ucfp_tpu's hf_local.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_conformance import fixed_audio, fixed_png

from ucfp_tpu.models import encoders as renc
from ucfp_tpu.models import hf_local as rhf
from ucfp_tpu_torch.models import encoders as tenc
from ucfp_tpu_torch.models import hf_local as thf
from ucfp_tpu_torch.models import jaxrand

KEYS = [0, 1, 0x1A6E, 0xA0D10, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5), (64, 33)]


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _jkey(k):
    return jnp.asarray(np.array(k, np.uint32))


@pytest.fixture(autouse=True, scope="module")
def _reference_weights_outside_jit():
    """The reference draws its weights lazily inside its jitted forward;
    drawing them once outside jit caches concrete arrays, so any input
    shape can follow."""
    for fn in (renc._image_params, renc._audio_params):
        fn.cache_clear()
        fn()


@pytest.mark.parametrize("seed", KEYS)
def test_keys_and_bits_bit_equal(seed):
    key = jaxrand.prng_key(seed)
    assert _u32(key).tolist() == _u32(jax.random.PRNGKey(seed)).tolist()
    for num in (2, 3):
        mine = jaxrand.split(key, num)
        ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        assert [list(map(int, k)) for k in mine] == ref.tolist()
    for shape in SHAPES:
        ref = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
        assert np.array_equal(jaxrand.random_bits32(key, shape), np.asarray(ref))


@pytest.mark.parametrize("seed", KEYS)
def test_uniform_and_normal_bit_equal(seed):
    key = jaxrand.split(jaxrand.prng_key(seed), 2)[1]
    jk = _jkey(key)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for shape in SHAPES + [(512, 300)]:
        u = jaxrand.uniform(key, shape, lo, 1.0)
        ref = jax.random.uniform(jk, shape, jnp.float32, lo, 1.0)
        assert np.array_equal(_u32(u), _u32(ref))
        n = jaxrand.normal(key, shape)
        ref = jax.random.normal(jk, shape, jnp.float32)
        # the stated bound: 0 ulp, every entry
        assert np.array_equal(_u32(n), _u32(ref))


def test_erf_inv_edges_bit_equal():
    x = np.array([0.0, -0.0, 1e-30, -1e-7, 0.5, -0.5, 0.41421354, 0.9,
                  0.99999994, -0.99999994, 1.0, -1.0], np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.array_equal(_u32(jaxrand.erf_inv_f32(x)), _u32(ref))
    y = np.linspace(-0.999, 10.0, 4001, dtype=np.float32)
    assert np.array_equal(_u32(jaxrand.log1p_f32(y)),
                          _u32(jax.lax.log1p(jnp.asarray(y))))


def test_standin_weights_bit_equal():
    for mine, ref in ((tenc.image_params(), renc._image_params()),
                      (tenc.audio_params(), renc._audio_params())):
        for a, b in zip(mine, ref):
            assert a.shape == b.shape and a.dtype == np.float32
            assert np.array_equal(_u32(a), _u32(b))


def test_from_jax_params_equals_default_module():
    w1, w2 = renc._audio_params()
    m = tenc.StandinMLP.from_jax_params(w1, w2)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 6144)).astype(np.float32))
    with torch.no_grad():
        a = m(x)
        b = tenc.StandinMLP(*tenc.audio_params())(x)
    assert torch.equal(a, b)
    assert torch.allclose(a.norm(dim=1), torch.ones(5), atol=1e-6)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def test_encoder_outputs_match_reference():
    rng = np.random.default_rng(1)
    x = rng.random((9, 3072), np.float32)
    assert _cos_rows(tenc.image_encode(x, "cpu"), renc.image_encode(x)).min() >= 0.999999
    w = rng.normal(size=(4, 6144)).astype(np.float32)
    assert _cos_rows(tenc.audio_logmel_encode(w, "cpu"),
                     renc.audio_logmel_encode(w)).min() >= 0.999999
    # an all-zero row keeps the 1e-9 norm floor: zeros, not NaN
    z = tenc.image_encode(np.zeros((1, 3072), np.float32), "cpu")
    assert np.isfinite(z).all()


def test_image_semantic_and_audio_neural_goldens_by_cosine():
    from ucfp_tpu.modality import audio as raudio
    from ucfp_tpu.modality import image as rimage
    from ucfp_tpu_torch.modality import audio as taudio
    from ucfp_tpu_torch.modality import image as timage

    a = timage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 1, device="cpu")
    b = rimage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 1)
    assert _cos_rows(a.embedding, b.embedding) >= 0.999999
    x = fixed_audio()
    a = taudio.fingerprint_neural(x, 8000, 0, 1, device="cpu")
    b = raudio.fingerprint_neural(x, 8000, 0, 1)
    ea = np.frombuffer(a.fingerprint, "<f4").reshape(-1, 128)
    eb = np.frombuffer(b.fingerprint, "<f4").reshape(-1, 128)
    assert ea.shape == eb.shape and _cos_rows(ea, eb).min() >= 0.999999
    assert a.model_id == b.model_id == tenc.AUDIO_MODEL_ID
    assert a.config_hash == b.config_hash


def test_text_hash_embed_equal():
    toks = "the quick brown fox jumps over the lazy dog".split()
    assert np.array_equal(tenc.text_hash_embed(toks), renc.text_hash_embed(toks))
    with pytest.raises(ValueError):
        tenc.text_hash_embed([])


# -- hf_local on tiny random models --------------------------------------------


@pytest.fixture(autouse=True)
def _fresh_hf_cache():
    thf.reset_cache()
    rhf.reset_cache()
    yield
    thf.reset_cache()
    rhf.reset_cache()


@pytest.fixture()
def tiny_models(tmp_path):
    from transformers import (BertConfig, BertModel, BertTokenizerFast, ViTConfig,
                              ViTImageProcessor, ViTModel, Wav2Vec2Config,
                              Wav2Vec2FeatureExtractor, Wav2Vec2Model)

    root = tmp_path / "models"
    torch.manual_seed(0)
    d = root / "text"
    d.mkdir(parents=True)
    BertModel(BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=64)).save_pretrained(d)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
    (d / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt")).save_pretrained(d)
    d = root / "image"
    d.mkdir()
    ViTModel(ViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                       intermediate_size=64, image_size=32,
                       patch_size=16)).save_pretrained(d)
    ViTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(d)
    d = root / "audio"
    d.mkdir()
    Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16, 16), conv_stride=(5, 2),
        conv_kernel=(10, 3), num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    )).save_pretrained(d)
    Wav2Vec2FeatureExtractor(sampling_rate=16000).save_pretrained(d)
    return root


def test_hf_local_matches_reference(tiny_models, monkeypatch):
    monkeypatch.setenv("UCFP_MODEL_DIR", str(tiny_models))
    from ucfp_tpu.modality import audio as raudio
    from ucfp_tpu.modality import image as rimage
    from ucfp_tpu.modality import text as rtext
    from ucfp_tpu_torch.modality import audio as taudio
    from ucfp_tpu_torch.modality import image as timage
    from ucfp_tpu_torch.modality import text as ttext

    pairs = [
        (ttext.fingerprint_semantic("the quick brown fox", 0, 1, device="cpu"),
         rtext.fingerprint_semantic("the quick brown fox", 0, 1)),
        (timage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 1, device="cpu"),
         rimage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 1)),
        (taudio.fingerprint_neural(fixed_audio(), 8000, 0, 1, device="cpu"),
         raudio.fingerprint_neural(fixed_audio(), 8000, 0, 1)),
    ]
    for a, b in pairs:
        assert a.model_id == b.model_id and not a.model_id.startswith("standin-")
        assert a.config_hash == b.config_hash
        ea = np.frombuffer(a.fingerprint, "<f4").reshape(-1, 32)
        eb = np.frombuffer(b.fingerprint, "<f4").reshape(-1, 32)
        assert ea.shape == eb.shape and _cos_rows(ea, eb).min() >= 0.999999
    with pytest.raises(Exception, match="not loaded"):
        timage.fingerprint_semantic(fixed_png(10, 64, 64), 0, 1,
                                    model_id="clip-vit-b32", device="cpu")
