"""The port's image fingerprints against the committed conformance goldens.

Every image/* key of tests/test_conformance.build_corpus except the
float encoder family (image/semantic/*) is recomputed through
ucfp_tpu_torch.modality.image on the CPU and must equal the digest in
tests/goldens/conformance.json exactly.
"""

import json
import pathlib

import pytest

from test_conformance import d, fixed_png
from ucfp_tpu_torch.modality import image as timod

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "goldens" / "conformance.json").read_text()
)

CASES = [(seed, w, h) for seed, w, h in ((10, 64, 64), (11, 100, 37), (12, 256, 256))]


@pytest.mark.parametrize("seed,w,h", CASES)
def test_multi(seed, w, h):
    png = fixed_png(seed, w, h)
    fp = timod.fingerprint_multi(png, 0, 1, device="cpu").fingerprint
    assert d(fp) == GOLDEN[f"image/multi/{w}x{h}"]


@pytest.mark.parametrize("algo", ["phash", "dhash", "ahash"])
@pytest.mark.parametrize("seed,w,h", CASES)
def test_single(seed, w, h, algo):
    png = fixed_png(seed, w, h)
    fp = timod.fingerprint_single(png, algo, 0, 1, device="cpu").fingerprint
    assert d(fp) == GOLDEN[f"image/{algo}/{w}x{h}"]


def test_multi_tall_thin():
    fp = timod.fingerprint_multi(fixed_png(13, 48, 640), 0, 1,
                                 device="cpu").fingerprint
    assert d(fp) == GOLDEN["image/multi/48x640"]


def test_every_non_semantic_image_key_is_covered():
    covered = {f"image/multi/{w}x{h}" for _, w, h in CASES}
    covered |= {f"image/{a}/{w}x{h}" for _, w, h in CASES
                for a in ("phash", "dhash", "ahash")}
    covered.add("image/multi/48x640")
    want = {k for k in GOLDEN
            if k.startswith("image/") and not k.startswith("image/semantic/")}
    assert covered == want


def test_batch_matches_single():
    import numpy as np

    rgbs = np.stack([timod.decode_rgb(fixed_png(s, 64, 64), timod.PreprocessConfig())
                     for s in (10, 21, 22)])
    recs = timod.fingerprint_batch(rgbs, [0, 0, 0], [1, 2, 3], device="cpu")
    assert d(recs[0].fingerprint) == GOLDEN["image/multi/64x64"]
    for s, r in zip((10, 21, 22), recs):
        one = timod.fingerprint_multi(fixed_png(s, 64, 64), 0, 1, device="cpu")
        assert one.fingerprint == r.fingerprint
