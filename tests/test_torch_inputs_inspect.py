"""The port's inputs cache and the three inspectors against the
reference's (test_torch_auth_keys.ProdServers: each package's own
state_from_env, the same requests, equal statuses and JSON bodies).

Masked, as random: `input_id` (seeded from time_ns); each side uses its
own id for the follow-up requests.

Tolerance: none. The inspectors' JSON is equal byte for byte: the image
stages are exact integer code, and the audio inspector's spectrogram,
peaks and landmarks are the exact integer STFT; the port takes the mel
grid's products in float64 on the host (rounded to float32), and the
mel PNG it renders equals the reference's on these inputs, at 8 kHz and
at 44.1 kHz.
"""

import numpy as np
import pytest

from test_conformance import LONG_TEXT, PANGRAM, fixed_audio, fixed_png
from test_torch_auth_keys import Pair, ProdServers, _env  # noqa: F401 (autouse fixture)

ID_MASK = ((rb'in_[0-9a-f]{8,}', b'in_?'),)


def put(s, path, body, query=None, token=None):
    kw = {"token": token} if token is not None else {}
    st, res, ids = s.pair("POST", path, body, query, field="input_id", masks=ID_MASK, **kw)
    assert st == 201 and res["bytes"] == len(body), res
    return ids


def test_inputs_put_use_delete(tmp_path, monkeypatch):
    """An input put once serves ?input_id= on the ingest routes and the
    inspectors (its cached sample rate too), answers 404 once deleted,
    and stays inside its tenant."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        txt = put(s, "/v1/inputs/0", LONG_TEXT.encode(), {})
        img = put(s, "/v1/inputs/0", fixed_png(11, 100, 37))
        wav = put(s, "/v1/inputs/0", fixed_audio(3.0, 8000).tobytes(), {"sample_rate": "8000"})
        for path, ids, q in (
                ("/v1/ingest/text/0/1", txt, {}),
                ("/v1/ingest/text/0/2", txt, {"algorithm": "simhash-tf"}),
                ("/v1/ingest/image/0/3", img, {}),
                ("/v1/ingest/image/0/4", img, {"algorithm": "dhash"}),
                ("/v1/ingest/audio/0/5", wav, {}),
                ("/v1/pipeline/inspect/text", txt, {}),
                ("/v1/pipeline/inspect/image/0", img, {}),
                ("/v1/pipeline/inspect/audio", wav, {"algorithm": "panako"})):
            st, res = s.call("POST", path, b"ignored", {**q, "input_id": ids})
            assert st in (200, 201), (path, res)
        assert s.call("GET", "/v1/records/0/5")[1]["algorithm"] == "audiofp-wang-v1"
        # another tenant's key cannot see or use tenant 0's inputs
        _, _, tok9 = s.pair("POST", "/v1/admin/keys", {"tenant_id": 9})
        assert s.call("POST", "/v1/ingest/text/9/1", b"x", {"input_id": txt},
                      token=tok9, masks=ID_MASK)[0] == 404
        assert s.call("DELETE", "/v1/inputs/0/x", token=tok9)[0] == 403
        own = put(s, "/v1/inputs", b"tenant nine text body for the cache", token=tok9)
        assert s.call("POST", "/v1/ingest/text/9/2", b"", {"input_id": own},
                      token=tok9)[0] == 201
        # delete, then the id is gone everywhere
        st, res = s.call("DELETE", "/v1/inputs/0/in_0")
        assert (st, res["error"]) == (404, "input_not_found")
        for ids in (txt, img, wav):
            path = Pair("/v1/inputs/0/" + ids.j, "/v1/inputs/0/" + ids.t)
            assert s.call("DELETE", path) == (200, {"deleted": 1})
            assert s.call("DELETE", path)[0] == 404
        st, res = s.call("POST", "/v1/ingest/text/0/9", b"", {"input_id": txt},
                         masks=ID_MASK)
        assert (st, res["error"]) == (404, "input_not_found")
        assert s.call("POST", "/v1/pipeline/inspect/audio", b"", {"input_id": wav},
                      masks=ID_MASK)[0] == 404
        assert s.call("POST", "/v1/inputs/x", b"abc")[0] == 400
    finally:
        s.close()


def test_inspect_text(tmp_path, monkeypatch):
    """The text inspector for every algorithm selector (simhash-idf with
    the stored corpus' IDF), in both route shapes, and its errors."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        for rid, text in enumerate((PANGRAM, LONG_TEXT, "fox fox dog"), 1):
            assert s.call("POST", f"/v1/ingest/text/3/{rid}", text.encode())[0] == 201
        for algo in ("minhash", "simhash-tf", "simhash-idf", "tlsh", "lsh", "other"):
            st, res = s.call("POST", "/v1/pipeline/inspect/text/3", LONG_TEXT.encode(),
                             {"algorithm": algo})
            assert st == 200, (algo, res)
        st, res = s.call("POST", "/v1/pipeline/inspect/text", PANGRAM.encode(),
                         {"tenant_id": "3", "tokenizer": "grapheme", "k": "3"})
        assert st == 200 and res["tokens"]
        assert s.call("POST", "/v1/pipeline/inspect/text", b"\xff\xfe")[0] == 400
        assert s.call("POST", "/v1/pipeline/inspect/text", b"x", {"tenant_id": "q"})[0] == 400
        assert s.call("POST", "/v1/pipeline/inspect/text/x", b"x")[0] == 400
    finally:
        s.close()


def test_inspect_image(tmp_path, monkeypatch):
    """The image inspector: stage thumbnails, the aHash mean and the
    multi bundle (hashed on the backend's device), small and camera-size
    inputs (the latter past the 256 px thumbnail edge), and the errors."""
    s = ProdServers(tmp_path, monkeypatch)
    try:
        for png in (fixed_png(10, 64, 64), fixed_png(13, 48, 640), fixed_png(12, 300, 300)):
            st, res = s.call("POST", "/v1/pipeline/inspect/image", png)
            assert st == 200 and res["fingerprint_bytes"] == 536
        st, res = s.call("POST", "/v1/ingest/image/0/1", fixed_png(12, 300, 300))
        ins = s.call("POST", "/v1/pipeline/inspect/image", fixed_png(12, 300, 300))[1]
        assert ins["fingerprint_hex"] == res["fingerprint_hex"]
        assert s.call("POST", "/v1/pipeline/inspect/image", b"not an image")[0] == 400
        assert s.call("POST", "/v1/pipeline/inspect/image/7", b"x", token="nope")[0] == 401
    finally:
        s.close()


@pytest.mark.parametrize("sr,secs", [(8000, 3.0), (44100, 2.0)])
def test_inspect_audio(tmp_path, monkeypatch, sr, secs):
    """The audio inspector's JSON for wang, panako and haitsma at 8 kHz
    and 44.1 kHz (wang and panako resampled to the canonical rate), s16
    bodies, and the errors; the port's neural selector returns the
    neural record's fingerprint."""
    s = ProdServers(tmp_path, monkeypatch)
    x = fixed_audio(secs, sr)
    try:
        for algo in ("wang", "panako", "haitsma"):
            st, res = s.call("POST", "/v1/pipeline/inspect/audio", x.tobytes(),
                             {"sample_rate": str(sr), "algorithm": algo})
            assert st == 200 and res["total_peaks"] > 0, (algo, res)
        s16 = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2").tobytes()
        assert s.call("POST", "/v1/pipeline/inspect/audio/0", s16,
                      {"sample_rate": str(sr), "encoding": "s16"})[0] == 200
        assert s.call("POST", "/v1/pipeline/inspect/audio", x.tobytes())[0] == 400
        assert s.call("POST", "/v1/pipeline/inspect/audio", x.tobytes(),
                      {"sample_rate": str(sr), "algorithm": "nope"})[0] == 400
        assert s.call("POST", "/v1/pipeline/inspect/audio", b"abc",
                      {"sample_rate": str(sr)})[0] == 400
    finally:
        s.close()
    if sr == 8000:
        from ucfp_tpu_torch.modality import audio as amod

        ins = amod.inspect_audio(x, sr, "neural", device="cpu")
        rec = amod.fingerprint_neural(x, sr, 0, 0, "cpu")
        assert ins["fingerprint_hex"] == rec.fingerprint.hex()[:4096]
        assert ins["algorithm"] == "audiofp-neural-v1"
