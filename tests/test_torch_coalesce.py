"""Cross-request ingest coalescing (UCFP_INGEST_COALESCE_MS) in the port
against ucfp_tpu's (tests/test_server.py's coalescing tests, mirrored).

Two concurrent bulk image requests go to the port's app with coalescing
on and off, under the pow2 and the max pad; every fingerprint must be the
same, and equal to the reference's for the same bodies. Pad rows change
no fingerprint (_hash_single_rows with and without pad_to), and
/v1/info reports the reference's two counters.
"""

import asyncio
import io
import json
import struct

import numpy as np
import pytest

from test_imagehash import synthetic_png
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu.server.app import ServerState as JState
from ucfp_tpu.server.app import build_server as j_build
from ucfp_tpu.server.auth import StaticSingleKey as JKey
from ucfp_tpu.server.http import Request as JRequest
from ucfp_tpu.server.inputs_cache import InputsCache as JInputs
from ucfp_tpu.server.ratelimit import NoopRateLimiter as JNoopRL
from ucfp_tpu.server.usage import NoopUsageSink as JNoopSink
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.server import handlers as th
from ucfp_tpu_torch.server.app import ServerState, build_server
from ucfp_tpu_torch.server.auth import StaticSingleKey
from ucfp_tpu_torch.server.http import Request
from ucfp_tpu_torch.server.inputs_cache import InputsCache
from ucfp_tpu_torch.server.ratelimit import NoopRateLimiter
from ucfp_tpu_torch.server.usage import NoopUsageSink

TOKEN = "t"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("UCFP_INGEST_COALESCE_MS", "UCFP_INGEST_COALESCE_ROWS", "UCFP_INGEST_PAD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("UCFP_SHARD", "off")


def _frames(pairs):
    return b"".join(struct.pack("<QI", rid, len(img)) + img for rid, img in pairs)


def _bmp(seed, w=48, h=40):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="BMP")
    return buf.getvalue()


# (first body, second body): mixed-size PNGs take the per-image decode,
# uniform BMPs the whole-batch native decode
BODIES = {
    "png": (_frames([(1, synthetic_png(64, 64)), (2, synthetic_png(32, 32))]),
            _frames([(3, synthetic_png(64, 64)), (4, synthetic_png(48, 48))])),
    "bmp": (_frames([(10 + i, _bmp(i)) for i in range(5)]),
            _frames([(20 + i, _bmp(20 + i)) for i in range(3)])),
}


class _Apps:
    def __init__(self, path, reference=False):
        if reference:
            self.index = JBackend(str(path))
            self.app = j_build(JState(index=self.index, api_keys=JKey(TOKEN),
                                      rate_limit=JNoopRL(), usage=JNoopSink(),
                                      inputs=JInputs()), timeout_secs=120.0)
            self.req = JRequest
        else:
            self.index = EmbeddedBackend(str(path), device="cpu")
            self.app = build_server(ServerState(
                index=self.index, api_keys=StaticSingleKey(TOKEN),
                rate_limit=NoopRateLimiter(), usage=NoopUsageSink(),
                inputs=InputsCache()), timeout_secs=120.0)
            self.req = Request

    def _request(self, method, path, body=b"", query=None):
        h = {"authorization": f"Bearer {TOKEN}", "content-length": str(len(body))}
        return self.req(method, path, dict(query or {}), h, body)

    def ingest_pair(self, kind, algorithm="phash"):
        """Both bodies at once -> {record_id: fingerprint_hex}."""
        f1, f2 = BODIES[kind]

        async def go():
            return await asyncio.gather(*(
                self.app.handle_request(self._request(
                    "POST", "/v1/ingest/image/batch/0", f, {"algorithm": algorithm}))
                for f in (f1, f2)))

        out = {}
        for resp, _ in asyncio.run(go()):
            assert resp.status == 201, resp.body
            for rec in json.loads(resp.body)["records"]:
                out[rec["record_id"]] = rec["fingerprint_hex"]
        return out

    def info(self):
        resp, _ = asyncio.run(self.app.handle_request(self._request("GET", "/v1/info")))
        return json.loads(resp.body)

    def handlers(self):
        return self.app.router.match("POST", "/v1/ingest/image/batch/0")[0].__self__

    def close(self):
        self.index.close()


def _ingest(tmp_path, name, kind, algorithm="phash", reference=False):
    apps = _Apps(tmp_path / name, reference)
    try:
        return apps.ingest_pair(kind, algorithm), apps.info()
    finally:
        apps.close()


@pytest.mark.parametrize("algorithm", ["phash", "dhash", "ahash"])
@pytest.mark.parametrize("kind", ["png", "bmp"])
def test_coalesced_matches_direct_and_reference(tmp_path, monkeypatch, kind, algorithm):
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "2")
    coalesced, info = _ingest(tmp_path, "on", kind, algorithm)
    ref_on, ref_info = _ingest(tmp_path, "ref-on", kind, algorithm, reference=True)
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "0")
    direct, _ = _ingest(tmp_path, "off", kind, algorithm)
    ref_off, _ = _ingest(tmp_path, "ref-off", kind, algorithm, reference=True)
    assert len(coalesced) == {"png": 4, "bmp": 8}[kind]
    assert coalesced == direct == ref_on == ref_off
    assert info["ingest_coalesce_groups"] >= 2


@pytest.mark.parametrize("rows", ["64", "4"])
def test_pad_max_matches_pow2(tmp_path, monkeypatch, rows):
    """UCFP_INGEST_PAD=max pads each launch to the row cap, or to the
    flush itself when it is larger (a cap of 4 rows: the first body's 5
    rows flush alone)."""
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "2")
    monkeypatch.setenv("UCFP_INGEST_PAD", "max")
    monkeypatch.setenv("UCFP_INGEST_COALESCE_ROWS", rows)
    padded, _ = _ingest(tmp_path, "max", "bmp")
    monkeypatch.delenv("UCFP_INGEST_PAD")
    monkeypatch.delenv("UCFP_INGEST_COALESCE_ROWS")
    pow2, _ = _ingest(tmp_path, "pow2", "bmp")
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "0")
    direct, _ = _ingest(tmp_path, "off", "bmp")
    assert padded == pow2 == direct


@pytest.mark.parametrize("pad_to", [None, 0, 16, 3])
@pytest.mark.parametrize("algorithm", ["phash", "dhash", "ahash"])
def test_pad_rows_change_no_fingerprint(algorithm, pad_to):
    from ucfp_tpu_torch.modality import image as imod

    h, w = imod.SINGLE_HASH_INPUT[algorithm]
    gray = np.random.default_rng(7).integers(0, 256, (5, h, w), np.uint8)
    want = [th._hash_single_rows(algorithm, gray[i:i + 1], h, w, 1, "cpu")[0]
            for i in range(5)]
    assert th._hash_single_rows(algorithm, gray, h, w, 5, "cpu", pad_to) == want
    if pad_to is not None:
        padded = th._pad_rows(gray, 5, pad_to)
        assert padded.shape[0] == (max(pad_to, 5) if pad_to else 8)
        assert (padded[5:] == gray[-1]).all() and (padded[:5] == gray).all()


def test_coalesce_counters_in_info(tmp_path, monkeypatch):
    monkeypatch.setenv("UCFP_INGEST_COALESCE_MS", "2")
    apps = _Apps(tmp_path / "a")
    try:
        assert apps.info()["ingest_coalesce_flushes"] == 0
        apps.ingest_pair("bmp")
        info = apps.info()
        h = apps.handlers()
        assert h._coalesce_on
        assert info["ingest_coalesce_flushes"] == h.ingest_coalesce_flushes >= 1
        assert info["ingest_coalesce_groups"] == h.ingest_coalesce_groups >= 2
        # multi bundles never coalesce
        apps.ingest_pair("bmp", "multi")
        assert apps.info()["ingest_coalesce_groups"] == info["ingest_coalesce_groups"]
    finally:
        apps.close()


def test_coalescing_off_by_default(tmp_path):
    apps = _Apps(tmp_path / "a")
    try:
        apps.ingest_pair("bmp")
        info = apps.info()
        assert not apps.handlers()._coalesce_on
        assert (info["ingest_coalesce_flushes"], info["ingest_coalesce_groups"]) == (0, 0)
    finally:
        apps.close()
