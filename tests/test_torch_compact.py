"""Compaction and autocompaction in the port against ucfp_tpu's.

The same event stream (columnar pHash runs, updates over them, deletes,
text records, an embedding run and raw records with metadata) goes into
both packages' EmbeddedBackend; both compact. The compacted port log
must be byte-equal to the reference's (the WAL format is shared), and
the port reopened from it must hold the same records and give the same
hits as before the compaction and as the reference. Queries answer while
a thread compacts; two compactions asked for at once run one after the
other and lose no acknowledged write; the autocompaction rule (UCFP_AUTOCOMPACT_MB, the
log doubled since the last snapshot) is the reference's; and
/v1/admin/compact answers the reference's JSON for the service bearer
and 403 / 401 for anyone else.
"""

import asyncio
import json
import os
import threading

import pytest

from ucfp_tpu.core import Modality as JModality
from ucfp_tpu.core import Record as JRecord
from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu_torch.core import Modality, Record
from ucfp_tpu_torch.index import wal as walmod
from ucfp_tpu_torch.index.embedded import EmbeddedBackend

PHASH = "imgfprint-phash-v1"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("UCFP_SHARD", "off")
    monkeypatch.setenv("UCFP_KNN_QUANT", "none")
    monkeypatch.delenv("UCFP_AUTOCOMPACT_MB", raising=False)


def run(coro):
    return asyncio.run(coro)


def _fill(b, mod, rec_cls):
    """The shared event stream, through either package's backend."""

    async def go():
        rids = list(range(1, 40))
        await b.upsert_fingerprint_batch(
            5, PHASH, rids, [bytes([i] * 8) for i in rids],
            modality=mod.IMAGE, config_hash=9)
        # churn: updates and deletes, so the compaction drops events
        await b.upsert_fingerprint_batch(
            5, PHASH, rids[:10], [bytes([200 + i]) * 8 for i in range(10)],
            modality=mod.IMAGE, config_hash=9)
        await b.delete(5, [2, 4])
        await b.upsert([
            rec_cls(5, 500, mod.TEXT, "a", b"\x01", text="hello compacted world"),
            rec_cls(5, 501, mod.TEXT, "a", b"\x02", text="another world of text"),
            rec_cls(6, 1, mod.TEXT, "b", b"\x02", embedding=[1.0, 0.0], model_id="m"),
            rec_cls(5, 502, mod.IMAGE, PHASH, b"\x07" * 8, config_hash=9,
                    metadata=b"\xaa"),  # metadata breaks the run
        ])
        await b.upsert([rec_cls(5, 501, mod.TEXT, "a", b"\x03", text="replaced text")])
        await b.upsert_embedding_batch(
            7, "emb-v1", list(range(20, 32)),
            [[0.25 * i, -1.5, 3.0 + i] for i in range(12)],
            fingerprints=[bytes([i] * 4) for i in range(12)],
            modality=mod.TEXT, model_id="mx", config_hash=3)
        await b.delete(7, [21])

    run(go())


def _state(b):
    """Comparable rows of a backend (embeddings as float tuples)."""
    return {k: dict(v, fingerprint=bytes(v["fingerprint"]), metadata=bytes(v["metadata"]),
                    embedding=(None if v["embedding"] is None
                               else tuple(float(x) for x in v["embedding"])))
            for k, v in b._records.items()}


def _answers(b):
    """Hits of each query form, k past every stored row: the row order
    differs after a reopen, and at a cut through tied scores the rows
    kept would too (in both packages)."""
    async def go():
        return (
            [(h.record_id, h.score) for h in await b.knn_fingerprint(5, PHASH, b"\x05" * 8, 64)],
            [(h.record_id, h.score) for h in await b.knn(7, [1.0, -1.5, 6.0], 20)],
            [(h.record_id, h.score) for h in await b.knn(6, [1.0, 0.0], 5)],
            [(h.record_id, h.score) for h in await b.bm25(5, ["world", "text"], 5)],
        )

    return run(go())


def _pair(tmp_path, engine):
    j = JBackend(str(tmp_path / "jax"), wal_engine=engine)
    t = EmbeddedBackend(str(tmp_path / "torch"), wal_engine=engine, device="cpu")
    _fill(j, JModality, JRecord)
    _fill(t, Modality, Record)
    return j, t


def _wal_bytes(d):
    with open(os.path.join(d, "ucfp.wal"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("engine", ["native", "json"])
def test_compacted_log_byte_equal_to_reference(tmp_path, engine):
    j, t = _pair(tmp_path, engine)
    try:
        assert _wal_bytes(tmp_path / "torch") == _wal_bytes(tmp_path / "jax")
        before = t._wal_size()
        j.compact()
        t.compact()
        assert t._wal_size() < before
        assert _wal_bytes(tmp_path / "torch") == _wal_bytes(tmp_path / "jax")
        assert t._wal_floor == t._wal_size() == j._wal_size()
    finally:
        j.close()
        t.close()


@pytest.mark.parametrize("engine", ["native", "json"])
def test_compact_then_reopen_same_records_and_hits(tmp_path, engine):
    j, t = _pair(tmp_path, engine)
    state, answers = _state(t), _answers(t)
    assert state == _state(j) and answers == _answers(j)
    t.compact()
    j.compact()
    # the live store is unchanged by the compaction
    assert _state(t) == state and _answers(t) == answers
    t.close()
    j.close()
    t2 = EmbeddedBackend(str(tmp_path / "torch"), device="cpu")
    j2 = JBackend(str(tmp_path / "jax"))
    try:
        assert _state(t2) == state == _state(j2)
        assert _answers(t2) == answers == _answers(j2)
        # the reference reopens the port's compacted log to the same rows
        j3 = JBackend(str(tmp_path / "torch"))
        assert _state(j3) == state
        j3.close()
    finally:
        t2.close()
        j2.close()


def test_queries_answer_while_a_thread_compacts(tmp_path, monkeypatch):
    """The rewrite's file write is parked: queries answer, an ingest
    applies and acks later, and the compacted log holds it on reopen."""
    t = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    _fill(t, Modality, Record)
    answers = _answers(t)
    parked, release = threading.Event(), threading.Event()
    orig = walmod.GroupCommitWal.commit_rewrite

    def slow_commit(self, ctx, **kw):
        parked.set()
        assert release.wait(30)
        return orig(self, ctx, **kw)

    monkeypatch.setattr(walmod.GroupCommitWal, "commit_rewrite", slow_commit)
    compactor = threading.Thread(target=t.compact)
    compactor.start()
    try:
        assert parked.wait(30)
        assert _answers(t) == answers  # reads go on during the rewrite
        written = threading.Event()

        def ingest():
            run(t.upsert([Record(5, 900, Modality.IMAGE, PHASH, b"\x05" * 8,
                                 config_hash=9)]))
            written.set()

        writer = threading.Thread(target=ingest)
        writer.start()
        deadline = 30
        while deadline > 0 and (5, 900) not in t._records:
            threading.Event().wait(0.05)
            deadline -= 0.05
        assert (5, 900) in t._records  # applied in memory while parked
        hits = run(t.knn_fingerprint(5, PHASH, b"\x05" * 8, 3))
        assert hits[0].record_id == 900 and hits[0].score == 1.0
    finally:
        release.set()
        compactor.join(30)
    writer.join(30)
    assert written.is_set() and not compactor.is_alive()
    t.close()
    t2 = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    try:
        assert (5, 900) in t2._records
    finally:
        t2.close()


def test_two_compactions_keep_every_acknowledged_write(tmp_path, monkeypatch):
    """Two compactions asked for at once (an admin call during another,
    autocompaction during one) run one after the other, and writes that
    land between either one's mark and its commit are all in the
    reopened log."""
    t = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    _fill(t, Modality, Record)
    monkeypatch.setenv("UCFP_AUTOCOMPACT_MB", "0.000001")  # due from here on
    parked = [threading.Event(), threading.Event()]
    release = [threading.Event(), threading.Event()]
    calls = []
    orig = walmod.GroupCommitWal.commit_rewrite

    def slow_commit(self, ctx, **kw):
        n = len(calls)
        calls.append(ctx["watermark"])
        parked[n].set()
        assert release[n].wait(30)
        return orig(self, ctx, **kw)

    monkeypatch.setattr(walmod.GroupCommitWal, "commit_rewrite", slow_commit)
    acked, errors = [], []

    def write(rid):
        try:
            fp = rid.to_bytes(8, "little")
            run(t.upsert([Record(5, rid, Modality.IMAGE, PHASH, fp, config_hash=9)]))
            acked.append((rid, fp))
        except BaseException as e:  # pragma: no cover - reported below
            errors.append(e)

    first = threading.Thread(target=t.compact)
    first.start()
    second = writers = None
    try:
        assert parked[0].wait(30)
        writers = [threading.Thread(target=write, args=(1000 + i,)) for i in range(6)]
        for w in writers:
            w.start()
        second = threading.Thread(target=t.compact)
        second.start()
        # autocompaction is due, but one runs: it skips without waiting
        assert t._autocompact_due() and t.maybe_autocompact() is False
        with pytest.raises(RuntimeError):
            t._wal.begin_rewrite()  # the log itself takes one rewrite at a time
        assert not parked[1].wait(0.3) and len(calls) == 1  # the second waits
        release[0].set()
        assert parked[1].wait(30)
        late = [threading.Thread(target=write, args=(2000 + i,)) for i in range(6)]
        for w in late:
            w.start()
        writers += late
        deadline = 30.0
        while deadline > 0 and not all((5, 2000 + i) in t._records for i in range(6)):
            threading.Event().wait(0.05)
            deadline -= 0.05
    finally:
        for ev in release:
            ev.set()
        first.join(30)
        if second is not None:
            second.join(30)
        for w in writers or []:
            w.join(30)
    assert not errors and len(acked) == 12 and len(calls) == 2
    assert not first.is_alive() and not second.is_alive()
    state = _state(t)
    t.close()
    t2 = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    try:
        for rid, fp in acked:
            assert t2.get_record(5, rid)["fingerprint"] == fp
        assert _state(t2) == state
    finally:
        t2.close()


# (threshold MB, log bytes, floor bytes): the rule is size > threshold
# and size > 2 * max(floor, 1)
RULE_CASES = [
    ("0", 10**6, 0), ("", 10**6, 0), ("0.5", 400_000, 0), ("0.5", 600_000, 0),
    ("0.5", 600_000, 300_000), ("0.5", 600_000, 299_999), ("1", 3 * 2**20, 2**20),
    ("1", 2 * 2**20, 2**20), ("-1", 10**9, 0),
]


@pytest.mark.parametrize("thresh,size,floor", RULE_CASES)
def test_autocompact_rule_equals_reference(tmp_path, monkeypatch, thresh, size, floor):
    monkeypatch.setenv("UCFP_AUTOCOMPACT_MB", thresh)
    got = []
    for cls, kw in ((JBackend, {}), (EmbeddedBackend, {"device": "cpu"})):
        b = cls(str(tmp_path / cls.__module__), **kw)
        try:
            b._wal_floor = floor
            monkeypatch.setattr(b, "_wal_size", lambda size=size: size)
            got.append(b._autocompact_due())
        finally:
            b.close()
    want = (float(thresh or 0) > 0 and size > float(thresh) * 2**20
            and size > 2 * max(floor, 1))
    assert got == [want, want]


def test_autocompaction_fires_once_the_log_doubled(tmp_path, monkeypatch):
    monkeypatch.setenv("UCFP_AUTOCOMPACT_MB", "0.01")  # about 10 KB
    b = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    calls = []
    orig = b.compact
    monkeypatch.setattr(b, "compact", lambda: (calls.append(b._wal_size()), orig())[1])
    rec = Record(1, 1, Modality.TEXT, "raw", b"\x01" * 64, text="some text " * 30)
    for _ in range(200):  # one record rewritten: pure churn
        run(b.upsert([rec]))
    # each compaction fired past 10 KB and past twice the last snapshot
    assert calls and all(c > 0.01 * 2**20 for c in calls)
    assert b._wal_size() < 200 * 400 and b._wal_floor <= b._wal_size()
    b.close()
    b2 = EmbeddedBackend(str(tmp_path / "db"), device="cpu")
    try:
        assert b2.get_record(1, 1)["text"].startswith("some text")
    finally:
        b2.close()


# -- the admin route ------------------------------------------------------------


def _apps(tmp_path):
    from ucfp_tpu.server.app import ServerState as JState
    from ucfp_tpu.server.app import build_server as j_build
    from ucfp_tpu.server.auth import ApiKeyContext as JCtx
    from ucfp_tpu.server.auth import StaticMapKey as JKeys
    from ucfp_tpu.server.inputs_cache import InputsCache as JInputs
    from ucfp_tpu.server.ratelimit import NoopRateLimiter as JNoopRL
    from ucfp_tpu.server.usage import NoopUsageSink as JNoopSink
    from ucfp_tpu_torch.server.app import ServerState, build_server
    from ucfp_tpu_torch.server.auth import ApiKeyContext, StaticMapKey
    from ucfp_tpu_torch.server.inputs_cache import InputsCache
    from ucfp_tpu_torch.server.ratelimit import NoopRateLimiter
    from ucfp_tpu_torch.server.usage import NoopUsageSink

    j_index = JBackend(str(tmp_path / "jax"))
    t_index = EmbeddedBackend(str(tmp_path / "torch"), device="cpu")
    j = j_build(JState(index=j_index, api_keys=JKeys({"svc": JCtx(0), "ten": JCtx(2)}),
                       rate_limit=JNoopRL(), usage=JNoopSink(), inputs=JInputs()))
    t = build_server(ServerState(
        index=t_index, api_keys=StaticMapKey({"svc": ApiKeyContext(0),
                                              "ten": ApiKeyContext(2)}),
        rate_limit=NoopRateLimiter(), usage=NoopUsageSink(), inputs=InputsCache()))
    return (j, j_index), (t, t_index)


def _call(apps, method, path, body=b"", token="svc"):
    from ucfp_tpu.server.http import Request as JRequest
    from ucfp_tpu_torch.server.http import Request

    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    h = {"content-length": str(len(body))}
    if token:
        h["authorization"] = f"Bearer {token}"
    out = []
    for (app, _), cls in zip(apps, (JRequest, Request)):
        resp, _ = asyncio.run(app.handle_request(cls(method, path, {}, dict(h), body)))
        out.append((resp.status, json.loads(resp.body) if resp.body else None))
    return out


def test_admin_compact_json_equals_reference(tmp_path):
    apps = _apps(tmp_path)
    try:
        for rid in range(1, 30):
            st = _call(apps, "PUT", "/v1/records", {"records": [{
                "tenant_id": 1, "record_id": rid % 3 + 1, "modality": "text",
                "algorithm": "raw", "fingerprint": [rid % 256]}]})
            assert st[0] == st[1] and st[1][0] == 200
        (js, jb), (ts, tb) = _call(apps, "POST", "/v1/admin/compact")
        assert js == ts == 200
        assert set(tb) == {"compacted", "wal_bytes_before", "wal_bytes_after"}
        # the byte sizes as numbers: the two logs are the same bytes
        assert tb == jb and tb["compacted"] is True
        assert tb["wal_bytes_after"] < tb["wal_bytes_before"]
        assert tb["wal_bytes_after"] == apps[1][1]._wal_size()
        # a second compaction of a compacted log changes nothing
        (_, jb2), (_, tb2) = _call(apps, "POST", "/v1/admin/compact")
        assert tb2 == jb2 and tb2["wal_bytes_before"] == tb2["wal_bytes_after"]
    finally:
        for _, index in apps:
            index.close()
    t2 = EmbeddedBackend(str(tmp_path / "torch"), device="cpu")
    try:
        assert sorted(t2._records) == [(1, 1), (1, 2), (1, 3)]
    finally:
        t2.close()


@pytest.mark.parametrize("token,status", [("ten", 403), (None, 401)])
def test_admin_compact_refuses_non_service_callers(tmp_path, token, status):
    apps = _apps(tmp_path)
    try:
        out = _call(apps, "POST", "/v1/admin/compact", token=token)
        assert out[0] == out[1] and out[1][0] == status
    finally:
        for _, index in apps:
            index.close()
