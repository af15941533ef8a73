"""The port's sharded EmbeddedBackend against ucfp_tpu's, on the CPU.

The reference shards over its tests' 8 virtual CPU devices
(UCFP_SHARD=auto, conftest.py; UCFP_MESH_SHAPE=2x4 for the 2-D mesh); the
port gets the same mesh as `mesh=data_mesh(8, devices=[cpu] * 8)` (or
data_mesh_2d(2, 4, ...)), since on the CPU it never shards by itself. Both
get the same writes; every query form must return the same hits (record
ids and scores, bit for bit: the f32 vectors are small integers, the
quantized tiers' scores exact int8 cosines) and the same approximate
markers. This ports tests/test_sharded_serving.py's checks and the backend
half of __graft_entry__.dryrun_multichip: activation, placement per
shard, patches that keep the shards, knn / knn_batch / fingerprint /
multi-hash parity, filters, int8, and int4 / int2 / sketch with the cost
model off (UCFP_SKETCH_COST_MODEL=0) and the dry run's shrunk pools, so
the per-shard prefilters select from pools smaller than their shards; a
2-D mesh; a data directory the reference wrote reopened here.
"""

import asyncio

import numpy as np
import pytest
import torch
from test_torch_index import DIM, PHASH, SEM, Pair, check_queries, hits, load, run

from ucfp_tpu.index.embedded import EmbeddedBackend as JBackend
from ucfp_tpu.ops import knn as JK
from ucfp_tpu_torch.index.embedded import EmbeddedBackend
from ucfp_tpu_torch.ops import knn as TK
from ucfp_tpu_torch.parallel import mesh as TM
from ucfp_tpu_torch.parallel.sharded_knn import ShardedTensor

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference shards over conftest's 8 virtual devices
    monkeypatch.setenv("UCFP_SHARD", "auto")
    for key in ("UCFP_MESH_SHAPE", "UCFP_KNN_QUANT", "UCFP_QUERY_BATCH_MS",
                "UCFP_SKETCH_COST_MODEL"):
        monkeypatch.delenv(key, raising=False)


class MeshPair(Pair):
    """A ucfp_tpu backend on its 8-device mesh and a port backend on the
    same mesh of CPU shards."""

    def __init__(self, tmp_path, quant=None, mesh_2d=False, monkeypatch=None):
        if mesh_2d:
            monkeypatch.setenv("UCFP_MESH_SHAPE", "2x4")
        self.j = JBackend(str(tmp_path / "jax"), knn_quant=quant)
        if mesh_2d:
            monkeypatch.delenv("UCFP_MESH_SHAPE")
        mesh = (TM.data_mesh_2d(2, 4, devices=CPU8) if mesh_2d
                else TM.data_mesh(8, devices=CPU8))
        self.t = EmbeddedBackend(str(tmp_path / "torch"), device="cpu", knn_quant=quant,
                                 mesh=mesh)
        assert self.j._mesh is not None and self.j._mesh_axes == self.t._mesh_axes


def _full(x):
    return (x.full() if isinstance(x, ShardedTensor) else x).numpy()


def _check_shards(t_dev, j_dev, cap, dims):
    """Every cache tensor split in 8 blocks on the mesh's devices, equal to
    the reference's array (int8 rows: its first D columns)."""
    for i, (t, j, dim) in enumerate(zip(t_dev, j_dev, dims)):
        assert isinstance(t, ShardedTensor) and t.dim == dim and len(t.shards) == 8, i
        assert all(s.device.type == "cpu" for s in t.shards)
        assert all(s.shape[dim] == t.shape[dim] // 8 for s in t.shards)
        want = np.asarray(j)
        got = _full(t)
        if dim == 0 and got.ndim == 2 and got.shape[1] > want.shape[1]:
            got = got[:, :want.shape[1]]  # int8 rows: padded width
        np.testing.assert_array_equal(got.view(want.dtype) if got.dtype.itemsize ==
                                      want.dtype.itemsize else got, want)
    assert t_dev[0].shape[0] == cap


def test_activation(tmp_path, monkeypatch):
    t = EmbeddedBackend(str(tmp_path / "a"), device="cpu")
    assert t._mesh is None  # the CPU never shards by itself
    t.close()
    mesh = TM.data_mesh(8, devices=CPU8)
    t = EmbeddedBackend(str(tmp_path / "b"), device="cpu", mesh=mesh)
    assert t._mesh is mesh and t._n_shards() == 8 and t._mesh_axes == ("d",)
    t.close()
    monkeypatch.setenv("UCFP_SHARD", "off")
    j = JBackend(str(tmp_path / "c"))
    assert j._mesh is None
    j.close()
    t = EmbeddedBackend(str(tmp_path / "d"), device="cpu",
                        mesh=TM.serving_mesh(devices=CPU8))
    assert t._mesh is None
    t.close()


@pytest.mark.parametrize("n", [1500, 4000])
def test_same_hits_f32(tmp_path, n):
    """Every query form of test_torch_index, sharded: 2,048 / 4,096 rows
    over 8 shards."""
    p = MeshPair(tmp_path)
    fps, emb = load(p, n, seed=n)
    check_queries(p, fps, emb, n)
    # k above a shard's height: each shard gives all its rows
    q = [float(x) for x in emb[30]]
    p.same("knn", 0, q, 300)
    p.same("knn_batch", 0, [q, [float(x) for x in emb[3]]], 300)
    p.same("knn_fingerprint_batch", 0, PHASH, fps[:3], 300)
    assert not p.t.fingerprint_is_approximate(0, PHASH, 5)
    assert not p.t.knn_is_approximate(0, DIM, 5)
    cap = p.t._vec[(0, DIM)].data.shape[0]
    _check_shards(p.t._vec[(0, DIM)].device, p.j._vec[(0, DIM)].device, cap, [0, 0])
    _check_shards(p.t._ham[(0, PHASH)].device, p.j._ham[(0, PHASH)].device,
                  p.t._ham[(0, PHASH)].data.shape[0], [0, 0])
    p.close()


def _writes(p: Pair, emb, seed):
    """Writes after the device caches exist: an update, a new row, a
    delete (swap-with-last) — row patches on the shards."""
    rng = np.random.default_rng(seed + 7919)
    dim = emb.shape[1]
    new = [float(x) for x in rng.integers(-3, 4, dim)]
    p.both("upsert", [
        dict(tenant_id=0, record_id=40, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m1",
             embedding=[float(x) for x in rng.integers(-3, 4, dim)]),
        dict(tenant_id=0, record_id=10**7, modality="image", algorithm=SEM,
             fingerprint=b"\x00" * 4, model_id="m2", embedding=new),
    ])
    p.both("delete", 0, [5, len(emb) - 2])
    return new


def _vectors(n, dim, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        emb = rng.integers(-3, 4, (n, dim)).astype(np.float32)
    else:
        emb = rng.normal(size=(n, dim)).astype(np.float32)
    emb[7] = emb[3]  # duplicate rows: score ties
    emb[20] = 0.0  # a zero row scores -inf
    return emb


def _load_vectors(p: Pair, emb):
    half = len(emb) // 2
    p.both("upsert_embedding_batch", 0, SEM, list(range(half)), emb[:half],
           modality="image", model_id="m1")
    p.both("upsert_embedding_batch", 0, SEM, list(range(half, len(emb))), emb[half:],
           modality="image", model_id="m2")


def _check_vectors(p: Pair, emb, ks, seed, pool_fracs=(None,)):
    rng = np.random.default_rng(seed)
    dim = emb.shape[1]
    # small-integer catalogs get small-integer queries (exact f32 sums)
    integer = bool(np.all(emb == np.round(emb)))
    qs = [[float(x) for x in emb[i] + (rng.integers(-1, 2, dim) if integer
                                       else 0.05 * rng.normal(size=dim))]
          for i in (3, 40, len(emb) // 2 + 5, len(emb) - 1)]
    for k in ks:
        for pf in pool_fracs:
            p.same("knn", 0, qs[0], k, pool_frac=pf)
            p.same("knn", 0, qs[1], k, filter={"model_id": "m2"}, pool_frac=pf)
        p.same("knn", 0, qs[1], k, exact=True)
        p.same("knn_batch", 0, qs + [[0.0] * dim], k)
        p.same("knn_batch", 0, qs, k, filter={"model_id": "m1"})
        for batch in (False, True):
            for batch_q in (1, 5, 64):
                for filtered in (False, True):
                    kw = dict(batch=batch, batch_q=batch_q, filtered=filtered)
                    assert (p.j.knn_is_approximate(0, dim, k, **kw)
                            == p.t.knn_is_approximate(0, dim, k, **kw)), kw
    return qs


def test_int8_and_patches_keep_shards(tmp_path):
    p = MeshPair(tmp_path, quant="int8")
    emb = _vectors(3000, 20, seed=1, integer=False)
    _load_vectors(p, emb)
    _check_vectors(p, emb, (1, 10, 500), seed=2)
    cache = p.t._vec[(0, 20)]
    shards = [list(t.shards) for t in cache.device[:-1]]
    _check_shards(cache.device, p.j._vec[(0, 20)].device, 4096, [0, 0, 0])
    new = _writes(p, emb, seed=3)
    p.same("knn", 0, new, 10)  # the new row at rank 1, from its shard
    assert run(p.t.knn(0, new, 1))[0].record_id == 10**7
    _check_vectors(p, emb, (10,), seed=4)
    # the patches went into the same shard tensors, in place
    assert [list(t.shards) for t in cache.device[:-1]] == shards
    _check_shards(cache.device, p.j._vec[(0, 20)].device, 4096, [0, 0, 0])
    p.close()


@pytest.fixture
def dryrun_pools(monkeypatch):
    """The reference dry run's shrunk pools (__graft_entry__.py:229-238),
    int4's too, on both sides, with the cost model off."""
    monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    for mod in (JK, TK):
        monkeypatch.setattr(mod, "INT4_MIN_POOL", 256)
        monkeypatch.setattr(mod, "INT2_MIN_POOL", 512)
        monkeypatch.setattr(mod, "INT2_BATCH_MIN_POOL", 128)


@pytest.mark.parametrize("quant,dim,dims", [
    ("int4", 24, [0, 0, 1, 0]),
    ("int2", 28, [0, 0, 1, 0]),
    ("sketch", 32, [0, 0, 0]),
])
def test_prefilter_tiers(tmp_path, monkeypatch, dryrun_pools, quant, dim, dims):
    """16,384 rows: 2,048 per shard, above twice each per-shard pool, so
    the per-shard packed and sketch scans select."""
    seen = []  # (pipeline, shard rows, pool) of each per-shard call
    names = {"int4": ("cosine_int4_topk", "cosine_int4_topk_batched"),
             "int2": ("cosine_int2_topk", "cosine_int2_topk_batched"),
             "sketch": ("cosine_sketch_topk",)}[quant]
    for name in names:
        def rec(*a, _fn=getattr(TK, name), _name=name, **kw):
            q8 = a[2] if _name == "cosine_sketch_topk" else a[1]
            seen.append((_name, q8.shape[0], a[7]))
            return _fn(*a, **kw)

        monkeypatch.setattr(TK, name, rec)
    p = MeshPair(tmp_path, quant=quant)
    emb = _vectors(14000, dim, seed=dim, integer=False)
    _load_vectors(p, emb)
    cap = p.t._vec[(0, dim)].data.shape[0]
    assert cap == 16384
    if quant == "sketch":
        assert p.t._sketch_worth_it(cap, dim, 10, None)
        assert p.t.knn_is_approximate(0, dim, 10)  # the global pool marker
    else:
        assert p.t._packed_tier()[0](cap, dim, 10) and p.t._packed_tier()[1](cap, dim, 10, 4)
        assert p.t.knn_is_approximate(0, dim, 10)  # per-shard pools threshold
    fracs = (None, 0.0066) if quant == "sketch" else (None,)
    _check_vectors(p, emb, (10,), seed=dim, pool_fracs=fracs)
    _check_shards(p.t._vec[(0, dim)].device, p.j._vec[(0, dim)].device, cap,
                  dims + [0])
    assert {name for name, _, _ in seen} == set(names)
    assert all(rows == 2048 and 2 * pool < rows for _, rows, pool in seen), seen
    new = _writes(p, emb, seed=dim)
    p.same("knn", 0, new, 10)
    _check_vectors(p, emb, (10,), seed=dim + 1)
    _check_shards(p.t._vec[(0, dim)].device, p.j._vec[(0, dim)].device, cap,
                  dims + [0])
    p.close()


@pytest.mark.parametrize("quant", [None, "sketch"])
def test_2d_mesh(tmp_path, monkeypatch, quant):
    """Rows over the (slice, device) mesh with the innermost merge first."""
    if quant == "sketch":
        monkeypatch.setenv("UCFP_SKETCH_COST_MODEL", "0")
    p = MeshPair(tmp_path, quant=quant, mesh_2d=True, monkeypatch=monkeypatch)
    assert p.t._mesh.devices.shape == (2, 4) and p.t._mesh_axes == ("s", "d")
    emb = _vectors(6000, 16, seed=12, integer=quant is None)
    _load_vectors(p, emb)
    rng = np.random.default_rng(13)
    fps = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(100)]
    fps[60] = fps[2]
    p.both("upsert_fingerprint_batch", 0, PHASH, list(range(10**6, 10**6 + 100)), fps,
           modality="image")
    _check_vectors(p, emb, (6, 300), seed=14)
    for k in (4, 40):
        p.same("knn_fingerprint_batch", 0, PHASH, fps[:5], k)
    assert len(p.t._vec[(0, 16)].device[0].shards) == 8
    p.close()


def test_reference_data_dir_reopens_sharded(tmp_path):
    """A directory written by ucfp_tpu with its mesh on reopens in the port
    on 8 CPU shards with the same hits and scores."""
    p = MeshPair(tmp_path)
    fps, emb = load(p, 1200, seed=5)
    q = [list(map(float, emb[i])) for i in (0, 3, 99)]
    want = [hits(run(p.j.knn_batch(0, q, k))) for k in (1, 7)]
    want_fp = [hits(run(p.j.knn_fingerprint_batch(0, PHASH, fps[:6], k))) for k in (1, 7)]
    p.close()
    t = EmbeddedBackend(str(tmp_path / "jax"), device="cpu",
                        mesh=TM.data_mesh(8, devices=CPU8))
    try:
        assert [hits(run(t.knn_batch(0, q, k))) for k in (1, 7)] == want
        assert [hits(run(t.knn_fingerprint_batch(0, PHASH, fps[:6], k)))
                for k in (1, 7)] == want_fp
        assert isinstance(t._vec[(0, DIM)].device[0], ShardedTensor)
    finally:
        t.close()


def test_micro_batched_flush_is_sharded(tmp_path, monkeypatch):
    """Concurrent plain queries coalesce into the sharded knn_batch; each
    answer equals the reference's unbatched one."""
    p = MeshPair(tmp_path, quant="int8")
    emb = _vectors(2500, 16, seed=21, integer=False)
    _load_vectors(p, emb)
    p.t._qbatch_ms = 20.0
    calls = []
    orig = p.t._sharded_topk

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return orig(*a, **kw)

    monkeypatch.setattr(p.t, "_sharded_topk", counted)
    qs = [[float(x) for x in emb[i]] for i in range(0, 240, 30)]

    async def burst():
        return await asyncio.gather(*[p.t.knn(0, q, 5) for q in qs])

    got = run(burst())
    assert max(calls) > 1 and p.t._qbatch_items == len(qs)
    for q, hs in zip(qs, got):
        assert hits(hs) == hits(run(p.j.knn(0, q, 5)))
    p.close()
