"""ucfp_tpu_torch.parallel (mesh, sharded_knn) against ucfp_tpu.parallel on
the CPU.

The reference runs on its tests' 8 virtual CPU devices
(`ucfp_tpu.parallel.mesh.data_mesh(8)`, conftest.py); the port on
`data_mesh(8, devices=[cpu] * 8)`, and both on 2 x 4 meshes. The same
inputs, made from numpy seeds, must give the same global rows, ties
included (shard order, then local rank), and bit-equal scores: the f32
inputs are small integers, so every dot and norm is exact in any
summation order, and the int8, int4, int2 and sketch scores are exact int8
cosines (tests/test_torch_int4.py, test_torch_int2.py,
test_torch_sketch.py). The packed columns and the sketch fed to both sides
are the reference's own arrays. Kernel #6's plain twin
(ops.fused_scan.hamming_topk_fused_plain) is held against
pallas_scan.hamming_topk_fused in interpret mode on tie-heavy catalogs,
where the (tile, lane) position order decides ties.

The int4 and int2 pools are shrunk on both sides, as the reference's dry
run shrinks them (__graft_entry__.py:189-263), so the per-shard
prefilters select from a pool smaller than their shard; the shapes here
are used by no other test, since jax.jit keeps a trace made under other
pool sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ucfp_tpu.ops import knn as JK
from ucfp_tpu.ops import pallas_scan
from ucfp_tpu.parallel import mesh as JM
from ucfp_tpu.parallel import sharded_knn as JS
from ucfp_tpu_torch.ops import fused_scan
from ucfp_tpu_torch.ops import knn as TK
from ucfp_tpu_torch.parallel import mesh as TM
from ucfp_tpu_torch.parallel import sharded_knn as TS

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return {
        "1d": (JM.data_mesh(8), TM.data_mesh(8, devices=CPU8), ("d",)),
        "2x4": (JM.data_mesh_2d(2, 4), TM.data_mesh_2d(2, 4, devices=CPU8), ("s", "d")),
    }


@pytest.fixture
def small_pools(monkeypatch):
    for mod in (JK, TK):
        monkeypatch.setattr(mod, "INT4_MIN_POOL", 256)
        monkeypatch.setattr(mod, "INT2_MIN_POOL", 512)
        monkeypatch.setattr(mod, "INT2_BATCH_MIN_POOL", 128)


def _t(x):
    """numpy -> torch, u32 bit patterns as int32."""
    x = np.ascontiguousarray(np.asarray(x))
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x.copy())


def _put(jmesh, axes, arr, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, P(*spec)))


def _same(got, want):
    """(values, rows) of the port == the reference's: rows equal, values
    bit for bit."""
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert gv.dtype.itemsize == wv.dtype.itemsize
    np.testing.assert_array_equal(gv.view(f"i{gv.dtype.itemsize}"),
                                  wv.view(f"i{wv.dtype.itemsize}"))


# -- meshes ---------------------------------------------------------------------


def test_mesh_constructors():
    m = TM.data_mesh(8, devices=CPU8)
    assert m.devices.shape == (8,) and m.axis_names == ("d",) and m.size == 8
    assert TM.data_mesh(devices=CPU8[:3]).size == 3
    m2 = TM.data_mesh_2d(2, 4, devices=CPU8)
    assert m2.devices.shape == (2, 4) and m2.axis_names == ("s", "d")
    # never shrinks silently
    with pytest.raises(ValueError, match="needs 9"):
        TM.data_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="needs 16"):
        TM.data_mesh_2d(4, 4, devices=CPU8)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError):
            TM.data_mesh()  # no CUDA card: no default mesh


@pytest.mark.parametrize("env,n,want", [
    ({}, 8, ((8,), ("d",))),
    ({}, 6, ((4,), ("d",))),  # the largest power of two
    ({}, 1, None),  # one device: nothing shards
    ({"UCFP_SHARD": "off"}, 8, None),
    ({"UCFP_MESH_SHAPE": "2x4"}, 8, ((2, 4), ("s", "d"))),
    ({"UCFP_MESH_SHAPE": "4x2", "UCFP_SHARD": "auto"}, 8, ((4, 2), ("s", "d"))),
])
def test_serving_mesh_rule(monkeypatch, env, n, want):
    monkeypatch.delenv("UCFP_SHARD", raising=False)
    monkeypatch.delenv("UCFP_MESH_SHAPE", raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    m = TM.serving_mesh(devices=CPU8[:n])
    assert (None if m is None else (m.devices.shape, m.axis_names)) == want


def test_serving_mesh_too_few_devices(monkeypatch):
    monkeypatch.delenv("UCFP_SHARD", raising=False)
    monkeypatch.setenv("UCFP_MESH_SHAPE", "4x4")
    with pytest.raises(ValueError, match="needs 16"):
        TM.serving_mesh(devices=CPU8)


def test_shard_tensor_refuses_misplaced_state(meshes):
    _, tm, axes = meshes["1d"]
    x = TS.shard_tensor(torch.arange(64), tm, axes)
    assert [s.shape[0] for s in x.shards] == [8] * 8 and x.shape == (64,)
    assert torch.equal(x.full(), torch.arange(64))
    with pytest.raises(ValueError, match="do not split"):
        TS.shard_tensor(torch.arange(60), tm, axes)
    other = TM.data_mesh(8, devices=[torch.device("meta")] * 8)
    with pytest.raises(ValueError, match="lives on cpu"):
        TS.shard_tensor(x, other, axes)


def test_merge_axis_ties_to_lower_shard():
    vals = [torch.tensor([[3.0, 1.0]]), torch.tensor([[3.0, 2.0]])]
    idx = [torch.tensor([[5, 6]]), torch.tensor([[1, 2]])]
    v, i = TS._merge_axis(vals, idx, 3)
    assert v.tolist() == [[3.0, 3.0, 2.0]] and i.tolist() == [[5, 1, 2]]
    v, i = TS._merge_axis(vals, idx, 3, largest=False)
    assert v.tolist() == [[1.0, 2.0, 3.0]] and i.tolist() == [[6, 2, 5]]


# -- kernel #6's plain twin -------------------------------------------------------


def _tie_catalog(c, w, seed):
    """A catalog of 5 distinct rows repeated at random: most cells tie."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=(5, w), dtype=np.uint32)
    db = base[rng.integers(0, 5, c)]
    return db, base


@pytest.mark.parametrize("c,w,k", [(32768, 2, 16), (32768, 16, 128), (65536, 2, 40)])
def test_hamming_topk_fused_plain_equal(c, w, k):
    db, base = _tie_catalog(c, w, seed=c + w)
    for q in (base[2], base[0] ^ np.uint32(0x10001), db[c - 1]):
        jd, ji = pallas_scan.hamming_topk_fused(jnp.asarray(q), jnp.asarray(db), k)
        for fn in (fused_scan.hamming_topk_fused, fused_scan.hamming_topk_fused_plain):
            td, ti = fn(_t(q), _t(db), k)
            _same((td, ti), (jd, ji))
            assert td.dtype == torch.int32 and ti.dtype == torch.int32


def test_hamming_topk_fused_refuses_bad_shapes():
    db = torch.zeros((32768, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="32768 == 0"):
        fused_scan.hamming_topk_fused(db[0], db[:1000], 1)
    with pytest.raises(ValueError, match="at most 16"):
        fused_scan.hamming_topk_fused(torch.zeros(17, dtype=torch.int32),
                                      torch.zeros((32768, 17), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="exceeds"):
        fused_scan.hamming_topk_fused(db[0], db, 129)


# -- the sharded functions ----------------------------------------------------------


@pytest.mark.parametrize("mesh_name,k", [("1d", 7), ("1d", 200), ("2x4", 7), ("2x4", 200)])
def test_sharded_cosine_topk_equal(meshes, mesh_name, k):
    jm, tm, axes = meshes[mesh_name]
    rng = np.random.default_rng(k)
    c, d = 1024, 16
    m = rng.integers(-3, 4, (c, d)).astype(np.float32)
    m[5] = m[900]  # ties across shards
    m[17] = 0.0  # a zero row
    valid = np.ones(c, bool)
    valid[100:200] = False
    q = rng.integers(-3, 4, (3, d)).astype(np.float32)
    q[1] = m[900]
    q[2] = 0.0  # a zero query: every score -inf
    want = JS.sharded_cosine_topk(q, _put(jm, axes, m, (axes, None)),
                                  _put(jm, axes, valid, (axes,)), k, jm, axes)
    _same(TS.sharded_cosine_topk(_t(q), _t(m), _t(valid), k, tm, axes), want)


@pytest.mark.parametrize("mesh_name,k", [("1d", 5), ("1d", 300), ("2x4", 5)])
def test_sharded_hamming_topk_equal(meshes, mesh_name, k):
    jm, tm, axes = meshes[mesh_name]
    rng = np.random.default_rng(k + 1)
    c, w = 512, 2
    m = rng.integers(0, 8, (c, w), dtype=np.uint32)  # small words: many ties
    valid = np.ones(c, bool)
    valid[::7] = False
    q = m[[37, 400]]
    want = JS.sharded_hamming_topk(q, _put(jm, axes, m, (axes, None)),
                                   _put(jm, axes, valid, (axes,)), k, jm, axes)
    got = TS.sharded_hamming_topk(_t(q), _t(m), _t(valid), k, tm, axes)
    _same(got, want)
    assert int(got[0][0, 0]) == 0


@pytest.mark.parametrize("w", [2, 16])
def test_sharded_hamming_topk_fused_equal(meshes, w):
    jm, tm, _ = meshes["1d"]
    c = 8 * 32768
    db, base = _tie_catalog(c, w, seed=w)
    db[123_456] = ~base[1]
    dbj = _put(jm, ("d",), db, ("d", None))
    for q, k in ((base[1], 10), (~base[1], 3), (base[3] ^ np.uint32(7), 64)):
        want = JS.sharded_hamming_topk_fused(jnp.asarray(q), dbj, k, jm)
        _same(TS.sharded_hamming_topk_fused(_t(q), _t(db), k, tm), want)
    d, i = TS.sharded_hamming_topk_fused(_t(~base[1]), _t(db), 3, tm)
    assert int(i[0]) == 123_456 and int(d[0]) == 0
    with pytest.raises(ValueError, match="1-D mesh"):
        TS.sharded_hamming_topk_fused(_t(base[1]), _t(db), 3, meshes["2x4"][1])


def _int8_catalog(c, d, seed):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(c, d)).astype(np.float32)
    rows[3] = 0.0  # a zero row
    rows[700] = rows[9]  # ties across shards
    q8, rn = JK.quantize_rows_int8(rows)
    wide = np.zeros((c, TK.padded_dim(d)), np.int8)
    wide[:, :d] = q8
    return rows, np.asarray(q8), np.asarray(rn), wide


@pytest.mark.parametrize("k", [7, 200])
def test_sharded_cosine_int8_topk_equal(meshes, k):
    jm, tm, _ = meshes["1d"]
    c, d = 1024, 20
    rows, q8, rn, wide = _int8_catalog(c, d, seed=k)
    valid = np.ones(c, bool)
    valid[300:400] = False
    q = rows[9]
    qq = np.clip(np.round(q / (np.abs(q).max() / 127.0)), -127, 127).astype(np.int8)
    want = JS.sharded_cosine_int8_topk(
        qq, _put(jm, ("d",), q8, ("d", None)), _put(jm, ("d",), rn, ("d",)),
        _put(jm, ("d",), valid, ("d",)), k, jm)
    _same(TS.sharded_cosine_int8_topk(_t(qq), _t(wide), _t(rn), _t(valid), k, tm), want)


@pytest.mark.parametrize("mesh_name,k", [("1d", 7), ("1d", 200), ("2x4", 7)])
def test_sharded_cosine_int8_batch_topk_equal(meshes, mesh_name, k):
    jm, tm, axes = meshes[mesh_name]
    c, d = 1024, 20
    rows, q8, rn, wide = _int8_catalog(c, d, seed=k + 3)
    valid = np.ones(c, bool)
    valid[::5] = False
    rng = np.random.default_rng(k)
    q = np.stack([rows[9] + 0.05 * rng.normal(size=d), rng.normal(size=d),
                  np.zeros(d)]).astype(np.float32)
    want = JS.sharded_cosine_int8_batch_topk(
        q, _put(jm, axes, q8, (axes, None)), _put(jm, axes, rn, (axes,)),
        _put(jm, axes, valid, (axes,)), k, jm, axes)
    _same(TS.sharded_cosine_int8_batch_topk(_t(q), _t(wide), _t(rn), _t(valid), k, tm,
                                            axes), want)


def _packed_inputs(kind, c, d, seed):
    rows, q8, rn, wide = _int8_catalog(c, d, seed)
    pack = JK.pack_int2_cols if kind == "int2" else JK.pack_int4_cols
    packed_t, inv = (np.asarray(x) for x in pack(jnp.asarray(q8)))
    return rows, q8, rn, wide, packed_t, inv


@pytest.mark.parametrize("kind,mesh_name", [("int4", "1d"), ("int4", "2x4"),
                                            ("int2", "1d")])
def test_sharded_packed_topk_equal(meshes, small_pools, kind, mesh_name):
    """Per-shard pools below their shard (pool * 2 < rows): the packed
    scan, the per-shard prefix (unfiltered) or the mask pass (filtered)."""
    jm, tm, axes = meshes[mesh_name]
    c, d = 8 * 2048, 24 if kind == "int4" else 28
    rows, q8, rn, wide, packed_t, inv = _packed_inputs(kind, c, d, seed=len(kind))
    jfn = JS.sharded_cosine_int2_topk if kind == "int2" else JS.sharded_cosine_int4_topk
    tfn = TS.sharded_cosine_int2_topk if kind == "int2" else TS.sharded_cosine_int4_topk
    n = c - 3 * 2048 - 77  # shards 5.. hold no live row or part of one
    valid = np.arange(c) < n
    fvalid = valid.copy()
    fvalid[::3] = False
    fvalid[9] = True
    rng = np.random.default_rng(5)
    jargs = (_put(jm, axes, q8, (axes, None)), _put(jm, axes, rn, (axes,)),
             _put(jm, axes, packed_t, (None, axes)), _put(jm, axes, inv, (axes,)))
    targs = (_t(wide), _t(rn), _t(packed_t), _t(inv))
    for q in (rows[9] + 0.05 * rng.normal(size=d).astype(np.float32),
              rng.normal(size=d).astype(np.float32)):
        for vv, nv in ((valid, n), (fvalid, None)):
            want = jfn(jnp.asarray(q), *jargs, _put(jm, axes, vv, (axes,)), 10, jm, axes,
                       n_valid=nv)
            _same(tfn(_t(q), *targs, _t(vv), 10, tm, axes, n_valid=nv), want)


@pytest.mark.parametrize("kind", ["int4", "int2"])
def test_sharded_packed_batch_topk_equal(meshes, small_pools, kind):
    jm, tm, axes = meshes["1d"]
    c, d = 8 * 2048, 24 if kind == "int4" else 28
    rows, q8, rn, wide, packed_t, inv = _packed_inputs(kind, c, d, seed=7 + len(kind))
    jfn = (JS.sharded_cosine_int2_batch_topk if kind == "int2"
           else JS.sharded_cosine_int4_batch_topk)
    tfn = (TS.sharded_cosine_int2_batch_topk if kind == "int2"
           else TS.sharded_cosine_int4_batch_topk)
    rng = np.random.default_rng(11)
    q = np.stack([rows[9] + 0.05 * rng.normal(size=d), rng.normal(size=d),
                  rows[5000]]).astype(np.float32)
    n = c - 2048 - 100
    want = jfn(jnp.asarray(q), _put(jm, axes, q8, (axes, None)), _put(jm, axes, rn, (axes,)),
               _put(jm, axes, packed_t, (None, axes)), _put(jm, axes, inv, (axes,)),
               n, 10, jm, axes)
    got = tfn(_t(q), _t(wide), _t(rn), _t(packed_t), _t(inv), n, 10, tm, axes)
    _same(got, want)
    assert got[1][0, 0] == 9 and got[1][2, 0] == 5000


@pytest.mark.parametrize("mesh_name,cand", [("1d", 2752), ("2x4", 2752), ("1d", 16000)])
def test_sharded_cosine_sketch_topk_equal(meshes, mesh_name, cand):
    """Per-shard pools of max(512, 16k, cand * rows / C): 512 of 2048 rows
    (the segment quota selection), or the whole shard (exhaustive)."""
    jm, tm, axes = meshes[mesh_name]
    c, d = 8 * 2048, 32
    rows, q8, rn, wide = _int8_catalog(c, d, seed=cand)
    planes = JK.sketch_planes(d)
    tiled = np.asarray(JK.tile_sketch(JK.build_sketch_chunked(jnp.asarray(q8),
                                                              jnp.asarray(planes))))
    valid = np.arange(c) < c - 1000
    valid[::4] = False
    valid[9] = True
    rng = np.random.default_rng(cand)
    for q in (rows[9] + 0.05 * rng.normal(size=d).astype(np.float32),
              rng.normal(size=d).astype(np.float32)):
        want = JS.sharded_cosine_sketch_topk(
            jnp.asarray(q), jnp.asarray(planes), _put(jm, axes, q8, (axes, None)),
            _put(jm, axes, rn, (axes,)), _put(jm, axes, tiled, (axes, None, None)),
            _put(jm, axes, valid, (axes,)), 10, cand, jm, axes)
        got = TS.sharded_cosine_sketch_topk(_t(q), _t(planes), _t(wide), _t(rn), _t(tiled),
                                            _t(valid), 10, cand, tm, axes)
        _same(got, want)
