"""The plain references agree with the port's own top-k functions at
tiny sizes on the CPU (the served answers are held to them end to end in
test_perfbench_faults.py), and each control departs from them."""

import torch

from perfbench import catalog
from perfbench.conftest import small_cell


def _multi(rows=700, q=5):
    cell = small_cell("multi-open8", rows=rows)
    db = cell.kind.catalog_chunk(cell.config, 4, 0, rows, "cpu")
    queries = cell.kind.make_items(cell.config, cell.traffic, 4, 1, "cpu")[0][:q]
    return cell, db, queries


def test_multi_reference_matches_the_port():
    from ucfp_tpu_torch.ops import imagehash

    cell, db, queries = _multi()
    ref = cell.reference.scores(queries, db, cell.config)
    words = db.contiguous().view(torch.int32)
    qw = torch.from_numpy(queries.copy()).contiguous().view(torch.int32)
    params = torch.from_numpy(imagehash.multihash_params(None))
    valid = torch.ones(len(db), dtype=torch.bool)
    s, i = imagehash.multihash_weighted_topk(qw, words, valid, params, 10)
    got = torch.gather(ref, 1, i)
    assert float((got - s.double()).abs().max()) < 1e-6
    assert float((ref.topk(10).values - s.double()).abs().max()) < 1e-6


def test_multi_control_departs():
    cell, db, queries = _multi()
    ref = cell.reference.scores(queries, db, cell.config)
    op = cell.reference.control_op(cell.config)
    words = db.contiguous().view(torch.int32)
    qw = torch.from_numpy(queries.copy()).contiguous().view(torch.int32)
    s, i = op(qw, words, torch.ones(len(db), dtype=torch.bool), None, 10)
    assert float((torch.gather(ref, 1, i) - s.double()).abs().max()) > 1e-4


def test_record_ids_of_a_chunk_match_its_rows():
    assert catalog.record_ids(3, 0, 2) != catalog.record_ids(4, 0, 2)
