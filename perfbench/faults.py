"""Controls and faults put in the program's place, for the tests and the
control runs (python3 -m perfbench ... --inject <name>); the benchmark's
own runs inject nothing. Each replaces the port's top-k function that the
cell's kind names (kinds.<kind>.PORT_OP):

  control         the plain reference in the next precision down from the
                  configuration's (reference.<kind>.control_op)
  answer_altered  the first query's best row replaced by its second best
  half_catalog    the second half of the stored rows left out of the scan
  half_batch      the second half of a request's queries given the first
                  half's answers (only where a request carries several)"""

from __future__ import annotations

import importlib

NAMES = ("control", "answer_altered", "half_catalog", "half_batch")


def install(name: str, cell):
    """Put `name` in the port function's place; -> a callable that puts
    the port's function back."""
    import torch

    mod_name, attr = cell.kind.PORT_OP
    mod = importlib.import_module(mod_name)
    op = getattr(mod, attr)

    if name == "control":
        new = cell.reference.control_op(cell.config)
    elif name == "answer_altered":
        def new(*a, **kw):
            s, i = op(*a, **kw)
            i = i.clone()
            if i.shape[1] > 1:
                i[0, 0] = i[0, 1]
            return s, i
    elif name == "half_catalog":
        def new(q, db, valid, *rest):
            v = valid.clone()
            v[len(v) // 2:] = False
            return op(q, db, v, *rest)
    elif name == "half_batch":
        def new(q, *rest):
            h = (len(q) + 1) // 2
            s, i = op(q[:h], *rest)
            reps = torch.arange(len(q), device=q.device) % h
            return s[reps], i[reps]
    else:
        raise ValueError(f"unknown injection {name!r}; one of {NAMES}")
    setattr(mod, attr, new)
    return lambda: setattr(mod, attr, op)
