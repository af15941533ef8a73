"""Record ids and chunking shared by every kind of catalog.

Row i of a catalog is stored under record id (i * M + s) mod 2^63 with M
odd, a bijection, so the reference maps a served record id back to its
row without a table, and a record id that names no row is caught."""

from __future__ import annotations

import numpy as np

from perfbench.schedule import sub_seed

CHUNK = 1 << 15  # rows made, loaded and re-made for the reference at once
_M = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1
_M_INV = pow(_M, -1, 1 << 63)


def chunks(rows: int) -> list[tuple[int, int]]:
    return [(lo, min(CHUNK, rows - lo)) for lo in range(0, rows, CHUNK)]


def rid_offset(seed: int) -> int:
    return sub_seed(seed, "record_ids")


def record_ids(seed: int, lo: int, m: int) -> list[int]:
    s = rid_offset(seed)
    return [((i * _M) + s) & _MASK for i in range(lo, lo + m)]


def row_of(seed: int, rid: int, rows: int) -> int:
    """The row stored under rid, or -1 when rid names no row."""
    if not isinstance(rid, int) or rid < 0 or rid > _MASK:
        return -1
    i = ((rid - rid_offset(seed)) * _M_INV) & _MASK
    return i if i < rows else -1
