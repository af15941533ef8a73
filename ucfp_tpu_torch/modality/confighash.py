"""Stable 64-bit config hashing.

The reference stamps every Record with the SDK's config_hash so records
produced under different knobs never compare (src/core/mod.rs:43-55). Ours
is xxh3_64 over a canonical "key=value" serialization — stable across
processes and releases as long as the knob set is unchanged.

Copied from ucfp_tpu/modality/confighash.py; only its imports differ.
"""

from __future__ import annotations

import xxhash


_SCALARS = (str, int, float, bool, type(None))


def config_hash64(algorithm: str, **knobs) -> int:
    parts = [algorithm]
    for k in sorted(knobs):
        v = knobs[k]
        if not isinstance(v, _SCALARS):
            # repr() of sets/dicts varies with insertion order and
            # PYTHONHASHSEED — an unordered knob would silently produce
            # a different hash per process, making every restart refuse
            # its own prior records. Pin the contract to scalars.
            raise TypeError(
                f"config knob {k!r} must be a scalar, got {type(v).__name__}"
            )
        parts.append(f"{k}={v!r}")
    return xxhash.xxh3_64_intdigest("\x1f".join(parts).encode("utf-8"))
