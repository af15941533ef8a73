"""Seeds and arrival schedules (numpy only: the load generator imports it).

An open loop replays one arrival trace, the same for every seed: its
gaps are the quantiles of an exponential distribution at the mix's rate,
scaled so that the window holds exactly rate x seconds requests, in one
fixed order drawn once from a fixed stream. The seed draws what the
requests carry and which answers are checked, never when they arrive: on
the H100 the multi-hash cell's p95 followed the order of the gaps (two
runs of one order agreed within 10%, two orders differed by up to 2.5x),
so a seed-drawn order would make the seed change the work.
"""

from __future__ import annotations

import zlib

import numpy as np


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one named stream of the run's draws: any whole
    number is taken as --seed, negative or over 64 bits included."""
    words = [int(x) for x in np.frombuffer(
        int(seed).to_bytes(16, "little", signed=True), "<u4")]
    ss = np.random.SeedSequence(words + [zlib.crc32(stream.encode()), int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(sub_seed(seed, stream, index)))


def exp_gaps(n: int, total_s: float, stream: str) -> np.ndarray:
    """n gaps that sum to total_s: the exponential quantiles
    -ln(1 - (i + 0.5) / n), scaled, in the fixed order of `stream`."""
    if n <= 0:
        return np.zeros(0)
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    q *= total_s / q.sum()
    return q[rng(0, stream).permutation(n)]


def open_loop(rate: float, warmup_s: float, seconds: float) -> dict:
    """Due times, in seconds from the start of the load, of the warm-up
    requests and of the window's. The window opens at warmup_s and holds
    round(rate * seconds) requests, the first due at its opening."""
    n_warm = int(round(rate * warmup_s))
    n_win = max(1, int(round(rate * seconds)))
    warm = _starts(exp_gaps(n_warm, warmup_s, "gaps.warmup"))
    win = warmup_s + _starts(exp_gaps(n_win, seconds, "gaps.window"))
    return {"due": np.concatenate([warm, win]), "n_warm": n_warm, "n_window": n_win}


def _starts(gaps: np.ndarray) -> np.ndarray:
    """Due times from gaps: the first at 0, the last one gap before the end."""
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) if len(gaps) else gaps
