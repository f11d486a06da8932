"""Open loop: clips arrive on the host clock, a Poisson stream at the mix's
``rate_per_s`` (seeded gaps from a quantile grid), whether or not earlier
clips have finished.  Each clip is due at its scheduled time, which its
latency counts from; between arrivals with nothing to serve the loop waits.
"""
from __future__ import annotations

import math

import numpy as np

from cellbench import traffic


def prepare(mix, seconds: float, bank, seed: int):
    """The window's arrivals, in due order."""
    rate = float(mix["rate_per_s"])
    n = int(math.ceil(rate * seconds * 1.25)) + 32
    dues = np.cumsum(traffic.gaps(rate, n, traffic.rng(seed, "arrivals")))
    return [c for c in traffic.clips(mix, n, bank, seed, "open", dues=dues) if c.due < seconds]


def drive(w, clips, mix, seconds: float) -> None:
    i = 0
    while True:
        now = w.elapsed()
        if now >= seconds:
            break
        while i < len(clips) and clips[i].due <= now:
            w.submit(clips[i], due=w.t0 + clips[i].due)
            i += 1
        if w.pending:
            w.tick()
        else:
            w.wait_until(clips[i].due if i < len(clips) else seconds)
    w.close()
    w.drain()
