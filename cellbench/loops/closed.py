"""Closed loop: ``clients`` sensors, each submitting its next clip the tick
after its last one departs, so the pool stays full.  Clips come from the
mix's length grid, 4096 at a time (the first batch made in set-up), in seeded
order.
"""
from __future__ import annotations

from cellbench import traffic

BATCH = 4096


class Clips:
    """The endless seeded stream of the mix's clips."""

    def __init__(self, mix, bank, seed: int):
        self.mix, self.bank, self.seed = mix, bank, seed
        self.made = 0
        self.queue = []
        self._refill()

    def _refill(self) -> None:
        made = traffic.clips(self.mix, BATCH, self.bank, self.seed, f"closed{self.made}",
                             start=self.made)
        self.queue.extend(reversed(made))
        self.made += BATCH

    def take(self, client: int) -> traffic.Clip:
        if not self.queue:
            self._refill()
        clip = self.queue.pop()
        clip.client = client
        return clip


def prepare(mix, seconds: float, bank, seed: int) -> Clips:
    return Clips(mix, bank, seed)


def drive(w, clips: Clips, mix, seconds: float) -> None:
    for client in range(int(mix["clients"])):
        w.submit(clips.take(client))
    while w.elapsed() < seconds:
        for rec in w.tick():
            w.submit(clips.take(rec.clip.client))
    w.close()
    w.drain()
