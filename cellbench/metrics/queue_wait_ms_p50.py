"""``queue_wait_ms_p50``: the median over the window's admitted clips of
(the host clock at the start of the clip's first admission tick) - (its due
time).  Under a gate the wait includes the frames the stream spent asleep
before its first wake."""

import numpy as np


def read(run):
    waits = [run.tick_wall(r.result.admitted_tick) - r.due for r in run.clips
             if r.result is not None and r.result.admitted_tick >= run.tick_base]
    return float(np.median(waits)) * 1e3 if waits else None
