"""``admit_wait_ms_p50``: the median over the window's admitted clips of the
program's own host clock at the clip's first admission minus at its
``submit`` (`StreamResult.admitted_ns - submitted_ns`), in ms.  None where
the program does not stamp its results."""

import numpy as np


def read(run):
    waits = []
    for r in run.clips:
        res = r.result
        if res is None or res.admitted_tick < run.tick_base:
            continue
        sub, adm = getattr(res, "submitted_ns", 0), getattr(res, "admitted_ns", 0)
        if sub and adm:
            waits.append(adm - sub)
    return float(np.median(waits)) / 1e6 if waits else None
