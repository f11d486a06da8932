"""``clip_latency_ms_p95``: the 95th percentile, over every clip due in the
window, of (host holding the clip's logits) - (the clip's due time), in ms.
A clip still in flight when the window closes is served to its end and its
wait counts; one never answered is a failure of the run."""

import numpy as np


def read(run):
    lat = [r.done - r.due for r in run.clips if r.done is not None]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
