"""``flush_host_ms``: the host time of the batcher's ``flush`` spans (the
departures' one device-to-host copy and its wait for the tick's replay; only
on ticks with departures) over the window, per stepping tick (``step``
spans).  None where the program has no such span."""


def read(run):
    steps, flushes = run.spans.get("step"), run.spans.get("flush")
    if not steps or not flushes:
        return None
    return 1e3 * sum(d for _, d in flushes) / len(steps)
