"""``advance_host_ms``: the mean host time of the batcher's ``advance`` span
(after the step: the per-slot outputs, cursor advance, evictions and
departures) per stepping tick of the window.  None where the program has no
such span."""


def read(run):
    spans = run.spans.get("advance")
    return 1e3 * sum(d for _, d in spans) / len(spans) if spans else None
