"""``gate_ms``: the host time of the gate's ``gate.park`` and ``gate.scan``
spans over the window, per tick."""


def read(run):
    ticks = run.spans.get("tick")
    if not ticks:
        return None
    total = sum(d for name in ("gate.park", "gate.scan") for _, d in run.spans.get(name, ()))
    return 1e3 * total / len(ticks) if total > 0 else None
