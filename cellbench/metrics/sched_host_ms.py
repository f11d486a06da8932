"""``sched_host_ms``: the host time of the batcher's ``admit`` and
``assemble`` spans over the window, per stepping tick."""


def read(run):
    steps = run.spans.get("step")
    if not steps:
        return None
    total = sum(d for name in ("admit", "assemble") for _, d in run.spans.get(name, ()))
    return 1e3 * total / len(steps)
