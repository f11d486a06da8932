"""``pool_step_host_ms``: the mean host time of the batcher's ``step`` span
(`SessionPool.step_prepared`: the frame batch's copy to the card, then one
graph replay) per stepping tick of the window."""


def read(run):
    steps = run.spans.get("step")
    return 1e3 * sum(d for _, d in steps) / len(steps) if steps else None
