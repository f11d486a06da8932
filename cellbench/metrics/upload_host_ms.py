"""``upload_host_ms``: the mean host time of the pool's ``pool.upload`` span
(`SessionPool.step_prepared`: the frame batch's copy to the card, which for
a pageable batch first waits for the previous replay) per stepping tick of
the window.  None where the program has no such span."""


def read(run):
    spans = run.spans.get("pool.upload")
    return 1e3 * sum(d for _, d in spans) / len(spans) if spans else None
