"""``classify_host_ms``: the host time of the batch classifier's
``classify.assemble``, ``classify.upload`` and ``classify.replay`` spans
(the images' copy into the host batch, the copy to the card's enqueue, the
replay's enqueue) over the window, per stepping tick (``classify.replay``
spans).  None where the program has no such span."""


def read(run):
    steps = run.spans.get("classify.replay")
    if not steps:
        return None
    total = sum(d for name in ("classify.assemble", "classify.upload", "classify.replay")
                for _, d in run.spans.get(name, ()))
    return 1e3 * total / len(steps)
