"""``classify_flush_ms``: the mean host time of the batch classifier's
``classify.flush`` span per stepping tick: the logits' one device-to-host
copy and its wait for the tick's replay, and the rows handed to their
requests.  Where the card sets the pace, most of a tick waits here.  None
where the program has no such span."""


def read(run):
    spans = run.spans.get("classify.flush")
    return 1e3 * sum(d for _, d in spans) / len(spans) if spans else None
