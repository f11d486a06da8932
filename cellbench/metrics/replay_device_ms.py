"""``replay_device_ms``: the mean device time of the pool's ``dev.replay``
spans in the window, one per timed stepping tick (the program times a step
at most every 5 ms of host time): the card's time from the event the pool records
after the frame batch's copy to the one after the graph's replay (CUDA
events, on the tracer's clock), which holds the card's wait for the graph's
launch and the graph.  None where the program records no device spans (the
CPU, or a program without them)."""


def read(run):
    spans = run.spans.get("dev.replay")
    return 1e3 * sum(d for _, d in spans) / len(spans) if spans else None
