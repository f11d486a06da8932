"""``classify_replay_device_ms``: the mean device time of the batch
classifier's ``dev.replay`` spans in the window, one per timed stepping
tick (a step is timed at most every 5 ms of host time): the card's time
from the event after the batch's copy to the one after the graph's replay
(CUDA events, on the tracer's clock), which holds the card's wait for the
graph's launch and the graph.  It is ``replay_device_ms``'s reader under a
second name: that metric moves a latency, this one ``frames_per_s``.  None
where the program records no device spans (the CPU, or a program without
them)."""
from cellbench.spec import load_module

read = load_module("metrics", "replay_device_ms").read
