"""``step_mfu`` (%): useful operations per stepped frame of every weight
layer (`yardstick.ops_per_frame`, the classifier included) times the frames
stepped in the profiled sub-window, over its host seconds (synchronised at
both ends), over the card's int8 peak of 1979 TOP/s."""

from cellbench import yardstick


def read(run):
    p = run.profile
    if p is None or p.frames == 0:
        return None
    return 100.0 * yardstick.ops_per_frame(run.config) * p.frames / p.window_s / yardstick.PEAK_OPS
