"""``k1_roofline`` (%): the least time of the conv and TCN layers of a step
at the system's batch (`yardstick.k1_bound_s` at ``run.batch``), times the
stepping ticks of the profiled sub-window, over the device time of the
kernels that carry those layers (the configuration's K1 name patterns)."""

from cellbench import yardstick


def read(run):
    p = run.profile
    if p is None or p.k1_s <= 0 or p.step_ticks == 0:
        return None
    bound = yardstick.k1_bound_s(run.config, run.batch)
    return 100.0 * p.step_ticks * bound / p.k1_s
