"""``device_idle_pct`` (%): the share of the profiled sub-window in which no
operation runs on the card (one minus the union of their intervals)."""


def read(run):
    p = run.profile
    if p is None or p.n_ops == 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
