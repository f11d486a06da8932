"""``frames_per_s``: every frame stepped on the card in the window, over the
window's host seconds (the window ends in a synchronise)."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
