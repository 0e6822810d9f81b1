"""Tokens generated by every decode step that ended inside the window,
over the window (prefill time included), in tokens/s."""
from chipbench.drivers.serve_batches import steps_in_window


def read(run):
    steps = steps_in_window(run)
    if not steps:
        return None
    return sum(b for _, b in steps) / run.seconds
