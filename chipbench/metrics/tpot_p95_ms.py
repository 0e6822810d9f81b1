"""95th percentile over every decode step that ended inside the window
of its wall time, up to its tokens on the host, in ms."""
import numpy as np

from chipbench.drivers.serve_batches import steps_in_window


def read(run):
    steps = steps_in_window(run)
    if not steps:
        return None
    return float(np.percentile([s for s, _ in steps], 95)) * 1e3
