"""The 95th percentile of the latency of all calls of the window (host
clock; NumPy's linear interpolation), in microseconds."""

import numpy as np


def read(obs):
    walls = obs.window.walls
    return float(np.percentile(walls, 95)) * 1e6 if walls else None
