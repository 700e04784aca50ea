"""`bases_per_s` of the profiled window, in the cell whose rate the host's
state moves too far between runs to hold it end to end."""

import plugins


def read(obs):
    return plugins.load("metrics", "bases_per_s").read(obs)
