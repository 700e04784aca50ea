"""`bases_per_s` of the command line's profiled window: the rate under the
profiler, beside the end-to-end `bases_per_s` of its unprofiled window."""

import plugins


def read(obs):
    return plugins.load("metrics", "bases_per_s").read(obs)
