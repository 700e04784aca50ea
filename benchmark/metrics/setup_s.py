"""Seconds from the start of the process to the first measured call: loading,
making the inputs, and the warm calls (in a checkout's first run, the
build of the kernels too)."""


def read(obs):
    return obs.setup_s
