"""`kernels_roofline` of the whole genome from the host."""

import plugins


def read(obs):
    return plugins.load("metrics", "kernels_roofline").read(obs)
