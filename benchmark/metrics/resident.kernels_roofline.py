"""`kernels_roofline` of the cell whose inputs lie on the card."""

import plugins


def read(obs):
    return plugins.load("metrics", "kernels_roofline").read(obs)
