"""`drivers.launches_per_gbp` of the cell whose inputs lie on the card."""

import plugins


def read(obs):
    return plugins.load("metrics", "drivers.launches_per_gbp").read(obs)
