"""`device.idle_share` of the cell whose inputs lie on the card."""

import plugins


def read(obs):
    return plugins.load("metrics", "device.idle_share").read(obs)
