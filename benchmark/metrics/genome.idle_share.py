"""`device.idle_share` of the whole genome from the host."""

import plugins


def read(obs):
    return plugins.load("metrics", "device.idle_share").read(obs)
