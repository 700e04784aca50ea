"""`device.idle_share` of the SSHash cell."""

import plugins


def read(obs):
    return plugins.load("metrics", "device.idle_share").read(obs)
