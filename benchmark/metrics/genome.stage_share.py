"""`host.stage_share` of the whole genome from the host."""

import plugins


def read(obs):
    return plugins.load("metrics", "host.stage_share").read(obs)
