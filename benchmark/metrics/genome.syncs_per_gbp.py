"""`resident.syncs_per_gbp` of the whole genome from the host."""

import plugins


def read(obs):
    return plugins.load("metrics", "resident.syncs_per_gbp").read(obs)
