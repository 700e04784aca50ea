"""`resident.syncs_per_gbp` of the command line: its sketch's and its
records' values' host waits on the card, per Gbp."""

import plugins


def read(obs):
    return plugins.load("metrics", "resident.syncs_per_gbp").read(obs)
