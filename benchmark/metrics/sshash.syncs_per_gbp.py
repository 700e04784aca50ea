"""`resident.syncs_per_gbp` of the SSHash cell: the values step adds no host
wait, so it reads the resident genome's table upload and total readback a
chromosome."""

import plugins


def read(obs):
    return plugins.load("metrics", "resident.syncs_per_gbp").read(obs)
