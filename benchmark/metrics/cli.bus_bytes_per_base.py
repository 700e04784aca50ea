"""`genome.bus_bytes_per_base` of the command line: the bytes that its
sketch and its records' values move between host and card, per base."""

import plugins


def read(obs):
    return plugins.load("metrics", "genome.bus_bytes_per_base").read(obs)
