"""`bases_per_s` of a cell whose inputs already lie on the card, so that the
kernels set the pace: a metric of its own, with a bound from its own
spread."""

import plugins


def read(obs):
    return plugins.load("metrics", "bases_per_s").read(obs)
