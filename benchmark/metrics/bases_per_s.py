"""Bases of the inputs of every call completed in the window, over the
window's wall time (host clock), in Gbp/s."""


def read(obs):
    w = obs.window
    return w.bases / w.wall / 1e9 if w.bases else None
