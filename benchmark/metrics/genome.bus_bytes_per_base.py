"""Bytes the program moved between host and card (its `BUS_BYTES`, both
directions, pageable and pinned) over the profiled window, per base of
input completed in it."""

import program_counts


def read(obs):
    n = sum(program_counts.counts("bus_bytes").values())
    return n / obs.window.bases if n and obs.window.bases else None
