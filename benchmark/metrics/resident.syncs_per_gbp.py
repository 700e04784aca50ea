"""Host waits on the card (the program's `SYNCS`, every site: total
readbacks, blocking uploads, download waits) over the profiled window, per
Gbp of input completed in it."""

import program_counts


def read(obs):
    n = sum(program_counts.counts("syncs").values())
    return n / (obs.window.bases / 1e9) if n and obs.window.bases else None
