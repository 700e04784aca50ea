"""The seconds of the compressed .npz write (`smt.write npz`) in the profiled
window's calls of `sketch_fasta.main` over the window's wall, in %. Nothing
to read where the program has no such span."""

import program_counts

SPAN = "write npz"


def read(obs):
    s = program_counts.counts("span_s").get(SPAN)
    return 100 * s / obs.window.wall if s and obs.window.wall else None
