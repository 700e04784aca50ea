"""`kernels_roofline` of the SSHash cell: the configuration's least work (the
super-k-mer reference's: the minimizers' operations and bytes, and 4 B of
index and 8 B of value written a position) over the device time of the
program's kernels, `kmer_values` among them."""

import plugins


def read(obs):
    return plugins.load("metrics", "kernels_roofline").read(obs)
