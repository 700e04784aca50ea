"""The share of the staged window's wall that the program's host stages take
(every stage of `utils.profiling.split_wall` but `kernels`: folds, mask
packing, slot fill, uploads, downloads, read attribution, seam merge), in
%. The stages wait for the card around themselves, so this is the share
of a serialised run; the staged window is not the profiled one. Nothing
to read where the entry runs no stage."""


def read(obs):
    host = sum(v for k, v in (obs.stages or {}).items() if k != "kernels")
    return 100 * host / obs.staged.wall if host else None
