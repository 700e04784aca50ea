"""Kernel launches of the program (`ops.fused.LAUNCHES`, every instance of
every kernel) over the profiled window, per Gbp of input completed in it.
Launches inside a CUDA-graph capture are not counted; a graph's replay
counts each of its kernels."""


def read(obs):
    n = sum((obs.launches or {}).values())
    return n / (obs.window.bases / 1e9) if n and obs.window.bases else None
