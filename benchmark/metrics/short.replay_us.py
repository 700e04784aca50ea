"""Device time of the program's kernels per call in the profiled window
(the replayed graph's kernels, from torch.profiler), in microseconds."""


def read(obs):
    t = obs.timeline.port_kernel_s if obs.timeline else 0
    return t / obs.window.calls * 1e6 if t and obs.window.calls else None
