"""The share of the profiled window in which no kernel, copy or set runs on
the card (torch.profiler's timeline), in %."""


def read(obs):
    tl = obs.timeline
    return 100 * (1 - tl.busy_s / tl.window_s) if tl and tl.window_s else None
