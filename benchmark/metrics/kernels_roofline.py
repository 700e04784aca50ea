"""The least time of the profiled window's sketches (the yardstick's larger
bound of operations at the int32 peak and bytes at the memory peak, for
the function's work) over the summed device time of the program's kernels
in that window, in %."""


def read(obs):
    t = obs.timeline.port_kernel_s if obs.timeline else 0
    return 100 * obs.least_s / t if t and obs.least_s else None
