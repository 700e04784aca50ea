"""The device time of the operations named `kmer_values` over the profiled
window's busy time (`device.idle_share`'s union of kernels, copies and
sets), in %."""

import plugins


def read(obs):
    tl = obs.timeline
    kernel = plugins.load("metrics", "sshash.values_roofline").KERNEL
    t = sum(s for name, s in tl.device_ops.items() if kernel in name) if tl else 0
    return 100 * t / tl.busy_s if t and tl.busy_s else None
