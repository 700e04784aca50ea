"""The values' own least time over the device time of the operations named
`kmer_values` in the profiled window, in %: per value 4 B of position read
and 8 B of value written, and the chars read once at 2 bits, at the memory
peak (`yardstick.py`). Nothing to read where no such operation ran."""

import yardstick

KERNEL = "kmer_values"


def read(obs):
    tl = obs.timeline
    t = sum(s for name, s in tl.device_ops.items() if KERNEL in name) if tl else 0
    if not t or not obs.window.positions:
        return None
    return 100 * yardstick.least_seconds(0, obs.window.bases / 4 + 12 * obs.window.positions) / t
