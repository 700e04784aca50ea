"""The card's peaks: what a roofline share is measured against. The least
work of a sketch (its operations and bytes) is the function's, as the
configuration's reference counts it (`least_work` in
`benchmark/references/<mode>.py`, with the hash's operations from
`benchmark/hashes/<hasher>.py`): a frozen copy of the port's own
arithmetic (chip_smoke.py `_tiles_ops_per_window` and `_hash_ops`; a char
already in a byte needs no decode), so
that a later change to the program cannot move the yardstick, and never a
kernel's layout, so that a change that fuses or splits kernels is judged
against the same least time.
"""

from __future__ import annotations

# NVIDIA H100 SXM at its full 700 W (the data sheet; NVIDIA's Hopper
# architecture white paper for the SM): HBM3 at 3.35 TB/s, and int32
# operations at 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of `ops` at the int32 peak and `nbytes` at the memory peak."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
