"""Exact merge of per-span results at their seams.

The port's own copy of `seam_window_sel` and `merge_adjacent_shards` from
`simd_minimizers_tpu/parallel/multihost.py` (the rest of that module, the
multi-host driver, is ROADMAP A9), over the port's oracle. A span computed
windows [starts[i], starts[i + 1]) with no predecessor for its first
window; the merge re-evaluates the two windows at each seam on the host
(O(l) work each) to decide whether the oracle's adjacent dedup drops that
first value. The parts may be numpy arrays or tensors holding u32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import oracle
from ..utils.bits import SKIPPED

_MASK32 = 0xFFFF_FFFF


def concat(parts):
    """One array of the parts: torch.cat for tensors, else np.concatenate."""
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def seam_window_sel(codes_np, k, w, hasher, win: int, ambiguous_np=None) -> int:
    """sel value of ONE global window (host-side, O(l) work). `codes_np` and
    `ambiguous_np` are read only as `x[win:win + l]`."""
    l = k + w - 1
    if ambiguous_np is not None and bool(np.any(ambiguous_np[win : win + l])):
        return int(SKIPPED)
    sel = oracle.selected_stream(codes_np[win : win + l], k, w, hasher)
    return int(sel[0]) + win


def merge_adjacent_shards(parts, starts, codes_np, k, w, hasher,
                          ambiguous_np=None, aux=None):
    """Merge per-shard dedup'd minimizer outputs with EXACT seam semantics.

    Each shard computed windows [starts[i], starts[i+1]) with prev=INVALID
    at its first window, so its first output must be dropped iff the
    oracle's adjacent dedup would have dropped window starts[i]: its sel
    equals the previous (global) window's sel. With skip-ambiguous the
    last *output* of the previous shard is not necessarily the previous
    window's sel (trailing SKIPPED runs), so both seam windows are
    re-evaluated directly (O(l) each). `aux` optionally carries a parallel
    plane (super-k-mer indices) dropped in lockstep — the first window
    index of a seam-straddling run is the earlier shard's, matching
    the crate's src/collect.rs:106-110.
    """
    out = [parts[0]]
    aux_out = [aux[0]] if aux is not None else None
    for i in range(1, len(parts)):
        p = parts[i]
        drop = 0
        if len(p):
            s = int(starts[i])
            w0 = seam_window_sel(codes_np, k, w, hasher, s, ambiguous_np)
            if w0 != int(SKIPPED) and int(p[0]) & _MASK32 == w0:
                wprev = seam_window_sel(codes_np, k, w, hasher, s - 1, ambiguous_np)
                drop = 1 if w0 == wprev else 0
        out.append(p[drop:])
        if aux is not None:
            aux_out.append(aux[i][drop:])
    if aux is not None:
        return concat(out), concat(aux_out)
    return concat(out)
