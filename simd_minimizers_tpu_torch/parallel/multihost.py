"""Multi-process sketching, and the exact merge of per-span results at
their seams.

The port's counterpart of `simd_minimizers_tpu/parallel/multihost.py`,
over the port's oracle and `torch.distributed`:

1. The genome is split into contiguous shards that overlap by l - 1 chars
   (`shard_bounds`), one per process, so every window has one owner.
2. Each process sketches its shard on its own devices
   (`local_shard_sketch`, through `shard.fused_sharded_sketch`), with
   sequence-global results.
3. The shards' ragged results are all-gathered in two collectives (the
   counts, then one stacked buffer of every plane) and merged exactly at
   the seams (`_merge_mode_shards`).

The caller initialises the process group, as the JAX caller does
`jax.distributed`: gloo moves CPU tensors, NCCL CUDA tensors. One process
(or no process group) returns its local result without a collective.

A span computed windows [starts[i], starts[i + 1]) with no predecessor for
its first window; `merge_adjacent_shards` re-evaluates the two windows at
each seam on the host (O(l) work each) to decide whether the oracle's
adjacent dedup drops that first value. The parts may be numpy arrays or
tensors holding u32 bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..hashers import KmerHasher
from ..ops import oracle, pipeline
from ..utils.bits import SKIPPED
from ..utils.profiling import count_bytes, count_sync

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


def shard_bounds(n: int, l: int, num_shards: int, shard_id: int) -> tuple[int, int]:
    """Char span [start, end) of a shard, its l - 1 halo included; (0, 0)
    for a shard without windows."""
    nw = max(n - l + 1, 0)
    per = -(-nw // num_shards) if nw else 0
    s = min(shard_id * per, nw)
    e = min(s + per, nw)
    if s >= e:
        return 0, 0
    return s, min(e - 1 + l, n)


def merge_shard_positions(shards: list[np.ndarray]) -> np.ndarray:
    """Concatenate per-shard global position lists, dedup at the seams.

    Exact for minimizer streams without skipped windows: a shard's last
    value is the sel of its last window and the next shard's first value
    the sel of its first window. With an ambiguity mask use
    `merge_adjacent_shards`, which evaluates the true seam windows."""
    parts = [s for s in shards if s.size]
    if not parts:
        return np.zeros(0, np.uint32)
    out = [parts[0]]
    for nxt in parts[1:]:
        out.append(nxt[1:] if nxt[0] == out[-1][-1] else nxt)
    return np.concatenate(out)


def local_shard_sketch(codes_np: np.ndarray, k: int, w: int, hasher: KmerHasher,
                       num_shards: int, shard_id: int, mode: str = pipeline.MODE_MINIMIZERS,
                       ambiguous_np: np.ndarray | None = None, mesh=None,
                       device: str = "cuda"):
    """This process's contribution: its halo'd shard sketched on `mesh`
    (default: this process's card, or one CPU entry with device="cpu"),
    as sequence-global np.uint32 positions, (positions, window indices)
    for super-k-mers, or syncmer window indices."""
    from . import shard

    pipeline.assert_no_superkmer_ambiguity(mode, ambiguous_np is not None)
    l = k + w - 1
    empty = np.zeros(0, np.uint32)
    s, e = shard_bounds(int(codes_np.shape[0]), l, num_shards, shard_id)
    if e <= s:
        return (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
    res = shard.fused_sharded_sketch(
        codes_np[s:e], k, w, hasher, mode,
        None if ambiguous_np is None else ambiguous_np[s:e],
        mesh or shard.default_mesh(local_only=True, device=device))
    off = np.uint32(s)
    if mode == pipeline.MODE_SUPERKMERS:
        return tuple((p + off).astype(np.uint32) for p in res)
    return (res + off).astype(np.uint32)


def _allgather_ragged_planes(planes: list[np.ndarray], nproc: int) -> list[list[np.ndarray]]:
    """All-gather same-count ragged uint32 planes: per plane, the list of
    every process's array.

    Exactly two collectives: the counts, then one stacked (nplanes, cap)
    buffer padded to the largest count, so planes that move in lockstep
    (super-k-mer positions and window indices) share one exchange. The
    tensors are CPU tensors under gloo and CUDA tensors (this process's
    current card) under NCCL."""
    size = planes[0].size
    if not all(p.size == size for p in planes):
        raise AssertionError("planes must move in lockstep")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = convert.upload(np.array([size], np.int64), dev, "gather upload")
    counts = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(counts, mine)
    count_bytes("d2h pageable", 8 * nproc)
    count_sync("gather counts", nproc)
    counts = [int(c) for c in counts]
    cap = max(max(counts), 1)
    buf = np.full((len(planes), cap), 0xFFFFFFFF, np.uint32)
    for i, p in enumerate(planes):
        buf[i, :size] = p
    mine = convert.upload(buf.view(np.int32), dev, "gather upload")  # u32 bits in int32
    bufs = [torch.empty_like(mine) for _ in range(nproc)]
    dist.all_gather(bufs, mine)
    count_bytes("d2h pageable", buf.nbytes * nproc)
    count_sync("gather readback", nproc)
    bufs = [b.cpu().numpy().view(np.uint32) for b in bufs]
    return [[bufs[p][i, :counts[p]] for p in range(nproc)] for i in range(len(planes))]


def _allgather_ragged(mine: np.ndarray, nproc: int) -> list[np.ndarray]:
    """All-gather one ragged uint32 array: the per-process list."""
    return _allgather_ragged_planes([mine], nproc)[0]


def _merge_mode_shards(parts, starts, codes_np, k, w, hasher, mode, ambiguous_np=None,
                       aux=None):
    """The per-shard results merged into the global one, by mode."""
    if mode in pipeline.SYNCMER_MODES:
        # window indices: the shards own disjoint window ranges
        return np.concatenate(parts) if parts else np.zeros(0, np.uint32)
    return merge_adjacent_shards(parts, starts, codes_np, k, w, hasher, ambiguous_np, aux=aux)


def multihost_sketch(codes_np: np.ndarray, k: int, w: int, hasher: KmerHasher,
                     mode: str = pipeline.MODE_MINIMIZERS,
                     ambiguous_np: np.ndarray | None = None, device: str = "cuda"):
    """The whole sequence's sketch across every process of the process
    group, in every mode. Call it identically in every process (after
    torch.distributed.init_process_group); each sketches its shard on
    `device`, the shards are all-gathered, and every process returns the
    same global result. Without a process group, or in a group of one, it
    is the local sketch, with no collective."""
    nproc = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    pid = dist.get_rank() if nproc > 1 else 0
    mine = local_shard_sketch(codes_np, k, w, hasher, nproc, pid, mode, ambiguous_np,
                              device=device)
    if nproc == 1:
        return mine
    l = k + w - 1
    starts = [shard_bounds(int(codes_np.shape[0]), l, nproc, p)[0] for p in range(nproc)]
    if mode == pipeline.MODE_SUPERKMERS:
        parts, aux = _allgather_ragged_planes([mine[0], mine[1]], nproc)
    else:
        parts, aux = _allgather_ragged(mine, nproc), None
    return _merge_mode_shards(parts, starts, codes_np, k, w, hasher, mode, ambiguous_np, aux=aux)
