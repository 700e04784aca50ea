"""One long sequence sketched across several devices.

Counterpart of `simd_minimizers_tpu/parallel/shard.py`
(`default_mesh`, `fused_sharded_sketch`, `sharded_sketch`). A mesh is a
list of `torch.device`s, one entry per shard; an entry may repeat (four
shards on one card run one after another). Each shard owns an equal span of
windows, as in the JAX package, and runs one `_fused_launch` over its
halo'd span: a view of its device's upload of the codes (one upload per
distinct device), launched with its first char as the kernel's offset, so
its values come out sequence-global. The spans of one device are harvested
together (`spans.LaunchWave`: one stacked fetch of their totals) and the
host merges them at the seams exactly, or for syncmers concatenates them
(`spans.merge`).

There is no second path: the JAX package's XLA `sharded_sketch` has no
counterpart here, and `sharded_sketch` is `fused_sharded_sketch`. On
`cpu` devices the kernels' plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..hashers import KmerHasher
from ..ops import pipeline, spans
from ..utils.device import require_cuda


def default_mesh(n_devices: int | None = None, local_only: bool = False,
                 device: str = "cuda") -> list[torch.device]:
    """The devices to shard over: every CUDA card (the first n_devices),
    or with device="cpu" n_devices (default 1) CPU entries. local_only
    keeps this process's own card when a process group is running (card
    rank % cards), the counterpart of per-host sketching inside a
    multi-process program."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    require_cuda(device)
    count = torch.cuda.device_count()
    if local_only and dist.is_available() and dist.is_initialized():
        devs = [torch.device("cuda", dist.get_rank() % count)]
    else:
        devs = [torch.device("cuda", i) for i in range(count)]
    return devs[:n_devices] if n_devices is not None else devs


def _shard_spans(n: int, l: int, ndev: int) -> list[tuple[int, int]]:
    """(first window, chars) of each shard: the JAX package's split into
    equal spans of windows (the last shorter), empty where nw < ndev runs
    out of windows."""
    nw = n - l + 1
    per_dev = -(-nw // ndev)
    spans = []
    for d in range(ndev):
        s = d * per_dev
        e = min(s + per_dev, nw)
        spans.append((s, 0) if s >= nw else (s, min(e - 1 + l, n) - s))
    return spans


def fused_sharded_sketch(codes_np: np.ndarray, k: int, w: int, hasher: KmerHasher,
                         mode: str = pipeline.MODE_MINIMIZERS,
                         ambiguous_np: np.ndarray | None = None,
                         mesh: list | None = None):
    """Sketch one sequence of 2-bit codes (uint8) across the mesh (default:
    every CUDA card), skipping the windows that hold a char flagged in
    `ambiguous_np`: np.uint32 positions, (positions, super-k-mer window
    indices), or syncmer window indices, bit-identical to one device."""
    mesh = [torch.device(d) for d in (mesh or default_mesh())]
    l = k + w - 1
    n = int(codes_np.shape[0])
    empty = np.zeros(0, dtype=np.uint32)
    if n < l:
        return (empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 != 1:
        raise AssertionError("open syncmers require odd w")
    if hasher.canonical and l % 2 != 1:
        raise AssertionError(f"window length l={l} must be odd to determine strand")
    bounds = _shard_spans(n, l, len(mesh))
    parts = [None] * len(mesh)
    waves = {}
    uploads = {}
    for d, (dev, (s, m)) in enumerate(zip(mesh, bounds)):
        if m == 0:  # no window left for this shard: no launch
            nothing = torch.zeros(0, dtype=torch.int32)
            parts[d] = (nothing, nothing) if mode == pipeline.MODE_SUPERKMERS else nothing
            continue
        if dev not in uploads:
            (kind, canonical, rot), tables = convert.hasher_tensors(hasher, dev)
            uploads[dev] = (convert.code_bytes(codes_np, dev), kind, canonical, rot, tables)
            waves[dev] = spans.LaunchWave(mode, lambda key, res: parts.__setitem__(key, res),
                                          budget=1 << 62)
        chars, kind, canonical, rot, tables = uploads[dev]
        plane = None if ambiguous_np is None else convert.ambiguity_plane(
            np.asarray(ambiguous_np[s:s + m]), m, dev)
        waves[dev].launch(d, chars[s:s + m], m, k, w, tables, rot, canonical, plane, kind=kind,
                          offset=s, byte_codes=True)
    for wave in waves.values():
        wave.flush()
    host = [convert.Download(p).result() for p in parts]
    return spans.merge(host, [s for s, _ in bounds], mode, k, w, hasher, codes_np, ambiguous_np)


# the JAX package's XLA sharded path has no counterpart: one path serves
sharded_sketch = fused_sharded_sketch
