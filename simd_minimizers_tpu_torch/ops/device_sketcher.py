"""A fixed-geometry sketcher for latency-bound short sequences.

Counterpart of `simd_minimizers_tpu/ops/device_sketcher.ShortSeqSketcher`.
Where the JAX class compiles one program ahead of time, this one captures
the kernels of one launch (`minimizer_tiles` -> `tile_offsets` ->
`tile_append`, with `kmer_top16` first where w takes the large-w route)
once in a `torch.cuda.CUDAGraph` over static buffers: the
code bytes of up to `max_chars` chars, and an int32 pair (length, offset
bits) that the kernel reads on the card in place of its by-value n and
offset. One capture thus serves every length and offset, and a call is a
copy in, one graph replay and a copy out, with no kernel launch from
Python. `tile_append` reads the total from the card, so the output is a
static buffer of planes x ntiles x TILE values whose count comes down with
it, into pinned host memory, at harvest.

`launch` returns handles without a host sync; `harvest` waits for them;
`sketch_many` keeps one launch in flight ahead of each harvest. On the CPU
the same surface runs the kernels' plain versions, without a graph.

Construct one sketcher per configuration up front, then feed it sequences
of 2-bit codes (uint8, one per char).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import convert
from ..hashers import KmerHasher
from ..utils.device import require_cuda
from . import fused, pipeline

RB = 8  # rows of C windows per block in the JAX program's geometry (G = 1)


class ShortSeqSketcher:
    """One captured launch over at most RB * C windows (default C = 1024:
    8192 windows, max_chars = 8192 + l - 1)."""

    def __init__(self, k: int, w: int, hasher: KmerHasher,
                 mode: str = pipeline.MODE_MINIMIZERS, C: int = 1024, donate: bool = True,
                 device: torch.device | str = "cuda"):
        if mode not in pipeline.MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if hasher.k != k:
            raise ValueError(f"hasher k={hasher.k} differs from k={k}")
        self.k, self.w, self.mode = k, w, mode
        self._l = k + w - 1
        self._C = C
        self.max_chars = RB * C + self._l - 1
        # kept for the JAX surface: the input always lands in one static
        # buffer, so there is nothing to donate; donate=False also asks
        # measure_floor for the replay alone (device_floor_us)
        self._donate = donate
        self.device = require_cuda(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        (kind, canonical, rot), tables = convert.hasher_tensors(hasher, self.device)
        self._args = (self.k, self.w, tables, rot, canonical, mode)
        self._kw = {"kind": kind, "byte_codes": True}
        self._planes = 2 if mode == pipeline.MODE_SUPERKMERS else 1
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        """The library and each card's shared-memory limits are set up
        before the capture; then one launch over the static buffers (on the
        large-w route the pre-pass's array comes from the graph's pool)."""
        dev = self.device
        fused._library(dev)
        # the length and offset bits (8 bytes), then the codes: one copy in
        self._buf = torch.zeros(8 + self.max_chars, dtype=torch.uint8, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph, stream=stream):
            scratch, counts = fused.minimizer_tiles(self._buf[8:], self.max_chars, *self._args,
                                                    meta=self._buf[:8].view(torch.int32),
                                                    **self._kw)
            self._offsets = fused.tile_offsets(counts)
            self._out = fused.tile_append(scratch, counts, self._offsets, None)
        torch.cuda.current_stream(dev).wait_stream(stream)
        large_w = fused.sub_tile(self.k, self.w, self._args[4], self.mode,
                                 kind=self._kw["kind"]) != 0
        self._launched = (*(("kmer_top16",) if large_w else ()),
                          fused.instance_name(self._args[4], self.mode, False),
                          "tile_offsets", "tile_append")

    def _replay(self) -> None:
        """One replay: its kernels, each counted in fused.LAUNCHES."""
        self._graph.replay()
        for name in self._launched:
            fused.LAUNCHES[name] += 1

    def _check(self, codes_np: np.ndarray) -> int:
        n = int(codes_np.shape[0])
        if n > self.max_chars:  # the JAX package's AssertionError
            raise AssertionError(f"ShortSeqSketcher(C={self._C}) handles up to {self.max_chars} "
                                 "chars; route longer inputs through backend.sketch")
        return n

    # -- async pipeline -----------------------------------------------------
    def launch(self, codes_np: np.ndarray, offset: int = 0):
        """Enqueue one sketch of 2-bit codes; returns handles (no sync), or
        None below one window."""
        n = self._check(codes_np)
        if n < self._l:
            return None
        if self._graph is None:  # CPU: the plain versions, no graph
            chars = torch.from_numpy(np.ascontiguousarray(codes_np, dtype=np.uint8))
            return fused.fused_sketch(chars, n, *self._args, offset=offset, **self._kw)
        # length, offset bits and codes in one pinned buffer, one copy in
        host = torch.empty(8 + n, dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        buf[:8].view(np.int32)[:] = (n, np.uint32(offset).view(np.int32))
        buf[8:] = codes_np
        self._buf[:8 + n].copy_(host, non_blocking=True)
        self._replay()
        total = torch.empty(1, dtype=torch.int32, pin_memory=True)
        out = torch.empty(self._out.shape, dtype=torch.int32, pin_memory=True)
        total.copy_(self._offsets[-1:], non_blocking=True)
        out.copy_(self._out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return total, out, event

    def harvest(self, handles):
        """One launch's result as np.uint32 (positions, window indices for
        syncmers, or both for super-k-mers): the only sync point."""
        empty = np.zeros(0, np.uint32)
        if handles is None:
            return (empty, empty) if self.mode == pipeline.MODE_SUPERKMERS else empty
        if self._graph is not None:
            total, out, event = handles
            event.synchronize()
            cnt = int(total[0])
            flat = out.numpy().view(np.uint32)
            planes = [flat[p * cnt:(p + 1) * cnt].copy() for p in range(self._planes)]
        else:
            planes = [t.numpy().view(np.uint32)
                      for t in (handles if isinstance(handles, tuple) else (handles,))]
        return tuple(planes) if self.mode == pipeline.MODE_SUPERKMERS else planes[0]

    # -- one-shot -----------------------------------------------------------
    def sketch(self, codes_np: np.ndarray):
        """Upload, run and return the result of one short sequence."""
        return self.harvest(self.launch(codes_np))

    def sketch_many(self, seqs):
        """Sketch a list of short sequences, launching i + 1 before
        harvesting i (one launch in flight)."""
        outs = []
        pending = []
        for s in seqs:
            pending.append(self.launch(s))
            if len(pending) > 1:
                outs.append(self.harvest(pending.pop(0)))
        while pending:
            outs.append(self.harvest(pending.pop(0)))
        return outs

    # -- measurement --------------------------------------------------------
    def measure_floor(self, codes_np: np.ndarray, m: int = 50, probes: int = 3) -> dict:
        """The per-call floor on the card, host clocks unless named:

        - sync_us: one synchronized call (copy in, replay, copy out, wait);
        - per_call_us: the slope of m calls enqueued back to back with one
          sync, (t_m - t_1) / (m - 1): the host's and the card's work per
          call without the sync;
        - with donate=False, device_floor_us: the same slope of graph
          replays alone on the staged input, and replay_us: one replay's
          time on the card by CUDA events (the mean of m).
        Each is the least of `probes` runs.
        """
        if self._graph is None:
            raise RuntimeError("measure_floor measures the card: construct the sketcher on cuda")
        if m <= 1:
            raise AssertionError("m > 1: per_call_us is a (t_many - t_one)/(m-1) slope")
        if codes_np.shape[0] < self._l:
            raise AssertionError(f"input shorter than one window (l={self._l}): nothing to time")
        self.harvest(self.launch(codes_np))  # warm

        def batch(mm):
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            h = None
            for _ in range(mm):
                h = self.launch(codes_np)
            self.harvest(h)
            return time.perf_counter() - t0

        t_one = min(batch(1) for _ in range(probes))
        t_many = min(batch(m) for _ in range(probes))
        res = {"per_call_us": (t_many - t_one) / (m - 1) * 1e6, "sync_us": t_one * 1e6}
        if not self._donate:
            self.launch(codes_np)  # stage the input

            def batch_dev(mm):
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                for _ in range(mm):
                    self._replay()
                torch.cuda.synchronize(self.device)
                return time.perf_counter() - t0

            batch_dev(1)
            td_one = min(batch_dev(1) for _ in range(probes))
            td_many = min(batch_dev(m) for _ in range(probes))
            res["device_floor_us"] = (td_many - td_one) / (m - 1) * 1e6
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            replays = []
            for _ in range(probes):
                start.record()
                for _ in range(m):
                    self._replay()
                end.record()
                end.synchronize()
                replays.append(start.elapsed_time(end) / m * 1e3)
            res["replay_us"] = min(replays)
        return res
