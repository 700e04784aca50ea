"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed S]

Builds the port's kernels from the sources in this checkout and drives
each path of the main surface, k=21 w=11, through the public `Builder.run`
or `run_skip_ambiguous_windows` on the card, counting each kernel
instance's launches. Over 1e8 random 2-bit bases (seed S): canonical and
forward minimizers, super-k-mers, closed syncmers and open syncmers;
canonical skip-ambiguous minimizers, forward minimizers, canonical closed
syncmers and forward open syncmers with an ambiguity mask shaped like an
assembled chromosome (200 runs of N of 1,000-20,000 bases, isolated Ns at
rate 1e-4); canonical mul minimizers, canonical antilex minimizers and
forward antilex super-k-mers. Over 1e8 random printable bytes (32-126) of
general text: forward mul minimizers (the reference's advice for text),
canonical nt minimizers (the nt hasher folds a byte with & 3), forward
closed syncmers, and forward mul minimizers with a sparse mask (isolated
flags at rate 1e-4). The counts are set to 0 just before each path and
read just after it. For each path it then calls each kernel's wrapper at
the path's shapes and holds it against its plain PyTorch version
(bit-equal: integer outputs), holds the whole kernel path against the
plain pipeline and `Builder.run`, checks the density of the mask-free nt
and mul paths (2/(w+1) for minimizers and super-k-mers, 2/w for closed
and 1/w for open syncmers, each within 0.01; antilex's density is higher
on random input and is held only by equality), times each kernel, the
kernel path and their plain versions with CUDA events (`tile_offsets` and
`torch.cumsum` beside it as eager calls and as device time per call in a
replayed CUDA graph), computes each kernel's bound from this run's
inputs, measures the peak device memory of both paths, and splits a warm
`Builder.run` into upload, kernel path and download (through pinned
memory, with the pageable `.cpu()` beside it). It times the host packing
and upload of the 2-bit inputs that are not zero-copy (an `AsciiSeq` and
a `PackedSeq` slice from base 1, 1e8 bases), and the bus alone (256 MiB
each way, through pageable and pinned host memory).

Then k-mer values of the 1e8 bases through `Output` after `Builder.run` on
the card (the kmer_values kernel, csrc/values.cu): values_u64 of canonical
and forward minimizers at k=21, values_u128_limbs of canonical k=33 and
forward k=64 minimizers, each a main path that launches the kernel once,
and the canonical positions in a random order through
`device_values.kmer_values_u64` (equal to the sorted run's values);
the kernel against its plain version at the same shapes (bit-equal), the
entry point against the kernel's limbs and the host (the native extractor
on 1e6 positions, NumPy's u128 limbs on 1e5), the kernel's time and bound,
the warm wall of the entry point, and beside it the native extractor on
every position and NumPy's gather on 1e6 positions, scaled.

Then the paths of whole genomes and read batches, each checked, timed
(CUDA events for the kernels, wall time for the entry) and measured for
peak device memory:
- one random sequence of 2^31 + 2^26 bases, canonical, through
  `Builder.run` (`sketch_long`, five spans): its windows around 2^31
  against the plain version, positions below n, their density, and their
  order (they rise but for tie flips between strands, each back by less
  than w); `sketch_long` eager and in waves; each kernel against its plain
  version on two of the path's own launches, a full 2^29-char span and the
  last span, at offset 2^31 - 16384;
- the 1e8 bases again through `sketch_long` in 2^24-char spans, every mode
  with and without the mask, both strands: bit-equal to one launch, which
  equals its plain version;
- a genome of records: 24 at GRCh38's primary chromosome lengths and 200
  contigs of 10-200 kbp, random codes made on the card, one byte per base,
  with chromosome-shaped masks, canonical skip-ambiguous minimizers through
  `backend.sketch_records` (the contigs on the batch route): every record
  against its plain version on the card and three against the oracle, the
  summed kernel path, the download, eager against wave scheduling, the
  wall split into stages (utils/profiling.split_wall); then
  chr21 and chr22 written as a FASTA (60-char lines, N runs, lowercase
  stretches) through `python -m simd_minimizers_tpu_torch.sketch_fasta
  --values`, whose .npz must equal `sketch_records` on the parsed records
  and the native extractor's values, with its stage times and the start of
  a process that only imports the package; the CLI's values step on the
  card (kmer_values on code bytes) as a main path, and the kernel on
  chr21's code bytes against its plain version;
- `Builder.run_batch` of 1,000,000 random 150 bp reads as a (B, L) ASCII
  matrix (canonical minimizers; folded and slotted on the card by
  `ascii_slots`, held against its plain version and timed at those shapes)
  and of 20,000 reads of 100-10,000 bp (forward minimizers with
  a 1% mask; canonical super-k-mers, whose launches run the super-k-mer
  instance with the batch's padding plane): bit-equal to the plain version
  of the same launches on the card and, for 10,000 reads, to the oracle;
  each run's wall split into stages, and each kernel against its plain
  version on its widest launch, bounded over the windows its reads own;
- Builder.run(device="cpu") of the 1e8 bases in a process of its own, on
  the bounded CPU route (spans of 2^24 windows, ops/spans.py) and as one
  launch of the plain version: wall and peak RSS of each, both equal to
  the card's positions.
Then the paths of the last slices:
- the stored route of minimizer_tiles (conflict-free keys, doubling
  passes) at w = 1..63 in four modes (minimizers, super-k-mers, closed
  syncmers, minimizers with the chromosome mask) on both strands at 1e7
  bases, and k = 64 and 1,001 at w = 5, each launch against its plain
  version; tile_offsets on a 2^29-char span's 131,072 counts beside
  torch.cumsum (the pass counts of the stored route: kernel_ab.py
  --passes);
- the two routes of the sliding minimum from w = 16 to the largest w the
  stored route fits (1e7 bases, both strands), bit-equal to each other,
  timed in turns (medians of 7 batches of 10 calls; at w = 1,536 the
  canonical margin is 1-2%): where the large-w route starts to win
  (ops/fused.LARGE_W_MIN);
- large w at 1e8 chars through `Builder.run`: canonical nt at w = 32,767,
  forward nt at w = 61,439 with the chromosome mask, forward mul text at
  32,767, canonical super-k-mers and forward closed syncmers at 32,767,
  canonical at w = 21,721 and 21,723 (the two sides of the old shared-
  memory gate), each a main path of four kernels (the pre-pass kmer_top16,
  csrc/top16.cu, then the three): each launch against its plain version at
  1e7 chars, kmer_top16 too, each path against the oracle (O(w) per window:
  canonical w = 32,767 at 1e6 chars, the others at 3e5), the density of
  forward closed syncmers against 2/w; at 1e8 the time and bound of the
  pre-pass (beside its time before its prefix-XOR redesign, and its
  persistent grid), of the route given its tops (beside its time before
  its conflict-free scan and T/G plane) and of both, the route's dynamic
  shared memory a block and blocks per SM (the occupancy query), the main
  path's peak extra device memory, and on the first path kmer_top16
  against its plain version (its kernels-line entry); then the peak device
  memory of canonical w = 2,047 at 1e8 by both routes (what the tops add
  where the stored route ran before LARGE_W_MIN fell), and the pre-pass
  alone on canonical nt at k = 31 and 63 over the 1e8 bases, each
  bit-equal to its plain version at 1e7 chars;
- `ShortSeqSketcher` (one captured CUDA graph, canonical k=21 w=11):
  `sketch_many` of 10,000 random sequences of 30-8,222 chars, each
  against the oracle, launches counted per replay; `measure_floor` at
  8,192 chars beside a warm `Builder.run` of the same chars; super-k-mers;
- `fused_sharded_sketch` of the 1e8 bases over ["cuda:0"] and
  ["cuda:0"] * 4 in every mode family (one with the N mask), each
  bit-equal to `Builder.run`; `multihost_sketch` under an NCCL group of one
  process and `_allgather_ragged_planes` of two planes over it;
- the randomized differential fuzz (`simd_minimizers_tpu_torch.tools.fuzz`)
  at seed S on the card: up to 360 configs started within 90 s, at least
  300 checked (40 on the large-w route), over every entry point, mode,
  hasher and input kind, each bit-equal to the oracle;
- one torch.profiler trace (`utils/profiling.trace`) of one canonical
  `Builder.run` of the 1e8 bases, a main path: the three kernels' device
  times, the device's idle share and its largest idle gap;
- the examples, each in a process of its own: `examples.bench` at 1e7
  bases (canonical) and `examples.multihost_demo` (two processes over
  gloo on this card, each against the oracle).
Every one of the 12 `minimizer_tiles` instances, kmer_top16, kmer_values
and ascii_slots must have run on a main path. Last, it holds every 1e8 path's builder against the NumPy oracle at
1e6 chars with a mask of the same shape, and the minimizer builders on the
golden vectors. Every failed check raises, and the script exits non-zero;
without CUDA it exits non-zero before printing any result.

The card's name and power limit, then one JSON object with each kernel's
numbers (per `minimizer_tiles` instance and input / hasher variant, from
the first path that runs it), come on the lines before the last; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

N = 10**8  # chars: the reference paper's benchmark size
N_ORACLE = 10**6  # chars the NumPy oracle checks
K, W = 21, 11

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet, at the
# full 700 W): HBM 3.35 TB/s; int32 operations 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (the Hopper SM of NVIDIA's architecture white paper; the
# data sheet's 67 TFLOP/s float32 is the same 132 x 128 FP32 lanes x 2 x
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the integer operations over the int32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tiles_ops_per_window(k: int, canonical: bool, kind: str, text: bool, amb: bool) -> int:
    """Integer operations per window (one k-mer each) that the function of
    minimizer_tiles needs at least, whatever the kernel does: the decode (2
    per char of 2-bit input, none for text, whose byte is its code); per
    strand the rolling hash (nt, mul: rotate the running hash and xor in the
    outgoing and incoming chars' values, 3, with the constant rotations
    applied to the tables on the host; antilex: complement the char, shift
    and or, 3 forward and 4 for the complement arm, which shifts the char to
    the top, and one more each to keep 2J bits when J = min(k, 16) < 16),
    the key 2 (top 16 bits, column), an O(1) sliding minimum 3 (prefix,
    suffix and their minimum) and the position 2 (column, base); the strand
    count and blend 5 (canonical); the keep test 2; and, with a mask, the
    sliding count 3. Loads from shared memory are not operations."""
    arms = 2 if canonical else 1
    return ((0 if text else 2) + _hash_ops(k, canonical, kind) + arms * (2 + 3 + 2)
            + (5 if canonical else 0) + 2 + (3 if amb else 0))


def _hash_ops(k: int, canonical: bool, kind: str) -> int:
    """The rolling hash's integer operations per k-mer (both strands when
    canonical), as `_tiles_ops_per_window` counts them."""
    if kind == "antilex":
        mask = 0 if min(k, 16) == 16 else 1
        return (3 + mask) + ((4 + mask) if canonical else 0)
    return 3 * (2 if canonical else 1)


def _top16_bound(n: int, k: int, canonical: bool, kind: str, text: bool):
    """kmer_top16's bound over n chars: reads the chars once (0.25 B each of
    2-bit input, 1 B of text) and writes 2 B per k-mer; per k-mer the decode
    (2-bit input), the rolling hash, the strands' XOR (canonical) and the
    shift to the top bits."""
    nk = max(n - k + 1, 0)
    ops = (0 if text else 2) + _hash_ops(k, canonical, kind) + (1 if canonical else 0) + 1
    return _bound((n if text else n / 4) + 2 * nk, nk * ops)


def _max_abs_err(got, want) -> int:
    """Largest |got - want| of two integer tensors (or tuples of them);
    raises if the shapes differ."""
    if isinstance(got, tuple):
        return max(_max_abs_err(g, p) for g, p in zip(got, want, strict=True))
    if got.shape != want.shape:
        raise RuntimeError(f"shape {tuple(got.shape)} != plain version's {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def _median_ms(fn, batches: int, reps: int, warmup: int) -> tuple[float, float, float]:
    """(median, min, max) over `batches` CUDA-event batches of `reps` calls."""
    from simd_minimizers_tpu_torch.utils.profiling import cuda_time_ms

    ts = sorted(cuda_time_ms(fn, reps=reps, warmup=warmup) for _ in range(batches))
    return ts[len(ts) // 2], ts[0], ts[-1]


def _graph_ms(fn, reps: int = 20, replays: int = 5) -> tuple[float, float, float]:
    """(median, min, max) device ms per `fn()` call over `replays` replays of
    one CUDA graph that holds `reps` calls: no host time between the calls,
    so a kernel that takes microseconds is timed, not its Python wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / reps)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def _scan_timing(rec, counts, note):
    """tile_offsets against its plain version on `counts`; its time and
    torch.cumsum's as eager calls (CUDA events around back-to-back calls
    from Python, which the host's enqueue bounds at this size: the kernels
    line's `ms` and `library_ms`) and as device time per call in a replayed
    CUDA graph (`graph_ms`, `library_graph_ms`). Returns the offsets."""
    import torch

    from simd_minimizers_tpu_torch.ops import fused, pipeline

    offsets = fused.tile_offsets(counts)
    err = _max_abs_err(offsets, pipeline.tile_offsets_plain(counts))
    ntiles = counts.numel()
    eager = _median_ms(lambda: fused.tile_offsets(counts), 5, 10, 2)
    eager_lib = _median_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32), 5, 10, 2)
    graph = _graph_ms(lambda: fused.tile_offsets(counts))
    graph_lib = _graph_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32))
    rec.entry("tile_offsets", 841, err, eager,
              _median_ms(lambda: pipeline.tile_offsets_plain(counts), 5, 10, 2),
              _bound(4 * ntiles + 4 * (ntiles + 1), 2 * ntiles), eager_lib,
              {"graph_ms": graph[0], "library_graph_ms": graph_lib[0]})
    print(f"  tile_offsets on {ntiles} counts: eager {eager[0]:.5f} ms ({eager[1]:.5f}.."
          f"{eager[2]:.5f}), torch.cumsum {eager_lib[0]:.5f} ms; in a CUDA graph "
          f"{graph[0]:.5f} ms ({graph[1]:.5f}..{graph[2]:.5f}), torch.cumsum {graph_lib[0]:.5f} "
          f"ms ({graph_lib[1]:.5f}..{graph_lib[2]:.5f}); {note}")
    return offsets


def _peak_extra_mib(fn) -> float:
    """Device memory `fn()` allocates at its peak beyond what was live, MiB."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _chromosome_mask(n: int, rng):
    """Per-base ambiguity flags in the shape of an assembled chromosome: 200
    runs of N per 1e8 bases (at least one), each 1,000-20,000 bases long, at
    random places, and isolated Ns at rate 1e-4."""
    import numpy as np

    amb = np.zeros(n, bool)
    runs = max(1, round(200 * n / 1e8))
    for start, length in zip(rng.integers(0, n, runs), rng.integers(1000, 20_001, runs)):
        amb[start:start + length] = True
    amb[rng.integers(0, n, rng.binomial(n, 1e-4))] = True
    return amb


def _sparse_mask(n: int, rng):
    """Per-char flags at isolated places, rate 1e-4."""
    import numpy as np

    amb = np.zeros(n, bool)
    amb[rng.integers(0, n, rng.binomial(n, 1e-4))] = True
    return amb


BATCH_MAX_BP = 1 << 20  # sketch_records' batch route takes records up to this length
N_LONG = 2**31 + 2**26  # one sequence past 2^31 chars
LONG_CHECK = (2**31 - 2**25, 2**31 + 2**25)  # its windows held against the plain version
LONG_VARIANT = " [spans of 2^29, u32 offset]"  # its kernels-line entry
SWEEP_SPAN = 1 << 24  # span chars of the 1e8-base sweep of sketch_long
N_SHORT_READS, SHORT_READ = 1_000_000, 150  # the short-read shape
N_LONG_READS = 20_000  # reads of 100-10,000 bp
N_READ_ORACLE = 10_000  # reads of each batch held against the oracle
N_SHORT = 10_000  # sequences through the short-sequence sketcher
DEVICE = "cuda"


class _Kernels:
    """Each kernel's numbers for the `kernels` line (from the first path
    that runs it, its largest error over all paths) and the launches of the
    main paths, per instance and per entry (instance and input / hasher
    variant)."""

    def __init__(self):
        from simd_minimizers_tpu_torch.ops import fused

        from simd_minimizers_tpu_torch.ops import device_values

        self.entries = {}
        self.launches_total = dict.fromkeys([*fused.LAUNCHES, *device_values.LAUNCHES], 0)
        self.launches_by_entry = {}

    def entry(self, name, source_line, err, kt, pt, bound, library=None, extra=None,
              source="minimizers.cu"):
        """Record a kernel's numbers; `source_line` is a line of the JAX
        package's ops/fused.py, or "file:line" of what the kernel replaces."""
        replaces = (source_line if isinstance(source_line, str)
                    else f"simd_minimizers_tpu/ops/fused.py:{source_line}")
        e = self.entries.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"simd_minimizers_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": 0, "max_abs_err": 0, "ms": kt[0], "plain_ms": pt[0],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None if library is None else library[0], **(extra or {})})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        lib = "" if library is None else f", library {library[0]:.4f} ms"
        print(f"  {name}: max_abs_err {err}; kernel {kt[0]:.4f} ms "
              f"({kt[1]:.4f}..{kt[2]:.4f}), plain {pt[0]:.4f} ms ({pt[1]:.4f}..{pt[2]:.4f}), "
              f"bound {bound[0]:.4f} ms ({bound[1]}), share of the bound "
              f"{bound[0] / kt[0]:.3f}{lib}")
        if err:
            raise RuntimeError(f"{name} disagrees with its plain version: max_abs_err {err}")

    def tally(self, launched, instance, variant):
        """Add a main path's launches; the instance's count goes to the
        entry of its variant."""
        for key, c in launched.items():
            self.launches_total[key] += c
            e_name = instance + variant if key == instance else key
            self.launches_by_entry[e_name] = self.launches_by_entry.get(e_name, 0) + c

    def finish(self):
        never = [key for key, c in self.launches_total.items() if not c]
        if never:
            raise RuntimeError(f"no main path launched {never}")
        print(f"every kernel instance ran on a main path: {self.launches_total}")
        for e in self.entries.values():
            e["launches"] = self.launches_by_entry.get(e["name"], 0)
            if not e["launches"]:
                raise RuntimeError(f"{e['name']} has numbers but ran on no main path")


def _main_path(fn):
    """(result, wall s, launches, peak extra device MiB) of `fn()`, a main
    path: the counts are set to 0 just before it and read just after."""
    import torch

    from simd_minimizers_tpu_torch.ops import device_values, fused

    counters = (fused.LAUNCHES, device_values.LAUNCHES)
    for counter in counters:
        for key in counter:
            counter[key] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = {key: c for counter in counters for key, c in counter.items() if c}
    return out, wall, launched, (torch.cuda.max_memory_allocated() - base) / 2**20


def _expect_launches(name, launched, instance, count, top16=0, slots=0):
    """The main path ran `instance`, tile_offsets and tile_append `count`
    times each, kmer_top16 `top16` times (the large-w route's pre-pass),
    ascii_slots `slots` times (a read matrix's fold on the card), and
    nothing else."""
    want = {instance: count, "tile_offsets": count, "tile_append": count}
    if top16:
        want["kmer_top16"] = top16
    if slots:
        want["ascii_slots"] = slots
    print(f"  main path launches: {launched}")
    if launched != want:
        raise RuntimeError(f"{name}: the main path launched {launched}, not {want}")


def _tiles_check(rec, name, args, kw, ops_per_window, plain_reps=(3, 2, 1), windows=None):
    """Each kernel's wrapper against its plain version on a main path's
    launch `args` (as minimizer_tiles takes them, `kw` its keywords):
    minimizer_tiles timed and recorded as `name`, tile_offsets and
    tile_append held at the same shapes. The operation bound counts
    `windows` (the windows the launch owns; default all n - l + 1, which
    for a batch would count its padding). On the large-w route kmer_top16
    is held against its plain version too, and minimizer_tiles is timed and
    bounded given its tops (2 B per k-mer read, no hash operations), which
    the wrapper otherwise computes first. Returns the kernel path's ms."""
    import torch

    from simd_minimizers_tpu_torch.ops import fused, pipeline

    tile = fused.TILE
    chars, n, k, w, mode, plane = args[0], args[1], args[2], args[3], args[7], args[8]
    canonical, kind, text = args[6], kw.get("kind", "nt"), kw.get("text", False)
    route_kw, route_bytes, errs = kw, 0, {}
    if fused.sub_tile(k, w, canonical, mode, plane is not None, text, kind):
        top_args = (chars, n, k, *args[4:7])
        top_kw = {key: v for key, v in kw.items() if key in ("text", "kind", "byte_codes")}
        top16 = fused.kmer_top16(*top_args, **top_kw)
        errs["kmer_top16"] = _max_abs_err(top16, pipeline.kmer_top16_plain(*top_args, **top_kw))
        route_kw, route_bytes = {**kw, "top16": top16}, 2 * top16.numel()
        ops_per_window -= _hash_ops(k, canonical, kind)
    scratch, counts = fused.minimizer_tiles(*args, **kw)
    p_scratch, p_counts = pipeline.minimizer_tiles_plain(*args[:7], tile, *args[7:], **kw)
    live = torch.arange(tile, device=chars.device) < counts[:, None]
    err = max([_max_abs_err(counts, p_counts)] + [
        _max_abs_err(g[live], p[live])
        for g, p in zip(scratch.view(-1, counts.numel(), tile),
                        p_scratch.view(-1, counts.numel(), tile))])
    del p_scratch, p_counts, live
    offsets = fused.tile_offsets(counts)
    err_o = _max_abs_err(offsets, pipeline.tile_offsets_plain(counts))
    total = int(offsets[-1])
    err_a = _max_abs_err(fused.tile_append(scratch, counts, offsets, total),
                         pipeline.tile_append_plain(scratch, counts, offsets, total, tile))
    for key, e in (("tile_offsets", err_o), ("tile_append", err_a), *errs.items()):
        rec.entries[key]["max_abs_err"] = max(rec.entries[key]["max_abs_err"], e)
        if e:
            raise RuntimeError(f"{name}: {key} disagrees with its plain version")
    planes = 2 if mode == "superkmers" else 1
    if windows is None:
        windows = max(n - (k + w - 1) + 1, 0)
    in_bytes = chars.numel() + (0 if plane is None else plane.numel()) + route_bytes
    rec.entry(name, 1631, err,
              _median_ms(lambda: fused.minimizer_tiles(*args, **route_kw), 5, 5, 2),
              _median_ms(lambda: pipeline.minimizer_tiles_plain(*args[:7], tile, *args[7:], **kw),
                         *plain_reps),
              _bound(in_bytes + 4 * (planes * total + counts.numel()),
                     windows * ops_per_window))
    del scratch, counts, offsets, route_kw
    return _median_ms(lambda: fused.fused_sketch(*args, **kw), 3, 3, 1)[0]


def _oracle_planes(b, codes, mask=None):
    """The builder's oracle on 2-bit codes: (positions[, indices])."""
    import simd_minimizers_tpu_torch as smt

    out = b.run_scalar(smt.PackedSeqVec.from_codes(codes), ambiguous=mask)
    return (out.positions,) if out.superkmer_indices is None else (
        out.positions, out.superkmer_indices)


VALUES_REPLACES = "simd_minimizers_tpu/ops/device_values.py:126"  # values_limbs_jnp
N_NUMPY_VALUES = 10**6  # positions of the NumPy gather's timed slice
N_HOST_LIMBS = 10**5  # positions of the host u128 limbs held against the card's


def _values_ops_per_position(k: int, canonical: bool) -> int:
    """Integer operations per position that the values function needs at
    least: the word index and shift (2), a funnel shift per limb and the top
    limb's mask; canonical, per limb the complement, the reversal of the
    2-bit groups (a bit reversal and a pair swap, 6), the realigning shift,
    the compare and select (3), and the complement's mask. Loads are not
    operations."""
    from simd_minimizers_tpu_torch.ops.device_values import limb_count

    L = limb_count(k)
    return 2 + L + 1 + ((1 + 6 + 1 + 3) * L + 1 if canonical else 0)


def _values_entry(rec, name, chars, pos_t, k, canonical, byte_codes=False):
    """kmer_values against its plain version on the card at a main path's
    shapes, timed and recorded as `name`; returns the kernel's limbs."""
    from simd_minimizers_tpu_torch.ops import device_values

    args = (chars, pos_t, k, canonical, byte_codes)
    got = device_values.kmer_values_limbs(*args)
    err = _max_abs_err(got, device_values.kmer_values_limbs_plain(*args))
    m = pos_t.numel()
    rec.entry(name, VALUES_REPLACES, err,
              _median_ms(lambda: device_values.kmer_values_limbs(*args), 5, 10, 2),
              _median_ms(lambda: device_values.kmer_values_limbs_plain(*args), 3, 3, 1),
              _bound(chars.numel() + 4 * m + 4 * m * device_values.limb_count(k),
                     m * _values_ops_per_position(k, canonical)), source="values.cu")
    return got


def _values(ctx):
    """k-mer values of the 1e8 bases through Output after Builder.run on the
    card: values_u64 of canonical and forward minimizers at k=21 w=11,
    values_u128_limbs of canonical k=33 and forward k=64 minimizers (w=11).
    Each main path launches kmer_values once; the kernel against its plain
    version at the same shapes, the entry point's result against the
    kernel's limbs and the host (the native extractor on 1e6 positions for
    u64, NumPy's limbs on 1e5 for u128), the kernel's time and bound, the
    warm wall of the entry point, and beside it the native extractor on
    every position and NumPy's gather on 1e6 positions, scaled."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert, native
    from simd_minimizers_tpu_torch.ops import values

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    seq = ctx["inputs"]["dna"][0]
    codes = seq.codes()
    chars = convert.packed_words(seq, dev)
    cases = (("kmer_values", smt.canonical_minimizers(K, W), "values_u64"),
             ("kmer_values [forward]", smt.minimizers(K, W), "values_u64"),
             ("kmer_values [canonical, k=33, u128 limbs]", smt.canonical_minimizers(33, W),
              "values_u128_limbs"),
             ("kmer_values [forward, k=64, u128 limbs]", smt.minimizers(64, W),
              "values_u128_limbs"))
    for name, b, method in cases:
        k, canonical = b.k, b.canonical
        out = b.run(seq, device=dev)
        pos = out.positions
        m = pos.size
        print(f"values: {name}, Output.{method}() after Builder.run on the card, {m} positions:")
        res, wall, launched, peak = _main_path(lambda: getattr(out, method)())
        print(f"  main path launches: {launched}")
        if launched != {"kmer_values": 1}:
            raise RuntimeError(f"{name}: the main path launched {launched}")
        rec.tally(launched, "kmer_values", name[len("kmer_values"):])
        pos_t = torch.from_numpy(pos.view(np.int32)).to(dev)
        limbs = _values_entry(rec, name, chars, pos_t, k, canonical).cpu().numpy().view(np.uint32)
        words = np.concatenate([limbs, np.zeros((m, limbs.shape[1] % 2), np.uint32)],
                               axis=1).view("<u8")  # rows of (lo, hi) u64
        if method == "values_u64":
            if not np.array_equal(res, words[:, 0]):
                raise RuntimeError(f"{name}: Output.values_u64 differs from the kernel's limbs")
            host = native.kmer_values_u64(codes, pos[:N_NUMPY_VALUES], k, canonical)
            if not np.array_equal(res[:N_NUMPY_VALUES], host):
                raise RuntimeError(f"{name}: the card differs from the native extractor")
            checked = f"{N_NUMPY_VALUES} positions bit-equal to the native extractor"
        else:
            hi = words[:, 1] if words.shape[1] > 1 else np.zeros(m, np.uint64)
            if not (np.array_equal(res[0], words[:, 0]) and np.array_equal(res[1], hi)):
                raise RuntimeError(f"{name}: Output.values_u128_limbs differs from the kernel")
            fn = (values.canonical_kmer_values_u128_limbs if canonical
                  else values.kmer_values_u128_limbs)
            host = fn(codes, pos[:N_HOST_LIMBS], k)
            if not all(np.array_equal(r[:N_HOST_LIMBS], h) for r, h in zip(res, host)):
                raise RuntimeError(f"{name}: the card differs from the host's u128 limbs")
            checked = f"{N_HOST_LIMBS} positions bit-equal to the host's NumPy limbs"
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            getattr(out, method)()
            walls.append((time.perf_counter() - t) * 1e3)
        line = (f"  {checked}; main path call {wall * 1e3:.2f} ms, peak extra device memory "
                f"{peak:.1f} MiB; warm Output.{method}() 3 runs {min(walls):.2f}.."
                f"{max(walls):.2f} ms")
        if method == "values_u64":
            t = time.perf_counter()
            native.kmer_values_u64(codes, pos, k, canonical)
            t_native = time.perf_counter() - t
            part = pos[:N_NUMPY_VALUES]

            def gather():  # NumPy's (m, k) gather, the host's path for text values
                fwd = values._chunked(
                    lambda p: values._pack_u64(values._gather_windows(codes, p, k), 2), part)
                return (np.minimum(fwd, values.revcomp_kmer_values_u64(codes, part, k))
                        if canonical else fwd)

            t = time.perf_counter()
            if not np.array_equal(gather(), res[:N_NUMPY_VALUES]):
                raise RuntimeError(f"{name}: NumPy's gather differs from the card")
            t_numpy = time.perf_counter() - t
            line += (f"; host: native extractor {t_native * 1e3:.1f} ms "
                     f"({t_native * 1e9 / m:.1f} ns/value), NumPy gather {t_numpy * 1e3:.1f} ms"
                     f" on {N_NUMPY_VALUES} positions ({t_numpy * 1e9 / N_NUMPY_VALUES:.1f} "
                     f"ns/value; {t_numpy * m / N_NUMPY_VALUES:.2f} s scaled to {m})")
        print(line + f"; {note}")
        if name == "kmer_values":
            _permuted_values(ctx, chars, pos, res)
        del out, res, pos_t


def _permuted_values(ctx, chars, pos, want):
    """The canonical values of the same positions in a random order, a
    main path through `device_values.kmer_values_u64` (which takes any u32
    positions): each value equals the sorted run's, and the kernel on the
    permuted positions against its plain version."""
    import numpy as np
    import torch

    from simd_minimizers_tpu_torch.ops import device_values

    perm = np.random.default_rng(ctx["seed"] + 13).permutation(pos.size)
    res, wall, launched, _ = _main_path(
        lambda: device_values.kmer_values_u64(chars, pos[perm], K, True))
    name = "kmer_values [canonical, permuted positions]"
    print(f"values: {name}, {pos.size} positions: main path launches {launched}, wall "
          f"{wall * 1e3:.2f} ms")
    if launched != {"kmer_values": 1}:
        raise RuntimeError(f"{name}: the main path launched {launched}")
    if not np.array_equal(res, want[perm]):
        raise RuntimeError(f"{name}: the values differ from the sorted positions' values")
    ctx["rec"].tally(launched, "kmer_values", name[len("kmer_values"):])
    pos_t = torch.from_numpy(pos[perm].view(np.int32)).to(ctx["dev"])
    _values_entry(ctx["rec"], name, chars, pos_t, K, True)


def _bus(ctx):
    """The bus alone, 256 MiB each way, 3 runs each after a warm-up: device
    to host into a new pageable tensor (`.cpu()`), into pinned memory asked
    of PyTorch's pinned-memory allocator per copy (as `convert.Download`
    does), and into one pinned buffer held across copies; host to device
    from pageable and from pinned memory. Tells the copy itself from the
    allocation around it."""
    import torch

    dev, note = ctx["dev"], ctx["card_note"]
    nbytes = 256 << 20
    src = torch.zeros(nbytes // 4, dtype=torch.int32, device=dev)
    kept = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host = torch.zeros(src.shape, dtype=src.dtype)

    def allocator_pinned():
        torch.empty(src.shape, dtype=src.dtype, pin_memory=True).copy_(src, non_blocking=True)

    cases = (("device to host, pageable .cpu()", lambda: src.cpu()),
             ("device to host, pinned per copy", allocator_pinned),
             ("device to host, pinned held", lambda: kept.copy_(src, non_blocking=True)),
             ("host to device, pageable", lambda: src.copy_(host)),
             ("host to device, pinned", lambda: src.copy_(kept, non_blocking=True)))
    print(f"bus: {nbytes >> 20} MiB each way, 3 runs after one warm-up:")
    for name, fn in cases:
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        ts = sorted(ts[1:])
        print(f"  {name}: {ts[1] * 1e3:.2f} ms ({ts[0] * 1e3:.2f}..{ts[-1] * 1e3:.2f}), "
              f"{nbytes / ts[1] / 1e9:.2f} GB/s; {note}")
    del src, kept, host


def _long_sequence(ctx):
    """One random PackedSeqVec of 2^31 + 2^26 bases, canonical k=21 w=11,
    through Builder.run(device="cuda"): the spans of sketch_long, each a
    view of the one upload."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline, spans

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    l = K + W - 1
    print(f"long sequence: canonical minimizers of {N_LONG} random bases, Builder.run:")
    rng = np.random.default_rng(ctx["seed"] + 2)
    t = time.perf_counter()
    seq = smt.PackedSeq(rng.integers(0, 256, N_LONG // 4, dtype=np.uint8), 0, N_LONG)
    print(f"  input: {N_LONG // 4} random packed bytes ({time.perf_counter() - t:.2f} s)")
    b = smt.canonical_minimizers(K, W)
    nspans = len(spans.span_bounds(N_LONG, l, spans.SPAN_CHARS))
    out, wall, launched, peak = _main_path(lambda: b.run(seq, device=dev))
    instance = fused.instance_name(True, pipeline.MODE_MINIMIZERS, False)
    _expect_launches("long sequence", launched, instance, nspans)
    rec.tally(launched, instance, LONG_VARIANT)
    pos = out.positions
    nw = N_LONG - l + 1
    steps = np.diff(pos.astype(np.int64))
    back = steps[steps <= 0]
    density = pos.size / nw
    print(f"  {pos.size} positions in {nspans} spans; wall {wall * 1e3:.1f} ms "
          f"({N_LONG / wall / 1e9:.3f} Gbp/s); peak extra device memory {peak:.1f} MiB; "
          f"density {density:.4f}; max position {int(pos.max())}; {note}")
    if pos.dtype != np.uint32 or int(pos.max()) >= N_LONG or int(pos.max()) < LONG_CHECK[1]:
        raise RuntimeError("long sequence: positions are not u32, below n and past the "
                           "checked windows")
    if abs(density - 2 / (W + 1)) > 0.01:
        raise RuntimeError(f"long sequence: density {density}")
    # canonical positions increase, except where a tie of top-16 keys meets a
    # strand flip: the next window's other arm picks an earlier k-mer of the
    # tie, at most w - 1 back (ties at 16 bits occur at random)
    print(f"  positions: {steps.size - back.size} rises, {back.size} steps back "
          f"(tie flips), each less than w: {bool(np.all(back > -W))}")
    if back.size > 1e-3 * pos.size or np.any(back <= -W) or np.any(back == 0):
        raise RuntimeError("long sequence: positions do not increase as minimizers do")

    # windows [2^31 - 2^25, 2^31 + 2^25): the plain version on that char
    # slice, plus the slice's start, all but its first value (whose dedup
    # predecessor lies before the slice)
    a, e = LONG_CHECK
    chars = torch.from_numpy(seq.data[a // 4:-(-(e + l - 1) // 4)]).to(dev)
    (kind, canonical, rot), tables = convert.hasher_tensors(b._resolved_hasher(), dev)
    plain = pipeline.run_pipeline(chars, e - a + l - 1, K, W, tables, rot, canonical)
    want = plain.cpu().numpy().view(np.uint32)[1:].astype(np.int64) + a
    del chars, plain
    lo = int(np.searchsorted(pos, want[0] - 4 * W))
    hits = [j for j in range(lo, lo + 64)
            if np.array_equal(pos[j:j + want.size].astype(np.int64), want)]
    print(f"  windows [{a}, {e}): {want.size} values from the plain version found at "
          f"{hits[:1]}, bit-equal")
    if not hits:
        raise RuntimeError("long sequence: the slice around 2^31 differs from the plain version")

    # the kernel path alone, device-resident, eager and in waves
    words = convert.packed_words(seq, dev)
    h = b._resolved_hasher()
    for budget in (0, 4 << 30):
        t = _median_ms(lambda: spans.sketch_long(words, N_LONG, K, W, h, wave_bytes=budget),
                       3, 1, 1)
        print(f"  sketch_long kernel path ({'eager' if not budget else 'waves of 4 GiB'}): "
              f"{t[0]:.2f} ms ({t[1]:.2f}..{t[2]:.2f}; {t[0] * 1e6 / N_LONG:.5f} ns/char); "
              f"bound {_bound(0, nw * _tiles_ops_per_window(K, True, 'nt', False, False))[0]:.2f}"
              f" ms; {note}")

    # each kernel against its plain version on two of the path's own
    # launches: a full span, and the last one, whose offset is 2^31 - 16384
    # and whose positions pass 2^31
    del out, pos
    torch.cuda.empty_cache()
    ops = _tiles_ops_per_window(K, True, "nt", False, False)
    for s, m in spans.span_bounds(N_LONG, l, spans.SPAN_CHARS)[-2:]:
        kt = _tiles_check(rec, instance + LONG_VARIANT,
                          (convert.span(words, s, s + m, 4), m, K, W, tables, rot, canonical,
                           pipeline.MODE_MINIMIZERS, None), {"offset": s}, ops,
                          plain_reps=(3, 1, 0))
        print(f"  span at offset {s} ({m} chars): bit-equal to the plain version; kernel path "
              f"{kt:.3f} ms")
    del words, seq


def _long_sweep(ctx, chars, plane):
    """At 1e8 bases, sketch_long in 2^24-char spans for every mode with and
    without a mask, both strands, bit-equal to one launch, which is held
    against its plain version."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline, spans

    dev, rec = ctx["dev"], ctx["rec"]
    span = SWEEP_SPAN
    nspans = len(spans.span_bounds(N, K + W - 1, span))
    print(f"long sweep: every mode in {nspans} spans of {span} chars over {N} bases:")
    for mode in pipeline.MODES:
        for canonical in (True, False):
            for amb in (None, plane):
                h = smt.NtHasher(K, canonical=canonical)
                res, wall, launched, _ = _main_path(lambda: spans.sketch_long(
                    chars, N, K, W, h, mode, amb, span_chars=span))
                instance = fused.instance_name(canonical, mode, amb is not None)
                _expect_launches(f"sweep {instance}", launched, instance, nspans)
                rec.tally(launched, instance, "")
                (kind, can, rot), tables = convert.hasher_tensors(h, dev)
                args = (chars, N, K, W, tables, rot, can, mode, amb)
                one = fused.fused_sketch(*args)
                plain = pipeline.run_pipeline(*args)
                got, one, plain = ((x,) if mode != pipeline.MODE_SUPERKMERS else x
                                   for x in (res, one, plain))
                if not all(torch.equal(g, o) and torch.equal(o, p)
                           for g, o, p in zip(got, one, plain, strict=True)):
                    raise RuntimeError(f"sweep {instance}: spans, one launch and the plain "
                                       "version disagree")
                print(f"  {instance}: {got[0].numel()} values, spans == one launch == plain; "
                      f"wall {wall * 1e3:.2f} ms")
                if mode == pipeline.MODE_SUPERKMERS and amb is not None:
                    m = spans.span_bounds(N, K + W - 1, span)[0][1]
                    _tiles_check(rec, instance, (chars[:-(-m // 4)], m, K, W, tables, rot, can,
                                                 mode, amb[:-(-m // 8)]), {},
                                 _tiles_ops_per_window(K, can, "nt", False, True))
                del res, one, plain, got


def _chromosome_records(ctx):
    """GRCh38's 24 primary chromosomes at their lengths and N_CONTIGS
    contigs of 10-200 kbp: random codes (one byte per base, made on the card
    from the seed) and chromosome-shaped masks scaled to each length."""
    import numpy as np
    import torch

    from simd_minimizers_tpu_torch.tools.fasta_ingest import CONTIG_BP, GRCH38, N_CONTIGS

    rng = np.random.default_rng(ctx["seed"] + 3)
    lens = [n for _, n in GRCH38] + [int(x) for x in rng.integers(CONTIG_BP[0], CONTIG_BP[1] + 1,
                                                                   N_CONTIGS)]
    names = [c for c, _ in GRCH38] + [f"contig{i}" for i in range(N_CONTIGS)]
    g = torch.Generator(device=ctx["dev"]).manual_seed(ctx["seed"])
    flat = torch.randint(0, 4, (sum(lens),), dtype=torch.uint8, device=ctx["dev"],
                         generator=g).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(lens)])
    codes = [flat[a:e] for a, e in zip(starts[:-1], starts[1:])]
    masks = [_chromosome_mask(n, rng) for n in lens]
    return names, codes, masks


def _genome(ctx):
    """A genome of records, canonical skip-ambiguous k=21 w=11, through
    backend.sketch_records(..., dna=True, device="cuda"); then chr21 and
    chr22 as a FASTA through the sketch_fasta CLI."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import backend, batch, fused, pipeline, spans
    from simd_minimizers_tpu_torch.tools.fasta_ingest import GRCH38, N_CONTIGS

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    l = K + W - 1
    t = time.perf_counter()
    names, codes, masks = _chromosome_records(ctx)
    total = sum(c.size for c in codes)
    print(f"genome: {len(codes)} records ({len(GRCH38)} at GRCh38's chromosome lengths, "
          f"{N_CONTIGS} contigs), {total} bp, {sum(int(m.sum()) for m in masks)} Ns "
          f"({time.perf_counter() - t:.2f} s)")
    h = smt.NtHasher(K, canonical=True)
    b = smt.canonical_minimizers(K, W)

    def run(**kw):
        return backend.sketch_records(codes, K, W, h, pipeline.MODE_MINIMIZERS, masks,
                                      dna=True, device=dev, batch_max_bp=BATCH_MAX_BP, **kw)

    out, wall, launched, peak = _main_path(run)
    small = [i for i, c in enumerate(codes) if l <= c.size <= BATCH_MAX_BP]
    n_launch = (sum(len(spans.span_bounds(c.size, l, spans.SPAN_CHARS))
                    for i, c in enumerate(codes) if i not in set(small))
                + len({batch._stride_bucket(codes[i].size + 1) for i in small}))
    instance = fused.instance_name(True, pipeline.MODE_MINIMIZERS, True)
    _expect_launches("genome", launched, instance, n_launch)
    rec.tally(launched, instance, " [codes, nt]")
    kept = sum(o.size for o in out)
    print(f"  {kept} positions; wall {wall:.3f} s ({total / wall / 1e9:.3f} Gbp/s); "
          f"peak extra device memory {peak:.1f} MiB; {note}")

    # every record against the plain version of that record on the card
    (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
    for name, c, m, o in zip(names, codes, masks, out):
        chars = convert.code_bytes(c, dev)
        amb = convert.ambiguity_plane(m, c.size, dev)
        plain = pipeline.run_pipeline(chars, c.size, K, W, tables, rot, canonical,
                                      pipeline.MODE_MINIMIZERS, amb, byte_codes=True)
        if not np.array_equal(plain.cpu().numpy().view(np.uint32), o):
            raise RuntimeError(f"genome: {name} differs from the plain version")
        del chars, amb, plain
    print(f"  every record bit-equal to the plain version on the card")
    for i in (0, 20, len(GRCH38)):
        want = _oracle_planes(b, codes[i][:N_ORACLE], masks[i][:N_ORACLE])[0]
        if not np.array_equal(out[i][:want.size], want):
            raise RuntimeError(f"genome: {names[i]} differs from the oracle")
    print(f"  {names[0]}, {names[20]}, {names[len(GRCH38)]}: first {N_ORACLE} bases bit-equal "
          "to the oracle on the CPU")

    # the kernel path alone: every launch of the run on device-resident input
    big = [i for i in range(len(codes)) if i not in set(small)]
    launches = []
    for i in big:
        chars = convert.code_bytes(codes[i], dev)
        amb = convert.ambiguity_plane(masks[i], codes[i].size, dev)
        for s, n in spans.span_bounds(codes[i].size, l, spans.SPAN_CHARS):
            launches.append((chars[s:s + n], n, amb[s // 8:-(-(s + n) // 8)], s))
    batch_launches = [(c, n, p, 0) for _, _, c, n, p in batch.launches(
        [codes[i] for i in small], [masks[i] for i in small], l, dev)]

    def kernel_path(items):
        return [fused.fused_sketch(c, n, K, W, tables, rot, canonical, pipeline.MODE_MINIMIZERS,
                                   p, offset=s, byte_codes=True) for c, n, p, s in items]

    kt = _median_ms(lambda: kernel_path(launches + batch_launches), 3, 1, 1)
    results = kernel_path(launches + batch_launches)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in results:
        convert.Download(r).result()
    t_pinned = time.perf_counter() - t
    t = time.perf_counter()
    for r in results:
        r.cpu()
    t_pageable = time.perf_counter() - t
    windows = sum(max(c.size - l + 1, 0) for c in codes)
    bound = _bound(0, windows * _tiles_ops_per_window(K, True, "nt", True, True))
    print(f"  summed kernel path {kt[0]:.2f} ms ({kt[1]:.2f}..{kt[2]:.2f}; "
          f"{kt[0] * 1e6 / total:.5f} ns/bp) over {len(launches)} span and "
          f"{len(batch_launches)} batch launches; bound {bound[0]:.2f} ms ({bound[1]}); "
          f"download of {sum(r.numel() for r in results) * 4 / 1e9:.3f} GB: pinned "
          f"{t_pinned * 1e3:.1f} ms, pageable {t_pageable * 1e3:.1f} ms; {note}")
    chr1 = launches[0]
    kt1 = _tiles_check(rec, instance + " [codes, nt]",
                       (chr1[0], chr1[1], K, W, tables, rot, canonical,
                        pipeline.MODE_MINIMIZERS, chr1[2]), {"byte_codes": True},
                       _tiles_ops_per_window(K, True, "nt", True, True), plain_reps=(2, 1, 0))
    print(f"  {names[0]} kernel path {kt1:.3f} ms")
    del launches, batch_launches, results

    # eager against wave scheduling, wall time of the entry, in turns
    for budget, label in ((0, "eager"), (4 << 30, "waves of 4 GiB"), (4 << 30, "waves of 4 GiB"),
                          (0, "eager")):
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = run(wave_bytes=budget)
        dt = time.perf_counter() - t
        same = all(np.array_equal(a, o) for a, o in zip(again, out))
        print(f"  sketch_records {label}: wall {dt:.3f} s ({total / dt / 1e9:.3f} Gbp/s), "
              f"equal {same}; {note}")
        if not same:
            raise RuntimeError("genome: the schedules disagree")
        del again
    _split_print("sketch_records", lambda: run())
    _fasta(ctx, names, codes, masks, out)


def _split_print(what, fn):
    """One more call of an entry point with its wall time split into stages
    (utils/profiling.split_wall: each stage waits for the card, so copies
    no longer overlap kernels), printed beside the wall of the whole."""
    import torch

    from simd_minimizers_tpu_torch.utils.profiling import split_wall

    torch.cuda.synchronize()
    with split_wall() as parts:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    print(f"  {what} wall split (each stage waits for the card): {wall:.3f} s = "
          + ", ".join(f"{name} {sec:.3f}" for name, sec in parts.items())
          + f", outside the stages {wall - sum(parts.values()):.3f} s")


def _fasta(ctx, names, codes, masks, out):
    """chr21 and chr22 as a FASTA (60-char lines, N runs, lowercase
    stretches) through `python -m simd_minimizers_tpu_torch.sketch_fasta
    --values`; its .npz must equal sketch_records on the parsed records and
    the native extractor's values. Then the CLI's values step
    (`sketch_fasta.record_values`: kmer_values on the records' code bytes)
    as a main path, and the kernel on chr21's code bytes against its plain
    version."""
    import os
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert, native, sketch_fasta
    from simd_minimizers_tpu_torch.ops import backend, pipeline
    from simd_minimizers_tpu_torch.seq.fasta import read_fasta

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    try:
        rng = np.random.default_rng(ctx["seed"] + 4)
        path = os.path.join(tmp, "chr21_22.fa")
        pick = [names.index("chr21"), names.index("chr22")]
        with open(path, "wb") as f:
            for i in pick:
                seq = np.frombuffer(b"ACTG", np.uint8)[codes[i]]  # code order
                seq[masks[i]] = ord("N")
                for a, n in zip(rng.integers(0, seq.size, 100), rng.integers(1000, 50_001, 100)):
                    seq[a:a + n] |= 0x20
                f.write(f">{names[i]} GRCh38-length random\n".encode())
                lines = -(-seq.size // 60)
                body = np.full((lines, 61), ord("\n"), np.uint8)
                flat = np.zeros(lines * 60, np.uint8)
                flat[:seq.size] = seq
                body[:, :60] = flat.reshape(lines, 60)
                last = (lines - 1) * 61 + seq.size - (lines - 1) * 60
                f.write(body.ravel()[:last].tobytes() + b"\n")
        bp = sum(codes[i].size for i in pick)
        torch.cuda.empty_cache()
        npz = os.path.join(tmp, "sketch.npz")
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "simd_minimizers_tpu_torch.sketch_fasta",
                              path, "--k", str(K), "--w", str(W), "--canonical",
                              "--skip-ambiguous", "--values", "--out", npz, "--device",
                              ctx["dev"].type],
                             cwd=root, capture_output=True, text=True, timeout=600)
        cli = time.perf_counter() - t
        if res.returncode != 0:
            raise RuntimeError(f"sketch_fasta failed ({res.returncode}):\n{res.stderr}")
        staged = sum(float(x) for x in re.findall(r"(\d+\.\d+)s\b", res.stderr))
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import simd_minimizers_tpu_torch"], cwd=root,
                       check=True, timeout=600)
        start = time.perf_counter() - t
        print(f"FASTA: {bp} bp of chr21 and chr22 ({os.path.getsize(path)} bytes); "
              f"sketch_fasta CLI {cli:.2f} s wall: " + " | ".join(res.stderr.strip().splitlines())
              + f" | outside these stages {cli - staged:.2f} s (a process that only imports "
              f"the package: {start:.2f} s)")
        t = time.perf_counter()
        recs = read_fasta(path)
        parse = time.perf_counter() - t
        if [r.name for r in recs] != ["chr21", "chr22"]:
            raise RuntimeError(f"FASTA: records {[r.name for r in recs]}")
        for r, i in zip(recs, pick):
            if not (np.array_equal(r.ambiguous.astype(bool), masks[i])
                    and np.array_equal(r.codes[~masks[i]], codes[i][~masks[i]])):
                raise RuntimeError(f"FASTA: {r.name} parsed differently from what was written")
        want = backend.sketch_records([r.codes for r in recs], K, W,
                                      smt.NtHasher(K, canonical=True), pipeline.MODE_MINIMIZERS,
                                      [r.ambiguous for r in recs], dna=True, device=ctx["dev"])
        got = np.load(npz)
        files = sorted(f"{r.name}/{part}" for r in recs for part in ("positions", "values"))
        if sorted(got.files) != files or not all(
                np.array_equal(got[f"{r.name}/positions"], p) for r, p in zip(recs, want)):
            raise RuntimeError("FASTA: the CLI's .npz differs from sketch_records")
        if not all(np.array_equal(p, out[i]) for p, i in zip(want, pick)):
            raise RuntimeError("FASTA: the parsed records sketch differently from the codes")
        t = time.perf_counter()
        host = [native.kmer_values_u64(r.codes, p, K, True) for r, p in zip(recs, want)]
        t_host = time.perf_counter() - t
        if not all(np.array_equal(got[f"{r.name}/values"], v) for r, v in zip(recs, host)):
            raise RuntimeError("FASTA: the CLI's values differ from the native extractor")
        print(f"  parse {parse:.3f} s ({bp / parse / 1e9:.3f} Gbp/s); the .npz equals "
              "sketch_records on the parsed records and on the written codes, its values the "
              f"native extractor's ({t_host:.3f} s for {sum(p.size for p in want)} values)")
        vals, wall, launched, _ = _main_path(lambda: [
            sketch_fasta.record_values(r.codes, p, K, True, ctx["dev"])
            for r, p in zip(recs, want)])
        print(f"  the CLI's values step on the card: main path launches {launched}, wall "
              f"{wall * 1e3:.1f} ms")
        if launched != {"kmer_values": len(recs)}:
            raise RuntimeError(f"FASTA: the values step launched {launched}")
        if not all(np.array_equal(v, h) for v, h in zip(vals, host)):
            raise RuntimeError("FASTA: the values step differs from the native extractor")
        variant = " [code bytes]"
        ctx["rec"].tally(launched, "kmer_values", variant)
        chars = convert.code_bytes(recs[0].codes, ctx["dev"])
        pos_t = torch.from_numpy(want[0].view(np.int32)).to(ctx["dev"])
        _values_entry(ctx["rec"], "kmer_values" + variant, chars, pos_t, K, True,
                      byte_codes=True)
        del chars, pos_t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _slots_entry(rec, rows, dev):
    """ascii_slots against its plain version on the card at the read
    matrix's shapes (one launch of all its rows), timed and recorded."""
    import torch

    from simd_minimizers_tpu_torch.ops import batch, fused, pipeline

    t = torch.from_numpy(rows).to(dev)
    stride = batch._stride_bucket(rows.shape[1] + 1)
    dna = torch.ones(1, dtype=torch.int32, device=dev)
    got = fused.ascii_slots(t, stride, dna)
    want = pipeline.ascii_slots_plain(t, stride, torch.ones_like(dna))
    err = _max_abs_err(got, want)
    n = rows.shape[0] * stride
    rec.entry("ascii_slots", "simd_minimizers_tpu/api.py:279", err,
              _median_ms(lambda: fused.ascii_slots(t, stride, dna), 5, 10, 2),
              _median_ms(lambda: pipeline.ascii_slots_plain(t, stride, dna), 3, 3, 1),
              _bound(rows.size + n + -(-n // 8), 0), source="slots.cu")


def _read_batches(ctx):
    """Builder.run_batch: 1,000,000 random 150 bp reads (canonical
    minimizers), then 20,000 reads of 100-10,000 bp as forward minimizers
    with a 1% N mask and as canonical super-k-mers."""
    import numpy as np

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import batch, fused, pipeline

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    l = K + W - 1
    rng = np.random.default_rng(ctx["seed"] + 5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    short = acgt[rng.integers(0, 4, (N_SHORT_READS, SHORT_READ), dtype=np.uint8)]
    lens = rng.integers(100, 10_001, N_LONG_READS)
    long_reads = [acgt[rng.integers(0, 4, int(n), dtype=np.uint8)].tobytes() for n in lens]
    long_masks = [(rng.random(int(n)) < 0.01).astype(np.uint8) for n in lens]
    runs = [(f"{N_SHORT_READS} reads of {SHORT_READ} bp, canonical minimizers",
             smt.canonical_minimizers(K, W), short, None),
            (f"{N_LONG_READS} reads of 100-10,000 bp, forward minimizers, 1% N",
             smt.minimizers(K, W), long_reads, long_masks),
            (f"{N_LONG_READS} reads of 100-10,000 bp, canonical super-k-mers",
             smt.canonical_minimizers(K, W).super_kmers(), long_reads, None)]
    for name, b, reads, masks in runs:
        print(f"read batch: {name}:")
        got, wall, launched, peak = _main_path(lambda: b.run_batch(reads, ambiguous=masks,
                                                                   device=dev))
        mode = b._mode
        instance = fused.instance_name(b.canonical, mode, True)
        codes = (short >> 1) & 3 if reads is short else [
            np.frombuffer(r, np.uint8) >> 1 & 3 for r in reads]
        items = list(batch.launches(codes, masks, l, dev))
        _expect_launches(name, launched, instance, len(items),
                         slots=len(items) if reads is short else 0)
        rec.tally(launched, instance, " [codes, nt]")
        nreads = len(reads)
        windows = (sum(max(len(r) - l + 1, 0) for r in reads) if reads is not short
                   else short.shape[0] * (short.shape[1] - l + 1))
        h = b._resolved_hasher()
        (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
        plain = batch.sketch_batch(codes, K, W, h, mode, masks, dna=True, device=dev,
                                   backend="pipeline")
        if not all(np.array_equal(g, p) for g, p in zip(got, plain, strict=True)):
            raise RuntimeError(f"{name}: differs from the plain version of the same launches")
        rid, *planes = got
        bounds = np.searchsorted(rid, np.arange(N_READ_ORACLE + 1))
        for i in range(N_READ_ORACLE):
            want = (_oracle_planes(b, codes[i], None if masks is None else masks[i])
                    if len(codes[i]) >= l else ((np.zeros(0, np.uint32),) * len(planes)))
            for p, wp in zip(planes, want, strict=True):
                if not np.array_equal(p[bounds[i]:bounds[i + 1]], wp):
                    raise RuntimeError(f"{name}: read {i} differs from the oracle")
        kt = _median_ms(lambda: [fused.fused_sketch(c, n, K, W, tables, rot, canonical, mode, p,
                                                    byte_codes=True)
                                 for _, _, c, n, p in items], 3, 1, 1)
        bound = _bound(0, windows * _tiles_ops_per_window(K, canonical, "nt", True, True))
        print(f"  {planes[0].size} values over {len(items)} launches; wall {wall:.3f} s "
              f"({nreads / wall / 1e6:.3f} M reads/s); kernel path {kt[0]:.2f} ms "
              f"({kt[1]:.2f}..{kt[2]:.2f}; {nreads / kt[0] / 1e3:.3f} M reads/s); bound "
              f"{bound[0]:.3f} ms over {windows} owned windows; peak extra device memory "
              f"{peak:.1f} MiB; bit-equal to the plain launches and, for {N_READ_ORACLE} reads, "
              f"to the oracle; {note}")
        _split_print("run_batch", lambda: b.run_batch(reads, ambiguous=masks, device=dev))
        if reads is short:
            _slots_entry(rec, short, dev)
        widest = max(items, key=lambda it: it[3])
        _tiles_check(rec, instance + " [codes, nt]",
                     (widest[2], widest[3], K, W, tables, rot, canonical, mode, widest[4]),
                     {"byte_codes": True}, _tiles_ops_per_window(K, canonical, "nt", True, True),
                     plain_reps=(2, 1, 0),
                     windows=sum(max(len(codes[i]) - l + 1, 0) for i in widest[0]))
        del items, plain, got


# One Builder.run of the 1e8 bases on the CPU, in a process of its own:
# argv seed, n, k, w, and "chunked" (the spans a CPU tensor takes) or
# "whole" (one launch of the plain version); prints its wall, its resident
# memory before the run (/proc/self/statm), its peak (resource.getrusage's
# ru_maxrss, and the largest of statm read every 5 ms during the run), and
# a digest of the positions.
CPU_ROUTE_SCRIPT = """
import hashlib, json, resource, sys, threading, time
sys.modules["jax"] = None
sys.modules["simd_minimizers_tpu"] = None
import numpy as np
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch.ops import spans
def rss_mib():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 2**20
seed, n, k, w = map(int, sys.argv[1:5])
if sys.argv[5] == "whole":
    spans.PIPELINE_CHUNK_WINDOWS = 1 << 40
seq = smt.PackedSeqVec.random(n, np.random.default_rng(seed))
before = rss_mib()
sampled, done = [before], threading.Event()
def sample():
    while not done.wait(0.005):
        sampled.append(rss_mib())
sampler = threading.Thread(target=sample)
sampler.start()
t = time.perf_counter()
out = smt.canonical_minimizers(k, w).run(seq, device="cpu")
wall = time.perf_counter() - t
done.set()
sampler.join()
print(json.dumps({"wall_s": wall, "rss_before_mib": before,
                  "ru_maxrss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                  "sampled_peak_mib": max(sampled), "count": int(out.positions.size),
                  "sha256": hashlib.sha256(out.positions.tobytes()).hexdigest()}))
"""
# Starts its arguments as a process of its own. A process that exec's keeps
# the peak resident size of the process it was forked from as its
# ru_maxrss: started from this small one, the measured process reports its
# own peak, not this script's many GiB.
LAUNCHER = "import subprocess, sys; sys.exit(subprocess.run(sys.argv[1:]).returncode)"


def _cpu_route(ctx):
    """Builder.run(device="cpu") of the 1e8 bases (canonical k=21 w=11) in
    a process of its own, on the bounded route (spans of
    PIPELINE_CHUNK_WINDOWS windows) and as one launch of the plain version:
    wall time and peak RSS of each, the same positions as the card's."""
    import hashlib
    import json
    import os
    import subprocess

    import simd_minimizers_tpu_torch as smt

    seq = ctx["inputs"]["dna"][0]
    card = smt.canonical_minimizers(K, W).run(seq, device=ctx["dev"]).positions
    digest = hashlib.sha256(card.tobytes()).hexdigest()
    root = os.path.dirname(os.path.abspath(__file__))
    for route in ("chunked", "whole"):
        res = subprocess.run([sys.executable, "-c", LAUNCHER, sys.executable, "-c",
                              CPU_ROUTE_SCRIPT, str(ctx["seed"]), str(N), str(K), str(W), route],
                             cwd=root, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"CPU route ({route}) failed ({res.returncode}):\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        before = got["rss_before_mib"]
        print(f"CPU route, {route}: Builder.run(device='cpu') of {N} bases, canonical k={K} "
              f"w={W}: wall {got['wall_s']:.2f} s; resident {before:.0f} MiB before, peak "
              f"{got['ru_maxrss_mib']:.0f} MiB by getrusage (extra "
              f"{got['ru_maxrss_mib'] - before:.0f} MiB), {got['sampled_peak_mib']:.0f} MiB "
              f"sampled (extra {got['sampled_peak_mib'] - before:.0f} MiB); {got['count']} "
              f"positions, equal to the card's: {got['sha256'] == digest}; host of "
              f"{ctx['card_note']}")
        if got["sha256"] != digest or got["count"] != card.size:
            raise RuntimeError(f"CPU route ({route}): positions differ from the card's")


N_LARGE_CHECK = 10**7  # chars at which the large-w launches are held against the plain version


def _oracle_threaded(b, codes, mask=None, sels=None):
    """The builder's oracle (`run_scalar`'s functions) on uint8 codes, its
    windows split among 8 threads (the window argmin is O(w) per window;
    NumPy releases the GIL in it): (positions[, indices]). `sels` keeps the
    selected stream of each (hasher, w, input, mask) for the next mode."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from simd_minimizers_tpu_torch.ops import oracle, pipeline
    from simd_minimizers_tpu_torch.utils.bits import SKIPPED

    k, w, h = b.k, b.w, b._resolved_hasher()
    key = (h.kind, h.canonical, h.seed, w, codes.size, bool(codes.max() > 3), mask is None)
    sels = {} if sels is None else sels
    if key in sels:
        return _collect(b, sels[key], mask is not None)
    l = k + w - 1
    nw = codes.size - l + 1
    step = -(-nw // 64)

    def part(s):
        e = min(s + step, nw)
        sel = oracle.selected_stream(codes[s:e + l - 1], k, w, h,
                                     None if mask is None else mask[s:e + l - 1])
        return np.where(sel == SKIPPED, sel, sel + np.uint32(s)).astype(np.uint32)

    with ThreadPoolExecutor(8) as ex:
        sels[key] = np.concatenate(list(ex.map(part, range(0, nw, step))))
    return _collect(b, sels[key], mask is not None)


def _collect(b, sel, masked: bool):
    """The builder's planes from the oracle's selected stream."""
    from simd_minimizers_tpu_torch.ops import oracle, pipeline

    mode, w = b._mode, b.w
    if mode in pipeline.SYNCMER_MODES:
        return (oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS),)
    if mode == pipeline.MODE_SUPERKMERS:
        return oracle.collect_and_dedup_with_index(sel)
    return (oracle.collect_and_dedup(sel, skip_sentinel=masked),)


N_ORACLE_LARGE_W = 3 * 10**5  # chars of the oracle check of the other large-w paths
# each large-w path's route given its tops at 1e8 chars before the route
# scanned its blocks without bank conflicts and read its chars as a T/G bit
# plane (ms; this script on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md
# section 5), printed beside this run's
ROUTE_MS_BEFORE = [6.6486, 5.5819, 3.4580, 6.6620, 2.9574, 6.1364, 6.1557]
# each path's kmer_top16 at 1e8 chars before its prefix-XOR redesign (ms;
# this script on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md section 5)
TOP16_MS_BEFORE = [0.1880, 0.1599, 0.2484, 0.1858, 0.1618, 0.1846, 0.1840]
TOP16_K = (31, 63)  # the pre-pass alone at these k too (canonical nt, the same 1e8 bases)


def _large_w(ctx):
    """Large w at 1e8 chars through Builder.run(device="cuda"): the large-w
    route of minimizer_tiles, after its pre-pass kmer_top16. At 1e8 the
    pre-pass and the route given its tops timed apart, each beside its
    bound, and the wrapper (both); on the first path kmer_top16 against its
    plain version and timed beside it (the kernels line). Each launch against
    its plain version at 1e7 chars, kmer_top16 too, each path against the
    oracle (card and oracle on the same input; the oracle is O(w) per
    window): canonical w = 32,767 at 1e6 chars, the others at 3e5; the
    density of forward closed syncmers."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    (seq, mask), (text, _) = ctx["inputs"]["dna"], ctx["inputs"]["text"]
    k = K
    MIN, SKM, CLOSED = (pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS,
                        pipeline.MODE_CLOSED_SYNCMERS)
    # (name, builder, mask?, input, expected density or None, oracle chars).
    # Forward nt keeps the random-minimizer density; canonical rises far
    # above 2/(w+1) at large w (ties of the top 16 bits between the two
    # arms' picks, the oracle alike: 11x at w = 32,767), so it is printed and
    # held by equality
    big, small_n = N_ORACLE, N_ORACLE_LARGE_W
    paths = [
        ("canonical minimizers", smt.canonical_minimizers(k, 32_767), False, "dna", None, big),
        ("forward minimizers, chromosome mask", smt.minimizers(k, 61_439), True, "dna", None,
         small_n),
        ("text, forward mul minimizers", smt.minimizers(k, 32_767).hasher(smt.MulHasher(k)),
         False, "text", None, small_n),
        ("canonical super-k-mers", smt.canonical_minimizers(k, 32_767).super_kmers(), False,
         "dna", None, big),
        ("forward closed syncmers", smt.closed_syncmers(k, 32_767), False, "dna", 2 / 32_767,
         small_n),
        ("canonical minimizers, w = 21,721 (inside the old gate)",
         smt.canonical_minimizers(k, 21_721), False, "dna", None, small_n),
        ("canonical minimizers, w = 21,723 (past the old gate)",
         smt.canonical_minimizers(k, 21_723), False, "dna", None, small_n),
    ]
    small_rng = np.random.default_rng(ctx["seed"] + 7)
    small_codes = small_rng.integers(0, 4, N_ORACLE, dtype=np.uint8)
    small_text = small_rng.integers(32, 127, N_ORACLE, dtype=np.uint8)
    # isolated flags (20 per 1e6 chars), so that some windows of w = 61,439
    # hold none and the masked path keeps values to compare
    small_mask = np.zeros(N_ORACLE, bool)
    small_mask[small_rng.integers(0, N_ORACLE, 20)] = True
    sels = {}
    grids = [fused.top16_grid(K, c, device=dev) for c in (True, False)]
    print(f"large w: kmer_top16's persistent grid at k={K} on 2-bit input: canonical "
          f"{grids[0][0]} blocks of {grids[0][1]} B of shared memory, forward {grids[1][0]} of "
          f"{grids[1][1]} B ({torch.cuda.get_device_properties(dev).multi_processor_count} SMs)")
    for (name, b, masked, inp, density_want, n_oracle), before, top_before in zip(
            paths, ROUTE_MS_BEFORE, TOP16_MS_BEFORE, strict=True):
        w, mode = b.w, b._mode
        l = k + w - 1
        s_in = text if inp == "text" else seq
        geometry = (k, w, b.canonical, mode, masked, inp == "text", b._resolved_hasher().kind)
        blocks, smem = fused.tiles_occupancy(*geometry, device=dev)
        print(f"large w: {name}, k={k} w={w} ({inp}; sub_tile {fused.sub_tile(*geometry)}; "
              f"{smem} B of dynamic shared memory a block, {blocks} blocks per SM):")
        out, wall, launched, peak = _main_path(
            lambda: b.run(s_in, ambiguous=mask if masked else None, device=dev))
        instance = fused.instance_name(b.canonical, mode, masked)
        _expect_launches(name, launched, instance, 1, top16=1)
        h = b._resolved_hasher()
        text_in = inp == "text"
        (kind, canonical, rot), tables = convert.hasher_tensors(h, dev, text_in)
        variant = f" [{'text, ' + kind + ', ' if text_in else ''}large w]"
        rec.tally(launched, instance, variant)
        nw = N - l + 1
        count = out.positions.size
        density = count / nw
        print(f"  {count} kept; Builder.run wall {wall * 1e3:.1f} ms; peak extra device memory "
              f"{peak:.1f} MiB; density {density:.7f}, {density * (w + 1) / 2:.3f}x 2/(w+1)"
              + ("" if density_want is None else f" (want {density_want:.7f})"))
        if density_want is not None and abs(density / density_want - 1) > 0.1:
            raise RuntimeError(f"{name}: density {density} is not within 10% of {density_want}")

        # the kernel at 1e8 (the main path's launch) and its bound
        chars = (convert.text_bytes(s_in, dev) if text_in else convert.packed_words(s_in, dev))
        plane = convert.ambiguity_plane(mask, N, dev) if masked else None
        args = (chars, N, k, w, tables, rot, canonical, mode, plane)
        kw = {"text": text_in, "kind": kind}
        got = fused.fused_sketch(*args, **kw)
        for g, o in zip(got if mode == SKM else (got,), (out.positions, out.superkmer_indices),
                        strict=False):
            if not np.array_equal(g.cpu().numpy().view(np.uint32), o):
                raise RuntimeError(f"{name}: the kernel path differs from Builder.run")
        kt = _median_ms(lambda: fused.minimizer_tiles(*args, **kw), 3, 3, 1)
        pt = _median_ms(lambda: fused.fused_sketch(*args, **kw), 3, 3, 1)
        ops = _tiles_ops_per_window(k, canonical, kind, text_in, masked)
        planes = 2 if mode == SKM else 1
        out_bytes = 4 * (planes * count + -(-nw // fused.TILE))
        in_bytes = (N if text_in else N / 4) + (N / 8 if masked else 0)
        bound = _bound(in_bytes + out_bytes, nw * ops)
        # the pre-pass and the route apart, each beside its bound
        top_args = (chars, N, k, tables, rot, canonical)
        tops = fused.kmer_top16(*top_args, **kw)
        top_t = _median_ms(lambda: fused.kmer_top16(*top_args, **kw), 5, 5, 2)
        top_bound = _top16_bound(N, k, canonical, kind, text_in)
        if "kmer_top16" not in rec.entries:  # the first path: against the plain version
            plain = pipeline.kmer_top16_plain(*top_args, **kw)
            rec.entry("kmer_top16", "simd_minimizers_tpu/ops/fused.py:389",
                      _max_abs_err(tops, plain), top_t,
                      _median_ms(lambda: pipeline.kmer_top16_plain(*top_args, **kw), 3, 1, 0),
                      top_bound, source="top16.cu")
            del plain
        route_t = _median_ms(lambda: fused.minimizer_tiles(*args, **kw, top16=tops), 3, 3, 1)
        route_bound = _bound(in_bytes + 2 * tops.numel() + out_bytes,
                             nw * (ops - _hash_ops(k, canonical, kind)))
        print(f"  at {N} chars: minimizer_tiles {kt[0]:.4f} ms ({kt[1]:.4f}..{kt[2]:.4f}; "
              f"{kt[0] * 1e6 / N:.5f} ns/char), kernel path {pt[0]:.4f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}), {kt[0] / bound[0]:.1f}x; {note}")
        print(f"    of which kmer_top16 {top_t[0]:.4f} ms ({top_t[1]:.4f}..{top_t[2]:.4f}; bound "
              f"{top_bound[0]:.4f} ms, {top_bound[1]}, {top_t[0] / top_bound[0]:.2f}x; before "
              f"the prefix-XOR redesign {top_before:.4f} ms, {top_t[0] / top_before:.3f}x) and the "
              f"route given its tops {route_t[0]:.4f} ms ({route_t[1]:.4f}..{route_t[2]:.4f}; "
              f"bound {route_bound[0]:.4f} ms, {route_bound[1]}, "
              f"{route_t[0] / route_bound[0]:.1f}x; before the conflict-free scan and the T/G "
              f"plane {before:.4f} ms, {route_t[0] / before:.3f}x)")
        del got, chars, plane, out, tops

        # each kernel against its plain version at 1e7 chars
        m = N_LARGE_CHECK
        sub = s_in.slice(0, m) if not text_in else smt.GenericSeq(s_in.seq[:m])
        sub_chars = convert.text_bytes(sub, dev) if text_in else convert.packed_words(sub, dev)
        sub_plane = convert.ambiguity_plane(np.isin(np.arange(m), small_rng.integers(
            0, m, 200)), m, dev) if masked else None  # isolated flags: windows survive
        kt1 = _tiles_check(rec, instance + variant,
                           (sub_chars, m, k, w, tables, rot, canonical, mode, sub_plane), kw,
                           ops, plain_reps=(2, 1, 0))
        print(f"  at {m} chars: each kernel bit-equal to its plain version, kmer_top16 too; "
              f"kernel path {kt1:.4f} ms")
        del sub_chars, sub_plane
        torch.cuda.empty_cache()

        # against the oracle, the same input on the card
        codes = (small_text if text_in else small_codes)[:n_oracle]
        small = smt.GenericSeq(codes) if text_in else smt.PackedSeqVec.from_codes(codes)
        m_small = small_mask[:n_oracle] if masked else None
        res = b.run(small, ambiguous=m_small, device=dev)
        got = (res.positions,) if res.superkmer_indices is None else (
            res.positions, res.superkmer_indices)
        t = time.perf_counter()
        want = _oracle_threaded(b, codes, m_small, sels)
        if not all(np.array_equal(g, p) for g, p in zip(got, want, strict=True)):
            raise RuntimeError(f"{name}: Builder on the card disagrees with the oracle at "
                               f"{n_oracle} chars")
        print(f"  bit-equal to the oracle at {n_oracle} chars ({got[0].size} values; oracle "
              f"{time.perf_counter() - t:.1f} s)")

    # what the large-w route's tops (2 B a k-mer) add to a path of the w
    # that took the stored route before LARGE_W_MIN fell to the crossover:
    # canonical w = 2,047 at 1e8 bases, peak extra device memory of the
    # kernel path by each route, bit-equal
    chars = convert.packed_words(seq, dev)
    (kind, canonical, rot), tables = convert.hasher_tensors(smt.NtHasher(k, True), dev)
    threshold, peaks, outs = fused.LARGE_W_MIN, {}, {}
    try:
        for route, thr in (("stored", 1 << 16), ("large-w", threshold)):
            fused.LARGE_W_MIN = thr
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[route] = fused.fused_sketch(chars, N, k, 2047, tables, rot, canonical)
            torch.cuda.synchronize()
            peaks[route] = (torch.cuda.max_memory_allocated() - base) / 2**20
    finally:
        fused.LARGE_W_MIN = threshold
    if not torch.equal(outs["stored"], outs["large-w"]):
        raise RuntimeError("the routes disagree at w = 2,047")
    print(f"large w: canonical w=2047 at {N} bases (LARGE_W_MIN = {threshold}): peak extra device "
          f"memory of the kernel path, stored route {peaks['stored']:.1f} MiB, large-w route "
          f"{peaks['large-w']:.1f} MiB (the tops: {2 * (N - k + 1) / 2**20:.1f} MiB); bit-equal")
    del chars, outs

    # the pre-pass alone at larger k, canonical nt over the same 1e8 bases:
    # its time beside its bound (O(1) a top whatever k), bit-equal to its
    # plain version at 1e7 chars
    chars = convert.packed_words(seq, dev)
    sub_chars = convert.packed_words(seq.slice(0, N_LARGE_CHECK), dev)
    for kk in TOP16_K:
        (kind, canonical, rot), tables = convert.hasher_tensors(smt.NtHasher(kk, True), dev)
        top_args = (chars, N, kk, tables, rot, canonical)
        top_t = _median_ms(lambda: fused.kmer_top16(*top_args, kind=kind), 5, 5, 2)
        top_bound = _top16_bound(N, kk, canonical, kind, False)
        sub = (sub_chars, N_LARGE_CHECK, kk, tables, rot, canonical)
        err = _max_abs_err(fused.kmer_top16(*sub, kind=kind),
                           pipeline.kmer_top16_plain(*sub, kind=kind))
        if err:
            raise RuntimeError(f"kmer_top16 at k={kk}: max_abs_err {err} at {N_LARGE_CHECK} chars")
        print(f"large w: kmer_top16 canonical nt k={kk} at {N} chars {top_t[0]:.4f} ms "
              f"({top_t[1]:.4f}..{top_t[2]:.4f}; bound {top_bound[0]:.4f} ms, {top_bound[1]}, "
              f"{top_t[0] / top_bound[0]:.2f}x); bit-equal to its plain version at "
              f"{N_LARGE_CHECK} chars; {note}")
    del chars, sub_chars
    torch.cuda.empty_cache()


def _short_sequences(ctx):
    """ShortSeqSketcher, canonical k=21 w=11: sketch_many of 10,000 random
    sequences of 30-8,222 chars (one captured graph, a replay each) against
    the oracle, the kernel at the graph's shape against its plain version,
    measure_floor at 8,192 chars beside a warm Builder.run of the same
    chars, and super-k-mers once."""
    import numpy as np

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    rng = np.random.default_rng(ctx["seed"] + 8)
    h = smt.NtHasher(K, canonical=True)
    sk = ShortSeqSketcher(K, W, h, device=dev)
    lens = [30, 31, 64, 1024, 8192, sk.max_chars]
    lens += [int(x) for x in rng.integers(30, sk.max_chars + 1, N_SHORT - len(lens))]
    seqs = [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]
    print(f"short sequences: ShortSeqSketcher canonical k={K} w={W}, {len(seqs)} sequences of "
          f"30-{sk.max_chars} chars (max_chars), sketch_many:")
    outs, wall, launched, _ = _main_path(lambda: sk.sketch_many(seqs))
    ran = sum(s.size >= K + W - 1 for s in seqs)
    instance = fused.instance_name(True, pipeline.MODE_MINIMIZERS, False)
    _expect_launches("short sequences", launched, instance, ran)
    rec.tally(launched, instance, " [graph replay]")
    b = smt.canonical_minimizers(K, W)
    for s, o in zip(seqs, outs, strict=True):
        want = b.run_scalar(smt.PackedSeqVec.from_codes(s)).positions
        if not np.array_equal(o, want):
            raise RuntimeError(f"short sequences: a sequence of {s.size} chars differs from "
                               "the oracle")
    print(f"  {ran} graph replays (3 kernels each) in {wall * 1e3:.1f} ms wall "
          f"({wall / len(seqs) * 1e6:.1f} us per sequence); every result bit-equal to the "
          f"oracle; {note}")
    (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
    one = seqs[lens.index(sk.max_chars)]
    _tiles_check(rec, instance + " [graph replay]",
                 (convert.code_bytes(one, dev), one.size, K, W, tables, rot, canonical,
                  pipeline.MODE_MINIMIZERS, None), {"byte_codes": True},
                 _tiles_ops_per_window(K, True, "nt", True, False))
    codes = seqs[lens.index(8192)]
    floor = ShortSeqSketcher(K, W, h, donate=False, device=dev).measure_floor(codes)
    ps = smt.PackedSeqVec.from_codes(codes)
    b.run(ps, device=dev)
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        b.run(ps, device=dev)
    per_run = (time.perf_counter() - t) / 100
    print("  measure_floor at 8192 chars (donate=False): "
          + ", ".join(f"{key} {v:.1f}" for key, v in floor.items())
          + f"; warm Builder.run of the same chars {per_run * 1e6:.1f} us per call (100 calls); "
          f"{note}")
    skm = ShortSeqSketcher(K, W, h, mode=pipeline.MODE_SUPERKMERS, device=dev)
    got = skm.sketch(codes)
    want = b.super_kmers().run_scalar(ps)
    if not (np.array_equal(got[0], want.positions)
            and np.array_equal(got[1], want.superkmer_indices)):
        raise RuntimeError("short sequences: super-k-mers differ from the oracle")
    print("  super-k-mers: bit-equal to the oracle")


def _sharded(ctx):
    """fused_sharded_sketch of the 1e8 bases over ["cuda:0"] and
    ["cuda:0"] * 4 in every mode family (minimizers also with the N mask),
    each bit-equal to Builder.run; then multihost_sketch under an NCCL
    group of one process and the ragged all-gather of two planes over it."""
    import datetime
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline
    from simd_minimizers_tpu_torch.parallel import multihost, shard

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    seq, mask = ctx["inputs"]["dna"]
    codes = seq.codes()
    runs = [(smt.canonical_minimizers(K, W), None), (smt.canonical_minimizers(K, W), mask),
            (smt.canonical_minimizers(K, W).super_kmers(), None),
            (smt.closed_syncmers(K, W), None), (smt.open_syncmers(K, W), None)]
    l = K + W - 1
    print(f"sharded: fused_sharded_sketch of {N} bases:")
    for b, m in runs:
        mode = b._mode
        out = b.run(seq, ambiguous=m, device=dev)
        want = (out.positions,) if out.superkmer_indices is None else (
            out.positions, out.superkmer_indices)
        instance = fused.instance_name(b.canonical, mode, m is not None)
        for mesh in ([dev], [dev] * 4):
            got, wall, launched, peak = _main_path(lambda: shard.fused_sharded_sketch(
                codes, K, W, b._resolved_hasher(), mode, m, mesh=mesh))
            _expect_launches(f"sharded {instance}", launched, instance, len(mesh))
            rec.tally(launched, instance, " [sharded]")
            got = got if isinstance(got, tuple) else (got,)
            if not all(np.array_equal(g, p) for g, p in zip(got, want, strict=True)):
                raise RuntimeError(f"sharded {instance} over {len(mesh)} shards differs from "
                                   "Builder.run")
            print(f"  {mode}, {instance}{' (N mask)' if m is not None else ''}, "
                  f"{len(mesh)} shard(s): "
                  f"wall {wall:.3f} s, peak extra device memory {peak:.1f} MiB; bit-equal to "
                  f"Builder.run; {note}")
    # one shard's launch against its plain version (its first char as offset)
    h = smt.NtHasher(K, canonical=True)
    (kind, canonical, rot), tables = convert.hasher_tensors(h, dev)
    s, n = shard._shard_spans(N, l, 4)[1]
    chars = convert.code_bytes(codes, dev)
    _tiles_check(rec, fused.instance_name(True, pipeline.MODE_MINIMIZERS, False) + " [sharded]",
                 (chars[s:s + n], n, K, W, tables, rot, canonical, pipeline.MODE_MINIMIZERS,
                  None), {"offset": s, "byte_codes": True},
                 _tiles_ops_per_window(K, True, "nt", True, False), plain_reps=(2, 1, 0))
    del chars
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        b = smt.canonical_minimizers(K, W).super_kmers()
        want = b.run(seq, device=dev)
        got, wall, launched, _ = _main_path(lambda: multihost.multihost_sketch(
            codes, K, W, h, pipeline.MODE_SUPERKMERS, device=dev.type))
        instance = fused.instance_name(True, pipeline.MODE_SUPERKMERS, False)
        _expect_launches("multihost", launched, instance, 1)
        rec.tally(launched, instance, " [sharded]")
        if not (np.array_equal(got[0], want.positions)
                and np.array_equal(got[1], want.superkmer_indices)):
            raise RuntimeError("multihost_sketch differs from Builder.run")
        parts, aux = multihost._allgather_ragged_planes([want.positions[:12345],
                                                         want.superkmer_indices[:12345]], 1)
        if not (np.array_equal(parts[0], want.positions[:12345])
                and np.array_equal(aux[0], want.superkmer_indices[:12345])):
            raise RuntimeError("the NCCL all-gather changed the planes")
        print(f"  multihost_sketch, NCCL world of 1, super-k-mers: wall {wall:.3f} s, bit-equal "
              f"to Builder.run; _allgather_ragged_planes of two planes over NCCL: equal; {note}")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


FUZZ_CONFIGS = 360  # configs the fuzz phase draws (one in six on the large-w route)
FUZZ_SECONDS = 90  # the phase starts no new config after this
FUZZ_MIN, FUZZ_MIN_LARGE_W = 300, 40  # configs it must check, all and on the large-w route


def _fuzz(ctx):
    """The randomized differential fuzz (simd_minimizers_tpu_torch/tools/fuzz.py)
    on the card at a fixed seed: every entry point, mode, hasher and input
    kind, bit-equal to the oracle; any mismatch raises with its config."""
    from simd_minimizers_tpu_torch.ops import pipeline
    from simd_minimizers_tpu_torch.tools import fuzz

    s = fuzz.run(seed=ctx["seed"], configs=FUZZ_CONFIGS, seconds=FUZZ_SECONDS, device=DEVICE)
    print(f"fuzz: {s['configs']} configs of seed {s['seed']} on {s['device']}, 0 mismatches, "
          f"{s['seconds']:.1f} s ({s['configs_per_s']:.2f} configs/s); {ctx['card_note']}")
    for key in ("by_entry", "by_mode", "by_route", "by_hasher", "by_kind", "by_mask"):
        print(f"  {key[3:]}: " + ", ".join(f"{k} {v}" for k, v in s[key].items()))
    print(f"  slowest: {s['slowest']['entry_s']:.3f} s through its entry: "
          f"{s['slowest']['config']}")
    large = s["by_route"].get("large-w", 0)
    if s["configs"] < FUZZ_MIN or large < FUZZ_MIN_LARGE_W:
        raise RuntimeError(f"fuzz: {s['configs']} configs ({large} on the large-w route) in the "
                           f"time box; at least {FUZZ_MIN} ({FUZZ_MIN_LARGE_W}) are required")
    seen = {"entry": set(s["by_entry"]), "mode": set(s["by_mode"]),
            "hasher": {h.split(",")[0] for h in s["by_hasher"]}, "kind": set(s["by_kind"])}
    want = {"entry": set(fuzz.ENTRIES), "mode": set(pipeline.MODES),
            "hasher": set(fuzz.HASHERS), "kind": set(fuzz.KINDS)}
    if seen != want:
        raise RuntimeError(f"fuzz: covered {seen}, not {want}")


def _trace(ctx):
    """One torch.profiler trace (utils/profiling.trace) of one canonical
    Builder.run of the 1e8 bases, a main path: the three kernels' device
    times, the device's busy and idle share of the traced call, and its
    largest idle gap, from the trace's timeline. The trace is written under
    build/ and removed."""
    import json
    import os
    import shutil
    import tempfile

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.ops import fused, pipeline
    from simd_minimizers_tpu_torch.utils import profiling

    seq = ctx["inputs"]["dna"][0]
    b = smt.canonical_minimizers(K, W)
    b.run(seq, device=ctx["dev"])  # warm
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    try:
        def traced():
            with profiling.trace(tmp) as path:
                b.run(seq, device=ctx["dev"])
            return path

        path, wall, launched, _ = _main_path(traced)
        instance = fused.instance_name(True, pipeline.MODE_MINIMIZERS, False)
        _expect_launches("trace", launched, instance, 1)
        ctx["rec"].tally(launched, instance, "")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev_ev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    print(f"trace: one Builder.run of {N} bases, canonical k={K} w={W} (wall {wall * 1e3:.2f} ms "
          f"with the profiler on); Chrome trace of {size} bytes, {len(events)} events, "
          f"{len(dev_ev)} on the device; {ctx['card_note']}")
    if not dev_ev:
        raise RuntimeError("trace: the profiler recorded no device events")
    for name in ("minimizer_tiles", "tile_offsets", "tile_append"):
        ts = [e["dur"] for e in dev_ev if e["cat"] == "kernel" and name in e["name"]]
        if len(ts) != 1:
            raise RuntimeError(f"trace: {len(ts)} {name} kernel events, not 1")
        print(f"  {name}: device time {ts[0] / 1e3:.4f} ms")
    copies = [e for e in dev_ev if e["cat"] != "kernel"]
    print(f"  copies and sets: {len(copies)}, device time "
          f"{sum(e['dur'] for e in copies) / 1e3:.4f} ms")
    start, end = dev_ev[0]["ts"], max(e["ts"] + e["dur"] for e in dev_ev)
    busy, gap, reach = 0.0, 0.0, start
    for e in dev_ev:
        gap = max(gap, e["ts"] - reach)
        busy += max(0.0, e["ts"] + e["dur"] - max(reach, e["ts"]))
        reach = max(reach, e["ts"] + e["dur"])
    span = end - start
    print(f"  device timeline {span / 1e3:.4f} ms from the first device event to the last: "
          f"busy {busy / 1e3:.4f} ms, idle share {1 - busy / span:.4f}, largest idle gap "
          f"{gap / 1e3:.4f} ms")


def _examples(ctx):
    """The port's examples on the card, each in a process of its own: bench
    (min of 5 Builder.run calls of 1e7 bases, canonical) and multihost_demo
    (two processes over gloo, both sketching on this card, each checked
    against the oracle)."""
    import json
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    for args in (["bench", "--n", str(10**7), "--canonical"], ["multihost_demo", "--device", "cuda"]):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"simd_minimizers_tpu_torch.examples.{args[0]}",
                              *args[1:]], cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if res.returncode != 0:
            raise RuntimeError(f"examples.{args[0]} failed ({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        lines = res.stdout.strip().splitlines()
        print(f"examples.{args[0]} {' '.join(args[1:])}: exit 0 in {wall:.1f} s: " + " | ".join(
            x for x in lines if not x.startswith("{")) + f"; {ctx['card_note']}")
        if args[0] == "bench":
            got = json.loads(lines[-1])
            if got["count"] <= 0 or abs(got["count"] / (10**7 - K - W + 2) - 2 / (W + 1)) > 0.01:
                raise RuntimeError(f"examples.bench: count {got['count']}")


CROSSOVER_W = (16, 32, 64, 128, 256, 512, 1024, 1536, 2048, 3072, 4096, 8192, 16384, 32768)
N_CROSSOVER = 10**7  # chars of the route comparison
STORED_W = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63)  # w of the stored-route sweep
N_STORED = 10**7  # chars of the stored-route sweep
N_SPAN_TILES = 1 << 17  # tiles of a 2^29-char span: tile_offsets' count there


def _stored_sweep(ctx):
    """The stored route of minimizer_tiles (conflict-free keys, doubling
    passes): both strands x minimizers, super-k-mers, closed syncmers and
    minimizers with the chromosome mask x w in STORED_W at 1e7 bases, and k
    = 64 and 1,001 at w = 5, each launch against minimizer_tiles_plain on
    the card and timed; then tile_offsets on a 2^29-char span's 131,072
    counts beside torch.cumsum."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    rng = np.random.default_rng(ctx["seed"] + 9)
    m = N_STORED
    seq = smt.PackedSeqVec.random(m, rng)
    chars = convert.packed_words(seq, dev)
    plane = convert.ambiguity_plane(_chromosome_mask(m, rng), m, dev)
    tile = fused.TILE
    modes = ((pipeline.MODE_MINIMIZERS, None), (pipeline.MODE_SUPERKMERS, None),
             (pipeline.MODE_CLOSED_SYNCMERS, None), (pipeline.MODE_MINIMIZERS, plane))
    cases = [(21 if (w % 2 or not c) else 22, w, c) for c in (True, False) for w in STORED_W]
    cases += [(k, 5, c) for c in (True, False) for k in (64 + c, 1001)]
    print(f"stored route: {len(cases)} (k, w, strand) x {len(modes)} modes at {m} bases, each "
          "launch against its plain version (ms: minimizer_tiles per mode):")
    for k, w, canonical in cases:
        if fused.sub_tile(k, w, canonical) != 0:
            raise RuntimeError(f"k={k} w={w} does not take the stored route")
        (kind, can, rot), tables = convert.hasher_tensors(smt.NtHasher(k, canonical), dev)
        times = []
        for mode, amb in modes:
            args = (chars, m, k, w, tables, rot, can, mode, amb)
            scratch, counts = fused.minimizer_tiles(*args)
            p_scratch, p_counts = pipeline.minimizer_tiles_plain(*args[:7], tile, *args[7:])
            live = torch.arange(tile, device=dev) < counts[:, None]
            err = max([_max_abs_err(counts, p_counts)] + [
                _max_abs_err(g[live], p[live])
                for g, p in zip(scratch.view(-1, counts.numel(), tile),
                                p_scratch.view(-1, counts.numel(), tile))])
            if err:
                raise RuntimeError(f"stored route k={k} w={w} {mode}: max_abs_err {err}")
            times.append(_median_ms(lambda: fused.minimizer_tiles(*args), 3, 3, 1)[0])
            del scratch, counts, p_scratch, p_counts, live
        print(f"  {'canonical' if canonical else 'forward'} k={k} w={w} (passes "
              f"{fused.min_passes(w)}): bit-equal; " + " / ".join(f"{t:.4f}" for t in times)
              + f"; {note}")
    del chars, plane
    torch.cuda.empty_cache()

    # tile_offsets on a 2^29-char span's tile count
    g = torch.Generator(device=dev).manual_seed(ctx["seed"])
    counts = torch.randint(0, 2 * tile // (W + 1), (N_SPAN_TILES,), dtype=torch.int32,
                           device=dev, generator=g)
    _scan_timing(rec, counts, note)


def _crossover(ctx):
    """`minimizer_tiles` by both routes at w = 16 .. the largest w whose
    stored layout fits a block's shared memory (canonical and forward nt,
    1e7 random bases, the launch the threshold decides), each bit-equal to
    the other, timed in turns; prints the w from which the large-w route
    wins in both strands at every larger w."""
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused, pipeline

    dev, note = ctx["dev"], ctx["card_note"]
    rng = np.random.default_rng(ctx["seed"] + 6)
    chars = convert.packed_words(smt.PackedSeqVec.random(N_CROSSOVER, rng), dev)
    threshold = fused.LARGE_W_MIN
    print(f"routes of minimizer_tiles at {N_CROSSOVER} bases (stored / large-w, ms; "
          f"LARGE_W_MIN = {threshold}), up to the largest w the stored route fits:")
    wins = {}
    try:
        for canonical in (True, False):
            stored_max = max(w for w in range(1, 1 << 16)
                             if fused._smem_bytes(22, w, canonical, pipeline.MODE_MINIMIZERS,
                                                  False, False, "nt", 0) <= fused._SMEM_MAX)
            for w in sorted({w for w in CROSSOVER_W if w <= stored_max} | {stored_max}):
                k = 21 if (w % 2 or not canonical) else 22
                (kind, can, rot), tables = convert.hasher_tensors(smt.NtHasher(k, canonical),
                                                                  dev)
                args = (chars, N_CROSSOVER, k, w, tables, rot, can)
                times, outs = {}, {}
                for route, thr in (("stored", 1 << 16), ("large", 1), ("large", 1),
                                   ("stored", 1 << 16)):
                    fused.LARGE_W_MIN = thr
                    outs[route] = fused.fused_sketch(*args)
                    big = route == "stored" and w >= 1 << 14
                    times.setdefault(route, []).append(_median_ms(
                        lambda: fused.minimizer_tiles(*args), 3 if big else 7, 1 if big else 10,
                        1)[0])
                if not torch.equal(outs["stored"], outs["large"]):
                    raise RuntimeError(f"routes disagree at w={w}")
                st, lg = (sum(times[r]) / 2 for r in ("stored", "large"))
                wins.setdefault(canonical, []).append((w, lg < st))
                print(f"  {'canonical' if canonical else 'forward'} k={k} w={w}: stored "
                      f"{st:.4f}, large-w {lg:.4f} ({st / lg:.2f}x); bit-equal; {note}")
    finally:
        fused.LARGE_W_MIN = threshold
    # the first w from which the large-w route wins at every larger w measured
    first = max(next((w for i, (w, _) in enumerate(v) if all(win for _, win in v[i:])), 1 << 16)
                for v in wins.values())
    print(f"  the large-w route wins in both strands at every w from {first} on "
          f"(LARGE_W_MIN = {threshold})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 2

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import _build, backend, fused, pipeline
    from simd_minimizers_tpu_torch.utils.device import card_info

    dev = torch.device(DEVICE)
    card = card_info()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # -- build ----------------------------------------------------------
    _build.library()
    print(f"build: {_build.build_seconds:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    seq = smt.PackedSeqVec.random(N, rng)
    mask = _chromosome_mask(N, rng)
    text = smt.GenericSeq(rng.integers(32, 127, N, dtype=np.uint8))
    text_mask = _sparse_mask(N, rng)
    # per input: (sequence, its mask)
    inputs = {"dna": (seq, mask), "text": (text, text_mask)}
    print(f"input: {N} random bases and {N} random printable bytes, seed {args.seed}; "
          f"masks: {int(mask.sum())} Ns (DNA), {int(text_mask.sum())} flags (text) "
          f"({time.perf_counter() - t:.2f} s)")

    MIN, SKM = pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS
    CLOSED, OPEN = pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS
    mul, can_mul = smt.MulHasher(K), smt.MulHasher(K, canonical=True)
    antilex, can_antilex = smt.AntiLexHasher(K), smt.AntiLexHasher(K, canonical=True)
    # (name, builder, mode, ambiguity: None | "mask" (Builder.run's mask) |
    #  "skip" (run_skip_ambiguous_windows), expected density or None, input)
    paths = [
        ("canonical minimizers", smt.canonical_minimizers(K, W), MIN, None, 2 / (W + 1), "dna"),
        ("forward minimizers", smt.minimizers(K, W), MIN, None, 2 / (W + 1), "dna"),
        ("canonical super-k-mers", smt.canonical_minimizers(K, W).super_kmers(), SKM, None,
         2 / (W + 1), "dna"),
        ("forward super-k-mers", smt.minimizers(K, W).super_kmers(), SKM, None, 2 / (W + 1),
         "dna"),
        ("canonical closed syncmers", smt.canonical_closed_syncmers(K, W), CLOSED, None, 2 / W,
         "dna"),
        ("forward closed syncmers", smt.closed_syncmers(K, W), CLOSED, None, 2 / W, "dna"),
        ("canonical open syncmers", smt.canonical_open_syncmers(K, W), OPEN, None, 1 / W, "dna"),
        ("forward open syncmers", smt.open_syncmers(K, W), OPEN, None, 1 / W, "dna"),
        ("canonical minimizers, skip-ambiguous", smt.canonical_minimizers(K, W), MIN, "skip",
         None, "dna"),
        ("forward minimizers, ambiguity mask", smt.minimizers(K, W), MIN, "mask", None, "dna"),
        ("canonical closed syncmers, ambiguity mask", smt.canonical_closed_syncmers(K, W),
         CLOSED, "mask", None, "dna"),
        ("forward open syncmers, ambiguity mask", smt.open_syncmers(K, W), OPEN, "mask", None,
         "dna"),
        ("text, forward mul minimizers", smt.minimizers(K, W).hasher(mul), MIN, None,
         2 / (W + 1), "text"),
        ("text, canonical nt minimizers", smt.canonical_minimizers(K, W), MIN, None, 2 / (W + 1),
         "text"),
        ("text, forward closed syncmers", smt.closed_syncmers(K, W), CLOSED, None, 2 / W,
         "text"),
        ("canonical mul minimizers", smt.canonical_minimizers(K, W).hasher(can_mul), MIN, None,
         2 / (W + 1), "dna"),
        ("canonical antilex minimizers", smt.canonical_minimizers(K, W).hasher(can_antilex), MIN,
         None, None, "dna"),
        ("forward antilex super-k-mers", smt.minimizers(K, W).hasher(antilex).super_kmers(), SKM,
         None, None, "dna"),
        ("text, forward mul minimizers, sparse mask", smt.minimizers(K, W).hasher(mul), MIN,
         "mask", None, "text"),
    ]

    def drive(b, amb, s, m, device):
        """One call of the public entry point of a path."""
        if amb == "skip":
            return b.run_skip_ambiguous_windows(smt.PackedNSeqVec(s, m), device=device)
        return b.run(s, ambiguous=m if amb else None, device=device)

    def planes(out):
        """An Output's positions, and indices for super-k-mers."""
        if out.superkmer_indices is None:
            return (out.positions,)
        return out.positions, out.superkmer_indices

    def upload(inp, s, device):
        return (convert.text_bytes(s, device) if inp == "text"
                else convert.packed_words(s, device))

    tile = fused.TILE
    chars_dev = {inp: upload(inp, s, dev) for inp, (s, _) in inputs.items()}
    planes_dev = {inp: convert.ambiguity_plane(m, N, dev) for inp, (_, m) in inputs.items()}
    nw = N - (K + W - 1) + 1
    card_note = f"card {card}"
    rec = _Kernels()
    entry = rec.entry

    for name, b, mode, amb, density_want, inp in paths:
        print(f"{name}:")
        s, m = inputs[inp]
        text_in = inp == "text"
        # -- main path: the public entry point, launches counted around it --
        out, wall, launched, _ = _main_path(lambda: drive(b, amb, s, m, dev))
        instance = fused.instance_name(b.canonical, mode, amb is not None)
        print(f"  main path launches: {launched}")
        if launched != {instance: 1, "tile_offsets": 1, "tile_append": 1}:
            raise RuntimeError(f"{name}: the main path did not run {instance} once and the "
                               f"two small kernels once each: {launched}")
        h = b._resolved_hasher()
        (kind, canonical, rot), tables = convert.hasher_tensors(h, dev, text_in)
        variant = "" if (inp, kind) == ("dna", "nt") else f" [{inp}, {kind}]"
        rec.tally(launched, instance, variant)

        # -- each kernel vs its plain version, at the path's shapes ---------
        kargs = (chars_dev[inp], N, K, W, tables, rot, canonical, mode,
                 planes_dev[inp] if amb else None)
        kw = {"text": text_in, "kind": kind}
        pargs = (*kargs[:7], tile, *kargs[7:])

        scratch, counts = fused.minimizer_tiles(*kargs, **kw)
        p_scratch, p_counts = pipeline.minimizer_tiles_plain(*pargs, **kw)
        live = torch.arange(tile, device=dev) < counts[:, None]
        err = max([_max_abs_err(counts, p_counts)] + [
            _max_abs_err(g[live], p[live])
            for g, p in zip(scratch.view(-1, counts.numel(), tile),
                            p_scratch.view(-1, counts.numel(), tile))])
        del p_scratch, live
        nplanes = 2 if mode == SKM else 1
        ntiles = counts.numel()
        kept = int(counts.sum())
        in_bytes = (N if text_in else N / 4) + (N / 8 if amb else 0)
        entry(instance + variant, 1631, err,
              _median_ms(lambda: fused.minimizer_tiles(*kargs, **kw), 5, 10, 2),
              _median_ms(lambda: pipeline.minimizer_tiles_plain(*pargs, **kw), 3, 2, 1),
              _bound(in_bytes + 4 * (nplanes * kept + ntiles),
                     nw * _tiles_ops_per_window(K, canonical, kind, text_in, bool(amb))))

        offsets = _scan_timing(rec, counts, card_note)

        total = int(offsets[-1])
        got = fused.tile_append(scratch, counts, offsets, total)
        err = _max_abs_err(got, pipeline.tile_append_plain(scratch, counts, offsets, total, tile))
        entry("tile_append", 841, err,
              _median_ms(lambda: fused.tile_append(scratch, counts, offsets, total), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_append_plain(scratch, counts, offsets, total,
                                                            tile), 3, 3, 1),
              _bound(2 * 4 * nplanes * total + 4 * (2 * ntiles + 1), nplanes * total))
        if any(e["max_abs_err"] for e in rec.entries.values()):
            raise RuntimeError(f"{name}: a kernel disagrees with its plain version")

        # -- the whole kernel path against the plain pipeline and Builder.run
        def kern():
            return fused.fused_sketch(*kargs, **kw)

        def plain():
            return pipeline.run_pipeline(*kargs, **kw)

        got_path = kern()
        got_planes = got_path if mode == SKM else (got_path,)
        if (_max_abs_err(got_path, plain()) != 0
                or any(not np.array_equal(o, g.cpu().numpy())
                       for o, g in zip(planes(out), got_planes, strict=True))):
            raise RuntimeError(f"{name}: the kernel path disagrees with the plain version "
                               "or Builder.run")
        count = got_planes[0].numel()
        density = count / nw
        print(f"  {count} kept, bit-equal to the plain version at {N} chars; density "
              f"{density:.4f}" + ("" if density_want is None else f" (want {density_want:.4f})"))
        if density_want is not None and abs(density - density_want) > 0.01:
            raise RuntimeError(f"{name}: density {density} is not about {density_want}")
        kt, pt = _median_ms(kern, 5, 10, 2), _median_ms(plain, 3, 3, 1)
        print(f"  kernel path {kt[0]:.4f} ms ({kt[0] * 1e6 / N:.5f} ns/char; {kt[1]:.4f}.."
              f"{kt[2]:.4f}), plain {pt[0]:.3f} ms ({pt[0] * 1e6 / N:.4f} ns/char; "
              f"{pt[1]:.3f}..{pt[2]:.3f}); {card_note}")
        del scratch, counts, offsets, got, got_path, got_planes
        print(f"  peak extra device memory: kernel path {_peak_extra_mib(kern):.1f} MiB, "
              f"plain {_peak_extra_mib(plain):.1f} MiB")

        # Builder.run: the main path call, then warm runs split in parts (the
        # download as Builder.run makes it, through pinned memory, and beside
        # it the pageable .cpu() that it replaced)
        parts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up = upload(inp, s, dev)
            up_plane = convert.ambiguity_plane(m, N, dev) if amb else None
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = backend.sketch(up, N, K, W, h, mode, up_plane, text_in)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            convert.Download(res).result()
            t3 = time.perf_counter()
            for r in res if mode == SKM else (res,):
                r.cpu()
            t4 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3))
        spans = ["..".join(f"{f(col):.2f}" for f in (min, max)) for col in zip(*parts)]
        print(f"  Builder.run wall: main path call {wall * 1e3:.2f} ms; warm upload / "
              f"kernel path / pinned download (pageable), 3 runs: {' / '.join(spans[:3])} "
              f"({spans[3]}) ms; {card_note}")
        del out, up, up_plane, res

    # -- host packing of the 2-bit inputs that are not zero-copy ----------
    ascii_in = smt.AsciiSeq(np.frombuffer(b"ACTG", np.uint8)[seq.codes()])  # code order
    for what, s in (("AsciiSeq", ascii_in), ("PackedSeq slice from base 1", seq.slice(1, N))):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            convert.packed_words(s, dev)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"host packing + upload, {what} of {len(s)} bases, 3 runs: "
              f"{min(ts):.2f}..{max(ts):.2f} ms; {card_note}")
    del ascii_in

    # -- k-mer values, then the paths of whole genomes and read batches ----
    ctx = {"dev": dev, "rec": rec, "card_note": card_note, "seed": args.seed,
           "inputs": inputs}
    t = time.perf_counter()
    _values(ctx)
    print(f"  (values: {time.perf_counter() - t:.1f} s)")
    _bus(ctx)
    _long_sequence(ctx)
    _long_sweep(ctx, chars_dev["dna"], planes_dev["dna"])
    del chars_dev, planes_dev
    torch.cuda.empty_cache()
    _genome(ctx)
    _read_batches(ctx)
    t = time.perf_counter()
    _cpu_route(ctx)
    print(f"  (cpu_route: {time.perf_counter() - t:.1f} s)")

    # -- the stored route, large w, short sequences, sharded, the fuzz, a
    # profiler trace, the examples
    for phase in (_stored_sweep, _crossover, _large_w, _short_sequences, _sharded, _fuzz, _trace,
                  _examples):
        t = time.perf_counter()
        phase(ctx)
        print(f"  ({phase.__name__[1:]}: {time.perf_counter() - t:.1f} s)")

    rec.finish()

    # -- against the oracle: 1e6 chars (same mask shapes), golden vectors ---
    small_rng = np.random.default_rng(args.seed + 1)
    small_dna = smt.PackedSeqVec.random(N_ORACLE, small_rng)
    small_text = smt.GenericSeq(small_rng.integers(32, 127, N_ORACLE, dtype=np.uint8))
    small = {"dna": (small_dna, _chromosome_mask(N_ORACLE, small_rng)),
             "text": (small_text, _sparse_mask(N_ORACLE, small_rng))}
    for name, b, mode, amb, _, inp in paths:
        s, m = small[inp]
        want = planes(b.run_scalar(s, ambiguous=m if amb else None))
        for device in (dev, "cpu"):
            got = planes(drive(b, amb, s, m, device))
            if not all(np.array_equal(g, p) for g, p in zip(got, want, strict=True)):
                raise RuntimeError(f"{name}: Builder on {device} disagrees with the oracle "
                                   f"at {N_ORACLE} chars")
    ps = smt.PackedSeqVec.from_ascii(b"ACGTGCTCAGAGACTCAGAGGA")
    golden = [
        (smt.canonical_minimizer_positions(ps, 5, 7, device=dev), [0, 7, 9, 15]),
        (smt.minimizer_positions(smt.AsciiSeq(b"ACGTGCTCAGAGACTCAG"), 5, 7, device=dev),
         [4, 5, 8, 13]),
        (smt.canonical_minimizer_positions(ps.to_revcomp(), 5, 7, device=dev), [2, 8, 10, 17]),
        (smt.canonical_minimizers(5, 7).run(ps, device=dev).values_u64()[:1], [721]),
    ]
    for got, want in golden:
        if list(got) != want:
            raise RuntimeError(f"golden vector: got {list(got)}, want {want}")
    print(f"oracle: every path's builder bit-equal at {N_ORACLE} chars (card and CPU), "
          "golden vectors equal")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rec.entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
