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
kernel path and their plain versions with CUDA events (and `torch.cumsum`
beside `tile_offsets`), computes each kernel's bound from this run's
inputs, measures the peak device memory of both paths, and splits a warm
`Builder.run` into upload, kernel path and download (through pinned
memory, with the pageable `.cpu()` beside it). It times the host packing
and upload of the 2-bit inputs that are not zero-copy (an `AsciiSeq` and
a `PackedSeq` slice from base 1, 1e8 bases), and the bus alone (256 MiB
each way, through pageable and pinned host memory).

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
  stretches) through `python -m simd_minimizers_tpu_torch.sketch_fasta`,
  whose .npz must equal `sketch_records` on the parsed records, with its
  stage times and the start of a process that only imports the package;
- `Builder.run_batch` of 1,000,000 random 150 bp reads (canonical
  minimizers) and of 20,000 reads of 100-10,000 bp (forward minimizers with
  a 1% mask; canonical super-k-mers, whose launches run the super-k-mer
  instance with the batch's padding plane): bit-equal to the plain version
  of the same launches on the card and, for 10,000 reads, to the oracle;
  each run's wall split into stages, and each kernel against its plain
  version on its widest launch, bounded over the windows its reads own.
Every one of the 12 `minimizer_tiles` instances must have run on a main
path. Last, it holds every 1e8 path's builder against the NumPy oracle at
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
    if kind == "antilex":
        mask = 0 if min(k, 16) == 16 else 1
        hash_ops = (3 + mask) + ((4 + mask) if canonical else 0)
    else:
        hash_ops = 3 * arms
    return ((0 if text else 2) + hash_ops + arms * (2 + 3 + 2)
            + (5 if canonical else 0) + 2 + (3 if amb else 0))


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


# GRCh38's primary chromosomes (the assembly's published sequence lengths):
# 3,088,269,832 bp in all.
GRCH38 = [("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
          ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
          ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
          ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
          ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
          ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
          ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
          ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415)]
N_CONTIGS, CONTIG_BP = 200, (10_000, 200_000)  # unplaced-scaffold-like contigs
BATCH_MAX_BP = 1 << 20  # sketch_records' batch route takes records up to this length
N_LONG = 2**31 + 2**26  # one sequence past 2^31 chars
LONG_CHECK = (2**31 - 2**25, 2**31 + 2**25)  # its windows held against the plain version
LONG_VARIANT = " [spans of 2^29, u32 offset]"  # its kernels-line entry
SWEEP_SPAN = 1 << 24  # span chars of the 1e8-base sweep of sketch_long
N_SHORT_READS, SHORT_READ = 1_000_000, 150  # the short-read shape
N_LONG_READS = 20_000  # reads of 100-10,000 bp
N_READ_ORACLE = 10_000  # reads of each batch held against the oracle
DEVICE = "cuda"


class _Kernels:
    """Each kernel's numbers for the `kernels` line (from the first path
    that runs it, its largest error over all paths) and the launches of the
    main paths, per instance and per entry (instance and input / hasher
    variant)."""

    def __init__(self):
        from simd_minimizers_tpu_torch.ops import fused

        self.entries = {}
        self.launches_total = dict.fromkeys(fused.LAUNCHES, 0)
        self.launches_by_entry = {}

    def entry(self, name, source_line, err, kt, pt, bound, library=None):
        e = self.entries.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "simd_minimizers_tpu_torch/csrc/minimizers.cu",
            "replaces": f"simd_minimizers_tpu/ops/fused.py:{source_line}",
            "launches": 0, "max_abs_err": 0, "ms": kt[0], "plain_ms": pt[0],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None if library is None else library[0]})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        lib = "" if library is None else f", library {library[0]:.4f} ms"
        print(f"  {name}: max_abs_err {err}; kernel {kt[0]:.4f} ms "
              f"({kt[1]:.4f}..{kt[2]:.4f}), plain {pt[0]:.4f} ms ({pt[1]:.4f}..{pt[2]:.4f}), "
              f"bound {bound[0]:.4f} ms ({bound[1]}){lib}")
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

    from simd_minimizers_tpu_torch.ops import fused

    for key in fused.LAUNCHES:
        fused.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = {key: c for key, c in fused.LAUNCHES.items() if c}
    return out, wall, launched, (torch.cuda.max_memory_allocated() - base) / 2**20


def _expect_launches(name, launched, instance, count):
    """The main path ran `instance`, tile_offsets and tile_append `count`
    times each and nothing else."""
    want = {instance: count, "tile_offsets": count, "tile_append": count}
    print(f"  main path launches: {launched}")
    if launched != want:
        raise RuntimeError(f"{name}: the main path launched {launched}, not {want}")


def _tiles_check(rec, name, args, kw, ops_per_window, plain_reps=(3, 2, 1), windows=None):
    """Each kernel's wrapper against its plain version on a main path's
    launch `args` (as minimizer_tiles takes them, `kw` its keywords):
    minimizer_tiles timed and recorded as `name`, tile_offsets and
    tile_append held at the same shapes. The operation bound counts
    `windows` (the windows the launch owns; default all n - l + 1, which
    for a batch would count its padding). Returns the kernel path's ms."""
    import torch

    from simd_minimizers_tpu_torch.ops import fused, pipeline

    tile = fused.TILE
    chars, n, k, w, mode, plane = args[0], args[1], args[2], args[3], args[7], args[8]
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
    for key, e in (("tile_offsets", err_o), ("tile_append", err_a)):
        rec.entries[key]["max_abs_err"] = max(rec.entries[key]["max_abs_err"], e)
        if e:
            raise RuntimeError(f"{name}: {key} disagrees with its plain version")
    planes = 2 if mode == "superkmers" else 1
    if windows is None:
        windows = max(n - (k + w - 1) + 1, 0)
    in_bytes = chars.numel() + (0 if plane is None else plane.numel())
    rec.entry(name, 1631, err,
              _median_ms(lambda: fused.minimizer_tiles(*args, **kw), 5, 5, 2),
              _median_ms(lambda: pipeline.minimizer_tiles_plain(*args[:7], tile, *args[7:], **kw),
                         *plain_reps),
              _bound(in_bytes + 4 * (planes * total + counts.numel()),
                     windows * ops_per_window))
    del scratch, counts, offsets
    return _median_ms(lambda: fused.fused_sketch(*args, **kw), 3, 3, 1)[0]


def _oracle_planes(b, codes, mask=None):
    """The builder's oracle on 2-bit codes: (positions[, indices])."""
    import simd_minimizers_tpu_torch as smt

    out = b.run_scalar(smt.PackedSeqVec.from_codes(codes), ambiguous=mask)
    return (out.positions,) if out.superkmer_indices is None else (
        out.positions, out.superkmer_indices)


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
    from simd_minimizers_tpu_torch.ops import fused, pipeline

    dev, rec, note = ctx["dev"], ctx["rec"], ctx["card_note"]
    l = K + W - 1
    print(f"long sequence: canonical minimizers of {N_LONG} random bases, Builder.run:")
    rng = np.random.default_rng(ctx["seed"] + 2)
    t = time.perf_counter()
    seq = smt.PackedSeq(rng.integers(0, 256, N_LONG // 4, dtype=np.uint8), 0, N_LONG)
    print(f"  input: {N_LONG // 4} random packed bytes ({time.perf_counter() - t:.2f} s)")
    b = smt.canonical_minimizers(K, W)
    spans = len(fused.span_bounds(N_LONG, l, fused.SPAN_CHARS))
    out, wall, launched, peak = _main_path(lambda: b.run(seq, device=dev))
    instance = fused.instance_name(True, pipeline.MODE_MINIMIZERS, False)
    _expect_launches("long sequence", launched, instance, spans)
    rec.tally(launched, instance, LONG_VARIANT)
    pos = out.positions
    nw = N_LONG - l + 1
    steps = np.diff(pos.astype(np.int64))
    back = steps[steps <= 0]
    density = pos.size / nw
    print(f"  {pos.size} positions in {spans} spans; wall {wall * 1e3:.1f} ms "
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
        t = _median_ms(lambda: fused.sketch_long(words, N_LONG, K, W, h, wave_bytes=budget),
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
    for s, m in fused.span_bounds(N_LONG, l, fused.SPAN_CHARS)[-2:]:
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
    from simd_minimizers_tpu_torch.ops import fused, pipeline

    dev, rec = ctx["dev"], ctx["rec"]
    span = SWEEP_SPAN
    spans = len(fused.span_bounds(N, K + W - 1, span))
    print(f"long sweep: every mode in {spans} spans of {span} chars over {N} bases:")
    for mode in pipeline.MODES:
        for canonical in (True, False):
            for amb in (None, plane):
                h = smt.NtHasher(K, canonical=canonical)
                res, wall, launched, _ = _main_path(lambda: fused.sketch_long(
                    chars, N, K, W, h, mode, amb, span_chars=span))
                instance = fused.instance_name(canonical, mode, amb is not None)
                _expect_launches(f"sweep {instance}", launched, instance, spans)
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
                    m = fused.span_bounds(N, K + W - 1, span)[0][1]
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
    from simd_minimizers_tpu_torch.ops import backend, batch, fused, pipeline

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
    n_launch = (sum(len(fused.span_bounds(c.size, l, fused.SPAN_CHARS))
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
        for s, n in fused.span_bounds(codes[i].size, l, fused.SPAN_CHARS):
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
    stretches) through `python -m simd_minimizers_tpu_torch.sketch_fasta`;
    its .npz must equal sketch_records on the parsed records."""
    import os
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
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
                              "--skip-ambiguous", "--out", npz, "--device",
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
        if sorted(got.files) != ["chr21/positions", "chr22/positions"] or not all(
                np.array_equal(got[f"{r.name}/positions"], p) for r, p in zip(recs, want)):
            raise RuntimeError("FASTA: the CLI's .npz differs from sketch_records")
        if not all(np.array_equal(p, out[i]) for p, i in zip(want, pick)):
            raise RuntimeError("FASTA: the parsed records sketch differently from the codes")
        print(f"  parse {parse:.3f} s ({bp / parse / 1e9:.3f} Gbp/s); the .npz equals "
              "sketch_records on the parsed records and on the written codes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        _expect_launches(name, launched, instance, len(items))
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
        widest = max(items, key=lambda it: it[3])
        _tiles_check(rec, instance + " [codes, nt]",
                     (widest[2], widest[3], K, W, tables, rot, canonical, mode, widest[4]),
                     {"byte_codes": True}, _tiles_ops_per_window(K, canonical, "nt", True, True),
                     plain_reps=(2, 1, 0),
                     windows=sum(max(len(codes[i]) - l + 1, 0) for i in widest[0]))
        del items, plain, got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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

        offsets = fused.tile_offsets(counts)
        err = _max_abs_err(offsets, pipeline.tile_offsets_plain(counts))
        entry("tile_offsets", 841, err,
              _median_ms(lambda: fused.tile_offsets(counts), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_offsets_plain(counts), 5, 10, 2),
              _bound(4 * ntiles + 4 * (ntiles + 1), 2 * ntiles),
              _median_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32), 5, 10, 2))

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

    # -- the paths of whole genomes and read batches ----------------------
    ctx = {"dev": dev, "rec": rec, "card_note": card_note, "seed": args.seed}
    _bus(ctx)
    _long_sequence(ctx)
    _long_sweep(ctx, chars_dev["dna"], planes_dev["dna"])
    del chars_dev, planes_dev
    torch.cuda.empty_cache()
    _genome(ctx)
    _read_batches(ctx)

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

    print(card)
    print(json.dumps({"kernels": list(rec.entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
