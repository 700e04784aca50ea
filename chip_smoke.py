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
`Builder.run` into upload, kernel path and download. It times the host
packing and upload of the 2-bit inputs that are not zero-copy (an
`AsciiSeq` and a `PackedSeq` slice from base 1, 1e8 bases). Last, it holds every
path's builder against the NumPy oracle at 1e6 chars with a mask of the
same shape, and the minimizer builders on the golden vectors. Every failed
check raises, and the script exits non-zero; without CUDA it exits
non-zero before printing any result.

The card's name and power limit, then one JSON object with each kernel's
numbers (per `minimizer_tiles` instance and input / hasher variant, from
the first path that runs it), come on the lines before the last; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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

    dev = torch.device("cuda")
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
    launches_total = dict.fromkeys(fused.LAUNCHES, 0)
    launches_by_entry = {}
    entries = {}

    def entry(name, source_line, err, kt, pt, bound, library=None):
        """Keep a kernel's numbers (from the first path that runs it) and
        its largest error over all paths."""
        e = entries.setdefault(name, {
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

    for name, b, mode, amb, density_want, inp in paths:
        print(f"{name}:")
        s, m = inputs[inp]
        text_in = inp == "text"
        # -- main path: the public entry point, launches counted around it --
        for key in fused.LAUNCHES:
            fused.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = drive(b, amb, s, m, dev)
        wall = time.perf_counter() - t
        launched = {key: c for key, c in fused.LAUNCHES.items() if c}
        instance = fused.instance_name(b.canonical, mode, amb is not None)
        print(f"  main path launches: {launched}")
        if launched != {instance: 1, "tile_offsets": 1, "tile_append": 1}:
            raise RuntimeError(f"{name}: the main path did not run {instance} once and the "
                               f"two small kernels once each: {launched}")
        h = b._resolved_hasher()
        (kind, canonical, rot), tables = convert.hasher_tensors(h, dev, text_in)
        variant = "" if (inp, kind) == ("dna", "nt") else f" [{inp}, {kind}]"
        for key, c in launched.items():
            launches_total[key] += c
            e_name = instance + variant if key == instance else key
            launches_by_entry[e_name] = launches_by_entry.get(e_name, 0) + c

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
        if any(e["max_abs_err"] for e in entries.values()):
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

        # Builder.run: the main path call, then warm runs split in parts
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
            for r in res if mode == SKM else (res,):
                r.cpu()
            t3 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        spans = ["..".join(f"{f(col):.2f}" for f in (min, max)) for col in zip(*parts)]
        print(f"  Builder.run wall: main path call {wall * 1e3:.2f} ms; warm upload / "
              f"kernel path / download, 3 runs: {' / '.join(spans)} ms; {card_note}")
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

    never = [key for key, c in launches_total.items() if not c]
    if never:
        raise RuntimeError(f"no path launched {never}")
    for e in entries.values():
        e["launches"] = launches_by_entry[e["name"]]

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
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
