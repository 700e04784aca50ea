"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed S]

Builds the port's kernels from the sources in this checkout and drives
each path of the main surface, k=21 w=11 over 1e8 random 2-bit bases (seed
S), through the public `Builder.run` or `run_skip_ambiguous_windows` on the
card, counting each kernel instance's launches: canonical and forward
minimizers, super-k-mers, closed syncmers and open syncmers; canonical
skip-ambiguous minimizers, forward minimizers, canonical closed syncmers and
forward open syncmers with an ambiguity mask shaped like an assembled
chromosome (200 runs of N of 1,000-20,000 bases, isolated Ns at rate
1e-4). The counts are set to 0 just before each path and read just after
it. For each path it then calls each kernel's wrapper at the path's shapes
and holds it against its plain PyTorch version (bit-equal: integer
outputs), holds the whole kernel path against the plain pipeline and
`Builder.run`, checks the density of the mask-free paths (2/(w+1) for
minimizers and super-k-mers, 2/w for closed and 1/w for open syncmers,
each within 0.01), times each kernel, the kernel path and their plain
versions with CUDA events, measures the peak device memory of both paths,
and splits a warm `Builder.run` into upload, kernel path and download.
Last, it holds every path's builder against the NumPy oracle at 1e6 bases
with a mask of the same shape, and the minimizer builders on the golden
vectors. Every failed check raises, and the script exits non-zero; without
CUDA it exits non-zero before printing any result.

The card's name and power limit, then one JSON object with each kernel
instance's numbers (its time from the first path that runs it), come on
the lines before the last; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N = 10**8  # bases: the reference paper's benchmark size
N_ORACLE = 10**6  # bases the NumPy oracle checks
K, W = 21, 11


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
    nseq = smt.PackedNSeqVec(seq, mask)
    print(f"input: {N} random bases, seed {args.seed}; ambiguity mask: {int(mask.sum())} Ns "
          f"({time.perf_counter() - t:.2f} s)")

    MIN, SKM = pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS
    CLOSED, OPEN = pipeline.MODE_CLOSED_SYNCMERS, pipeline.MODE_OPEN_SYNCMERS
    # (name, builder, mode, ambiguity: None | "mask" (Builder.run's mask) |
    #  "skip" (run_skip_ambiguous_windows), expected density or None)
    paths = [
        ("canonical minimizers", smt.canonical_minimizers(K, W), MIN, None, 2 / (W + 1)),
        ("forward minimizers", smt.minimizers(K, W), MIN, None, 2 / (W + 1)),
        ("canonical super-k-mers", smt.canonical_minimizers(K, W).super_kmers(), SKM, None,
         2 / (W + 1)),
        ("forward super-k-mers", smt.minimizers(K, W).super_kmers(), SKM, None, 2 / (W + 1)),
        ("canonical closed syncmers", smt.canonical_closed_syncmers(K, W), CLOSED, None, 2 / W),
        ("forward closed syncmers", smt.closed_syncmers(K, W), CLOSED, None, 2 / W),
        ("canonical open syncmers", smt.canonical_open_syncmers(K, W), OPEN, None, 1 / W),
        ("forward open syncmers", smt.open_syncmers(K, W), OPEN, None, 1 / W),
        ("canonical minimizers, skip-ambiguous", smt.canonical_minimizers(K, W), MIN, "skip",
         None),
        ("forward minimizers, ambiguity mask", smt.minimizers(K, W), MIN, "mask", None),
        ("canonical closed syncmers, ambiguity mask", smt.canonical_closed_syncmers(K, W),
         CLOSED, "mask", None),
        ("forward open syncmers, ambiguity mask", smt.open_syncmers(K, W), OPEN, "mask", None),
    ]

    def drive(b, amb, s, ns, device):
        """One call of the public entry point of a path."""
        if amb == "skip":
            return b.run_skip_ambiguous_windows(ns, device=device)
        return b.run(s, ambiguous=ns.ambiguous if amb else None, device=device)

    def planes(out):
        """An Output's positions, and indices for super-k-mers."""
        if out.superkmer_indices is None:
            return (out.positions,)
        return out.positions, out.superkmer_indices

    tile = fused.TILE
    words = convert.packed_words(seq, dev)
    plane = convert.ambiguity_plane(mask, N, dev)
    nw = N - (K + W - 1) + 1
    card_note = f"card {card}"
    launches_total = dict.fromkeys(fused.LAUNCHES, 0)
    entries = {}

    def entry(name, source_line, err, kt, pt):
        e = entries.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "simd_minimizers_tpu_torch/csrc/minimizers.cu",
            "replaces": f"simd_minimizers_tpu/ops/fused.py:{source_line}",
            "launches": 0, "max_abs_err": 0, "ms": kt[0], "plain_ms": pt[0]})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        print(f"  {name}: max_abs_err {err}; kernel {kt[0]:.4f} ms "
              f"({kt[1]:.4f}..{kt[2]:.4f}), plain {pt[0]:.4f} ms ({pt[1]:.4f}..{pt[2]:.4f})")

    for name, b, mode, amb, density_want in paths:
        print(f"{name}:")
        # -- main path: the public entry point, launches counted around it --
        for key in fused.LAUNCHES:
            fused.LAUNCHES[key] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = drive(b, amb, seq, nseq, dev)
        wall = time.perf_counter() - t
        launched = {key: c for key, c in fused.LAUNCHES.items() if c}
        instance = fused.instance_name(b.canonical, mode, amb is not None)
        print(f"  main path launches: {launched}")
        if launched != {instance: 1, "tile_offsets": 1, "tile_append": 1}:
            raise RuntimeError(f"{name}: the main path did not run {instance} once and the "
                               f"two small kernels once each: {launched}")
        for key, c in launched.items():
            launches_total[key] += c

        # -- each kernel vs its plain version, at the path's shapes ---------
        h = smt.NtHasher(K, canonical=b.canonical)  # the builders' default hasher
        key, table, _ = convert.hasher_tensors(h, dev)
        kargs = (words, N, K, W, table, key[2], b.canonical, mode,
                 plane if amb else None)
        pargs = (*kargs[:7], tile, *kargs[7:])

        scratch, counts = fused.minimizer_tiles(*kargs)
        p_scratch, p_counts = pipeline.minimizer_tiles_plain(*pargs)
        live = torch.arange(tile, device=dev) < counts[:, None]
        err = max([_max_abs_err(counts, p_counts)] + [
            _max_abs_err(g[live], p[live])
            for g, p in zip(scratch.view(-1, counts.numel(), tile),
                            p_scratch.view(-1, counts.numel(), tile))])
        del p_scratch, live
        entry(instance, 1631, err,
              _median_ms(lambda: fused.minimizer_tiles(*kargs), 5, 10, 2),
              _median_ms(lambda: pipeline.minimizer_tiles_plain(*pargs), 3, 2, 1))

        offsets = fused.tile_offsets(counts)
        err = _max_abs_err(offsets, pipeline.tile_offsets_plain(counts))
        entry("tile_offsets", 841, err,
              _median_ms(lambda: fused.tile_offsets(counts), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_offsets_plain(counts), 5, 10, 2))

        total = int(offsets[-1])
        got = fused.tile_append(scratch, counts, offsets, total)
        err = _max_abs_err(got, pipeline.tile_append_plain(scratch, counts, offsets, total, tile))
        entry("tile_append", 841, err,
              _median_ms(lambda: fused.tile_append(scratch, counts, offsets, total), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_append_plain(scratch, counts, offsets, total,
                                                            tile), 3, 3, 1))
        if any(e["max_abs_err"] for e in entries.values()):
            raise RuntimeError(f"{name}: a kernel disagrees with its plain version")

        # -- the whole kernel path against the plain pipeline and Builder.run
        def kern():
            return fused.fused_sketch(*kargs)

        def plain():
            return pipeline.run_pipeline(*kargs)

        got_path = kern()
        got_planes = got_path if mode == SKM else (got_path,)
        if (_max_abs_err(got_path, plain()) != 0
                or any(not np.array_equal(o, g.cpu().numpy())
                       for o, g in zip(planes(out), got_planes, strict=True))):
            raise RuntimeError(f"{name}: the kernel path disagrees with the plain version "
                               "or Builder.run")
        count = got_planes[0].numel()
        density = count / nw
        print(f"  {count} kept, bit-equal to the plain version at {N} bp; density "
              f"{density:.4f}" + ("" if density_want is None else f" (want {density_want:.4f})"))
        if density_want is not None and abs(density - density_want) > 0.01:
            raise RuntimeError(f"{name}: density {density} is not about {density_want}")
        kt, pt = _median_ms(kern, 5, 10, 2), _median_ms(plain, 3, 3, 1)
        print(f"  kernel path {kt[0]:.4f} ms ({kt[0] * 1e6 / N:.5f} ns/bp; {kt[1]:.4f}.."
              f"{kt[2]:.4f}), plain {pt[0]:.3f} ms ({pt[0] * 1e6 / N:.4f} ns/bp; "
              f"{pt[1]:.3f}..{pt[2]:.3f}); {card_note}")
        del scratch, counts, offsets, got, got_path, got_planes
        print(f"  peak extra device memory: kernel path {_peak_extra_mib(kern):.1f} MiB, "
              f"plain {_peak_extra_mib(plain):.1f} MiB")

        # Builder.run: the main path call, then warm runs split in parts
        parts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up = convert.packed_words(seq, dev)
            up_plane = convert.ambiguity_plane(mask, N, dev) if amb else None
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = backend.sketch(up, N, K, W, h, mode, up_plane)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for r in res if mode == SKM else (res,):
                r.cpu()
            t3 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        spans = ["..".join(f"{f(col):.2f}" for f in (min, max)) for col in zip(*parts)]
        print(f"  Builder.run wall: main path call {wall * 1e3:.2f} ms; warm upload / "
              f"kernel path / download, 3 runs: {' / '.join(spans)} ms; {card_note}")
        del out

    never = [key for key, c in launches_total.items() if not c]
    if never:
        raise RuntimeError(f"no path launched {never}")
    for e in entries.values():
        e["launches"] = launches_total[e["name"]]

    # -- against the oracle: 1e6 bases (same mask shape), golden vectors ----
    small_rng = np.random.default_rng(args.seed + 1)
    small = smt.PackedSeqVec.random(N_ORACLE, small_rng)
    small_n = smt.PackedNSeqVec(small, _chromosome_mask(N_ORACLE, small_rng))
    for name, b, mode, amb, _ in paths:
        want = planes(b.run_scalar(small, ambiguous=small_n.ambiguous if amb else None))
        for device in (dev, "cpu"):
            got = planes(drive(b, amb, small, small_n, device))
            if not all(np.array_equal(g, p) for g, p in zip(got, want, strict=True)):
                raise RuntimeError(f"{name}: Builder on {device} disagrees with the oracle "
                                   f"at {N_ORACLE} bp")
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
    print(f"oracle: every path's builder bit-equal at {N_ORACLE} bp (card and CPU), "
          "golden vectors equal")

    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
