"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed S]

Builds the port's kernels from the sources in this checkout and drives the
main path (canonical, then forward minimizers, k=21 w=11, over 1e8 random
2-bit bases) through the public `Builder.run`, counting each kernel's
launches. Then it calls each kernel's wrapper at the main path's shapes
and holds it against its plain PyTorch version (bit-equal: integer
outputs), holds the whole kernel path against the plain pipeline and
`Builder.run`, and the builders against the NumPy oracle at 1e6 bases and
on the golden vectors, and checks the density. It times each kernel, the
kernel path and their plain versions with CUDA events, measures the peak
device memory of both paths, and splits a warm `Builder.run` into upload,
kernel path and download. Every failed check raises, and the script exits
non-zero; without CUDA it exits non-zero before printing any result.

The card's name and power limit, then one JSON object with each kernel's
numbers, come on the lines before the last; the last line is
{"ok": true, "device": {...}}. `tile_offsets` and `tile_append` are timed on
the canonical run's tiles.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

N = 10**8  # bases: the reference paper's benchmark size
K, W = 21, 11


def _max_abs_err(got, want) -> int:
    """Largest |got - want| of two integer tensors; raises if the shapes differ."""
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
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    t = time.perf_counter()
    seq = smt.PackedSeqVec.random(N, rng)
    print(f"input: {N} random bases, seed {args.seed} ({time.perf_counter() - t:.2f} s)")

    # -- main path: the public builder, counted launches ------------------
    builders = {"canonical": smt.canonical_minimizers(K, W), "forward": smt.minimizers(K, W)}
    for name in fused.LAUNCHES:
        fused.LAUNCHES[name] = 0
    outs, wall = {}, {}
    for name, b in builders.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[name] = b.run(seq, device=dev)
        wall[name] = time.perf_counter() - t
    launches = dict(fused.LAUNCHES)
    print(f"main path launches: {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"the main path left a kernel unlaunched: {launches}")

    # -- each kernel vs its plain version, at the main path's shapes -------
    tile = fused.TILE
    words = convert.packed_words(seq, dev)
    nw = N - (K + W - 1) + 1
    card_note = f"card {card}"
    entries = {}

    def entry(name, source_line, launches_, err, kt, pt):
        e = entries.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "simd_minimizers_tpu_torch/csrc/minimizers.cu",
            "replaces": f"simd_minimizers_tpu/ops/fused.py:{source_line}",
            "launches": launches_, "max_abs_err": 0, "ms": kt[0], "plain_ms": pt[0]})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        print(f"  {name}: max_abs_err {err}; kernel {kt[0]:.4f} ms "
              f"({kt[1]:.4f}..{kt[2]:.4f}), plain {pt[0]:.4f} ms ({pt[1]:.4f}..{pt[2]:.4f})")

    for name, b in builders.items():
        print(f"{name}:")
        h = smt.NtHasher(K, canonical=b.canonical)  # the builders' default hasher
        key, table, _ = convert.hasher_tensors(h, dev)
        kargs = (words, N, K, W, table, key[2], b.canonical)

        scratch, counts = fused.minimizer_tiles(*kargs)
        p_scratch, p_counts = pipeline.minimizer_tiles_plain(*kargs, tile)
        live = torch.arange(tile, device=dev) < counts[:, None]
        err = max(_max_abs_err(counts, p_counts),
                  _max_abs_err(scratch.view(-1, tile)[live], p_scratch.view(-1, tile)[live]))
        del p_scratch, live
        mt = f"minimizer_tiles<{name}>"
        entry(mt, 1631, launches[mt], err,
              _median_ms(lambda: fused.minimizer_tiles(*kargs), 5, 10, 2),
              _median_ms(lambda: pipeline.minimizer_tiles_plain(*kargs, tile), 3, 2, 1))

        offsets = fused.tile_offsets(counts)
        err = _max_abs_err(offsets, pipeline.tile_offsets_plain(counts))
        entry("tile_offsets", 841, launches["tile_offsets"], err,
              _median_ms(lambda: fused.tile_offsets(counts), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_offsets_plain(counts), 5, 10, 2))

        total = int(offsets[-1])
        got = fused.tile_append(scratch, counts, offsets, total)
        err = _max_abs_err(got, pipeline.tile_append_plain(scratch, counts, offsets, total, tile))
        entry("tile_append", 841, launches["tile_append"], err,
              _median_ms(lambda: fused.tile_append(scratch, counts, offsets, total), 5, 10, 2),
              _median_ms(lambda: pipeline.tile_append_plain(scratch, counts, offsets, total,
                                                            tile), 3, 3, 1))
        if any(e["max_abs_err"] for e in entries.values()):
            raise RuntimeError(f"{name}: a kernel disagrees with its plain version")

        # the whole kernel path against the plain pipeline and Builder.run
        def kern():
            return fused.fused_sketch(*kargs)

        def plain():
            return pipeline.run_pipeline(*kargs)

        if (_max_abs_err(kern(), plain()) != 0
                or not np.array_equal(outs[name].positions, got.cpu().numpy())):
            raise RuntimeError(f"{name}: the kernel path disagrees with the plain version "
                               "or Builder.run")
        density = got.numel() / nw
        print(f"  {got.numel()} positions, bit-equal to the plain version at {N} bp; "
              f"density {density:.4f} (2/(w+1) = {2 / (W + 1):.4f})")
        if abs(density - 2 / (W + 1)) > 0.01:
            raise RuntimeError(f"{name}: density {density} is not about 2/(w+1)")
        kt, pt = _median_ms(kern, 5, 10, 2), _median_ms(plain, 3, 3, 1)
        print(f"  kernel path {kt[0]:.4f} ms ({kt[0] * 1e6 / N:.5f} ns/bp; {kt[1]:.4f}.."
              f"{kt[2]:.4f}), plain {pt[0]:.3f} ms ({pt[0] * 1e6 / N:.4f} ns/bp; "
              f"{pt[1]:.3f}..{pt[2]:.3f}); {card_note}")
        del scratch, counts, offsets, got
        print(f"  peak extra device memory: kernel path {_peak_extra_mib(kern):.1f} MiB, "
              f"plain {_peak_extra_mib(plain):.1f} MiB")

        # Builder.run: the first (main path) call, then warm runs split in parts
        parts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up = convert.packed_words(seq, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pos = backend.sketch(up, N, K, W, h)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pos.cpu()
            t3 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        spans = ["..".join(f"{f(col):.2f}" for f in (min, max)) for col in zip(*parts)]
        print(f"  Builder.run wall: main path call {wall[name] * 1e3:.2f} ms; warm upload / "
              f"kernel path / download, 3 runs: {' / '.join(spans)} ms; {card_note}")

    # -- against the oracle: 1e6 bases and the golden vectors ---------------
    small = smt.PackedSeqVec.random(10**6, np.random.default_rng(args.seed + 1))
    for name, b in builders.items():
        want = b.run_scalar_once(small)
        if not np.array_equal(b.run_once(small, device=dev), want):
            raise RuntimeError(f"{name}: kernel disagrees with the oracle at 1e6 bp")
        if not np.array_equal(b.run_once(small, device="cpu"), want):
            raise RuntimeError(f"{name}: plain version disagrees with the oracle at 1e6 bp")
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
    print("oracle: bit-equal at 1e6 bp (canonical, forward) and on the golden vectors")

    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
