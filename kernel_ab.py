"""Time the port's kernels in several checkouts of the repo, in turns, on one CUDA card.

    python3 kernel_ab.py DIR [DIR ...] [--rounds R] [--seed S] [--passes] [--small]

Each DIR is the root of a checkout of the repo (for example a commit's
`git archive`, unpacked into a directory that .gitignore lists). The
kernels of every DIR are built first, all at once; then, in each of R
rounds, a fresh process per DIR (in reverse order every other round: A B,
B A, ...) imports the package from that DIR and times, on inputs made from
the same seed, with CUDA events:
- `minimizer_tiles` and the kernel path (`fused_sketch`) at k=21 w=11 over
  1e8 random bases, canonical and forward: median of 5 batches of 10 calls;
- `tile_offsets` on the 24,415 counts of the canonical launch and on
  131,072 random counts (the tiles of a 2^29-char span), two ways: eager
  calls from Python (events around 10 calls, so the host's enqueue counts
  where it is the longer), and device time per call in a CUDA graph of 20
  calls, replayed; `torch.cumsum` the same two ways beside it;
- `minimizer_tiles` on the seven large-w paths of chip_smoke.py at 1e8
  chars: median of 5 batches of 3 calls; where the checkout has the
  pre-pass `kmer_top16`, its time alone on the same inputs (median of 5
  batches of 5 calls) and on canonical nt at k = 21, 31 and 63; where the
  checkout's wrapper takes `top16`, also the route given the pre-pass's
  tops (the same median), and where it has `tiles_occupancy`, the blocks
  per SM of the launch;
- the `ShortSeqSketcher` replay at 8,192 chars (`measure_floor`'s
  replay_us, canonical k=21 w=11);
- `device_values.kmer_values_limbs` on the positions of the kernel path
  over the 1e8 bases (canonical and forward k=21, canonical k=33, forward
  k=64; canonical k=21 also in a random permutation) and on code bytes of
  the first 46,709,983 bases (chr21's length, the FASTA CLI's values step)
  at the canonical positions inside them, and `fused.tile_append` on the
  canonical, canonical open-syncmer and canonical super-k-mer (two planes)
  launches at w=11: median of 5 batches of 10 calls, each beside its bound
  (chip_smoke.py's: bytes moved once, or integer operations) as
  "bound ..." and its share of it as "share ..." (bound / time); beside
  each tile_append, `Tensor.copy_` of as many contiguous ints (the card's
  own copy of the same bytes, not the same function).
With --small, each process times only `minimizer_tiles` and the kernel
path at w=11, the replay and the last item (the paths that kmer_values and
tile_append run on), for variants of those two kernels. With --passes, in
its first round, each DIR whose `minimizer_tiles` takes `passes` also
times every doubling-pass count of the stored route at k=21 w=11 over the
1e8 bases, each bit-equal to the default.
Each process prints one JSON line of its numbers (ms; replay in us); at the
end comes a table of each number, per DIR the mean of its runs, and its
ratio to the first DIR's. Only the API that every slice of the port has is
called, so any two of its commits compare. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 10**8
K, W = 21, 11
SPAN_TILES = 1 << 17
# (name, canonical, w, mode, chromosome mask, input): chip_smoke.py's large-w
# paths ("dna": the 2-bit byte stream), and canonical code bytes, one a base
LARGE_W = [
    ("canonical w=32767", True, 32_767, "minimizers", False, "dna"),
    ("forward w=61439 masked", False, 61_439, "minimizers", True, "dna"),
    ("text mul w=32767", False, 32_767, "minimizers", False, "text"),
    ("canonical super-k-mers w=32767", True, 32_767, "superkmers", False, "dna"),
    ("forward closed syncmers w=32767", False, 32_767, "closed_syncmers", False, "dna"),
    ("canonical w=21721", True, 21_721, "minimizers", False, "dna"),
    ("canonical w=21723", True, 21_723, "minimizers", False, "dna"),
    ("canonical code bytes w=32767", True, 32_767, "minimizers", False, "code bytes"),
]
TOP16_K = (21, 31, 63)  # the large-w pre-pass alone, canonical nt over the 1e8 bases
CHR21 = 46_709_983  # GRCh38 chr21's length: the code bytes of kmer_values' CLI path


def _helpers():
    """chip_smoke.py of this checkout (timing helpers, the mask shape),
    whatever DIR is first on sys.path."""
    spec = importlib.util.spec_from_file_location("_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(root: str) -> None:
    sys.path.insert(0, root)
    from simd_minimizers_tpu_torch.ops import _build as b

    b.library()
    print(f"built {root} in {b.build_seconds:.1f} s", file=sys.stderr)


def _worker(root: str, seed: int, passes: bool, small: bool) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import fused
    from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher

    h = _helpers()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    seq = smt.PackedSeqVec.random(N, rng)
    mask = h._chromosome_mask(N, rng)
    text = smt.GenericSeq(rng.integers(32, 127, N, dtype=np.uint8))
    dna = convert.packed_words(seq, dev)
    txt = convert.text_bytes(text, dev)
    plane = convert.ambiguity_plane(mask, N, dev)
    out = {"root": root}

    def tables(hasher, is_text=False):
        (kind, canonical, rot), t = convert.hasher_tensors(hasher, dev, is_text)
        return t, rot, canonical, kind

    def replay():
        codes = np.random.default_rng(seed + 8).integers(0, 4, 8192, dtype=np.uint8)
        sk = ShortSeqSketcher(K, W, smt.NtHasher(K, canonical=True), donate=False, device=dev)
        out["ShortSeqSketcher replay_us"] = sk.measure_floor(codes)["replay_us"]

    def scan(counts, tag):
        eager = h._median_ms(lambda: fused.tile_offsets(counts), 5, 10, 2)[0]
        graph = h._graph_ms(lambda: fused.tile_offsets(counts))[0]
        lib_eager = h._median_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32), 5, 10, 2)[0]
        lib_graph = h._graph_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32))[0]
        out[f"tile_offsets {tag} eager"] = eager
        out[f"tile_offsets {tag} graph"] = graph
        out[f"cumsum {tag} eager"] = lib_eager
        out[f"cumsum {tag} graph"] = lib_graph

    for canonical in (True, False):
        t, rot, can, kind = tables(smt.NtHasher(K, canonical=canonical))
        args = (dna, N, K, W, t, rot, can)
        strand = "canonical" if canonical else "forward"
        out[f"minimizer_tiles w=11 {strand}"] = h._median_ms(
            lambda: fused.minimizer_tiles(*args), 5, 10, 2)[0]
        out[f"kernel path w=11 {strand}"] = h._median_ms(
            lambda: fused.fused_sketch(*args), 5, 10, 2)[0]
        if small:
            continue
        if canonical:
            _, counts = fused.minimizer_tiles(*args)
            scan(counts, f"{counts.numel()}")
        if passes and "passes" in inspect.signature(fused.minimizer_tiles).parameters:
            want = fused.fused_sketch(*args)
            for p in range(W.bit_length()):
                s, c = fused.minimizer_tiles(*args, passes=p)
                got = fused.tile_append(s, c, fused.tile_offsets(c), None)[:want.numel()]
                if not torch.equal(got, want):
                    raise RuntimeError(f"{p} passes disagree with the default")
                out[f"minimizer_tiles w=11 {strand} passes={p}"] = h._median_ms(
                    lambda: fused.minimizer_tiles(*args, passes=p), 5, 10, 2)[0]
    if small:
        replay()
        _values_and_append(out, h, seq, dna, dev, tables, seed)
        return out
    g = torch.Generator(device=dev).manual_seed(seed)
    span_counts = torch.randint(0, 2 * fused.TILE // (W + 1), (SPAN_TILES,), dtype=torch.int32,
                                device=dev, generator=g)
    scan(span_counts, f"{SPAN_TILES}")

    codes = convert.code_bytes(seq.codes(), dev)
    for name, canonical, w, mode, masked, inp in LARGE_W:
        is_text = inp == "text"
        hasher = smt.MulHasher(K) if is_text else smt.NtHasher(K, canonical=canonical)
        t, rot, can, kind = tables(hasher, is_text)
        chars = {"dna": dna, "text": txt, "code bytes": codes}[inp]
        args = (chars, N, K, w, t, rot, can, mode, plane if masked else None)
        kw = {"text": is_text, "kind": kind}
        if inp == "code bytes":
            kw["byte_codes"] = True
        out[f"minimizer_tiles {name}"] = h._median_ms(
            lambda: fused.minimizer_tiles(*args, **kw), 5, 3, 1)[0]
        if hasattr(fused, "kmer_top16"):
            out[f"kmer_top16 {name}"] = h._median_ms(
                lambda: fused.kmer_top16(*args[:3], *args[4:7], **kw), 5, 5, 2)[0]
        if "top16" in inspect.signature(fused.minimizer_tiles).parameters:
            tops = fused.kmer_top16(*args[:3], *args[4:7], **kw)
            out[f"route given its tops {name}"] = h._median_ms(
                lambda: fused.minimizer_tiles(*args, **kw, top16=tops), 5, 3, 1)[0]
            del tops
        if hasattr(fused, "tiles_occupancy"):
            out[f"blocks per SM {name}"] = fused.tiles_occupancy(
                K, w, can, mode, masked, is_text, kind, dev)[0]

    if hasattr(fused, "kmer_top16"):
        for k in TOP16_K:
            t, rot, can, kind = tables(smt.NtHasher(k, canonical=True))
            out[f"kmer_top16 canonical k={k}"] = h._median_ms(
                lambda: fused.kmer_top16(dna, N, k, t, rot, can, kind=kind), 5, 5, 2)[0]

    replay()
    _values_and_append(out, h, seq, dna, dev, tables, seed)
    return out


def _timed(out, h, name, fn, bound):
    ms = h._median_ms(fn, 5, 10, 2)[0]
    out[name] = ms
    out[f"bound {name}"] = bound[0]
    out[f"share {name}"] = bound[0] / ms


def _values_and_append(out, h, seq, dna, dev, tables, seed):
    """kmer_values and tile_append at the shapes of the main paths."""
    import torch

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import device_values, fused, pipeline

    def positions(k, canonical):
        t, rot, can, kind = tables(smt.NtHasher(k, canonical=canonical))
        return fused.fused_sketch(dna, N, k, W, t, rot, can)

    def values(name, chars, pos, k, canonical, byte_codes=False):
        m, L = pos.numel(), device_values.limb_count(k)
        bound = h._bound(chars.numel() + 4 * m + 4 * m * L,
                         m * h._values_ops_per_position(k, canonical))
        _timed(out, h, f"kmer_values {name}", lambda: device_values.kmer_values_limbs(
            chars, pos, k, canonical, byte_codes), bound)

    can21 = positions(K, True)
    values("canonical k=21", dna, can21, K, True)
    g = torch.Generator(device=dev).manual_seed(seed)
    values("canonical k=21 permuted", dna,
           can21[torch.randperm(can21.numel(), device=dev, generator=g)], K, True)
    values("forward k=21", dna, positions(K, False), K, False)
    values("canonical k=33", dna, positions(33, True), 33, True)
    values("forward k=64", dna, positions(64, False), 64, False)
    codes = convert.code_bytes(seq.codes()[:CHR21], dev)
    values("code bytes (chr21 length)", codes, can21[can21 <= CHR21 - K], K, True,
           byte_codes=True)
    del codes, can21

    for name, mode in (("canonical", pipeline.MODE_MINIMIZERS),
                       ("canonical open syncmers", pipeline.MODE_OPEN_SYNCMERS),
                       ("canonical super-k-mers", pipeline.MODE_SUPERKMERS)):
        t, rot, can, kind = tables(smt.NtHasher(K, canonical=True))
        scratch, counts = fused.minimizer_tiles(dna, N, K, W, t, rot, can, mode)
        offsets = fused.tile_offsets(counts)
        total = int(offsets[-1])
        planes = 2 if mode == pipeline.MODE_SUPERKMERS else 1
        bound = h._bound(2 * 4 * planes * total + 4 * (2 * counts.numel() + 1), planes * total)
        _timed(out, h, f"tile_append {name}",
               lambda: fused.tile_append(scratch, counts, offsets, total), bound)
        src = scratch.view(-1)[:planes * total]
        dst = torch.empty(planes * total, dtype=torch.int32, device=dev)
        out[f"copy_ of as many ints, {name}"] = h._median_ms(lambda: dst.copy_(src), 5, 10, 2)[0]
        del scratch, src, dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--passes", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        _build(args.dirs[0])
        return 0
    if args.worker:
        print(json.dumps(_worker(args.dirs[0], args.seed, args.passes, args.small)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 2
    dirs = [str(Path(d).resolve()) for d in args.dirs]
    me = [sys.executable, str(Path(__file__).resolve())]
    t = time.perf_counter()
    builds = [subprocess.Popen([*me, "--build", d]) for d in dirs]
    if any(p.wait() for p in builds):
        raise RuntimeError("a build failed")
    print(f"kernel_ab: built {len(dirs)} checkouts in {time.perf_counter() - t:.1f} s")
    runs = {d: [] for d in dirs}
    for r in range(args.rounds):
        for d in (dirs if r % 2 == 0 else dirs[::-1]):
            extra = (["--passes"] if args.passes and r == 0 else []) + (
                ["--small"] if args.small else [])
            res = subprocess.run([*me, "--worker", d, "--seed", str(args.seed), *extra],
                                 capture_output=True, text=True, env=dict(os.environ))
            if res.returncode:
                print(res.stdout, res.stderr, sep="\n", file=sys.stderr)
                raise RuntimeError(f"the worker of {d} failed ({res.returncode})")
            line = res.stdout.strip().splitlines()[-1]
            print(line)
            runs[d].append(json.loads(line))
    base = dirs[0]
    keys = [key for key in dict.fromkeys(key for d in [base, *dirs] for run in runs[d]
                                         for key in run) if key != "root"]
    print("\nmean of each DIR's runs (ms; replay us; shares as fractions), and its ratio to "
          + base)
    print(" | ".join(["number"] + dirs))
    for key in keys:
        means = [[run[key] for run in runs[d] if key in run] for d in dirs]
        means = [sum(v) / len(v) if v else None for v in means]
        cells = [key] + [("-" if m is None else f"{m:.5f}" + (
            f" ({m / means[0]:.3f}x)" if means[0] and i else "")) for i, m in enumerate(means)]
        print(" | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
