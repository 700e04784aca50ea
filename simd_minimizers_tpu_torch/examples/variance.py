"""Minimizer density and count variance (the reference's examples/variance.rs).

    python -m simd_minimizers_tpu_torch.examples.variance --k 21 --w 11 --len 10000 --reps 200
    python -m simd_minimizers_tpu_torch.examples.variance --device cuda

The counterpart of the JAX package's examples/variance.py: forward nt
minimizers of `--reps` random sequences of `--len` bases (seed 42), their
density against 2/(w+1) and the variance of their count, through the
port's NumPy oracle; with `--device cuda` (or `cpu`) through `Builder.run`
on that device, each count held equal to the oracle's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--w", type=int, default=11)
    ap.add_argument("--len", type=int, dest="length", default=10000)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="run the kernel path on this device (default: the oracle only)")
    args = ap.parse_args(argv)

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.ops import oracle

    rng = np.random.default_rng(42)
    h = smt.NtHasher(args.k, canonical=False)
    b = smt.minimizers(args.k, args.w)
    counts = []
    for _ in range(args.reps):
        codes = rng.integers(0, 4, args.length, dtype=np.uint8)
        want = oracle.collect_and_dedup(oracle.selected_stream(codes, args.k, args.w, h)).size
        if args.device is not None:
            got = b.run(smt.PackedSeqVec.from_codes(codes), device=args.device).positions.size
            if got != want:
                raise SystemExit(f"the {args.device} path counts {got} minimizers, the oracle "
                                 f"{want}")
        counts.append(want)
    counts = np.asarray(counts, np.float64)
    nw = args.length - (args.k + args.w - 1) + 1
    via = "oracle" if args.device is None else f"Builder.run on {args.device} (= oracle)"
    print(f"k={args.k} w={args.w} len={args.length} reps={args.reps} via {via}")
    print(f"density  mean={counts.mean() / nw:.5f}  expected 2/(w+1)={2 / (args.w + 1):.5f}")
    print(f"count    mean={counts.mean():.2f}  var={counts.var():.2f}  "
          f"var/mean={counts.var() / counts.mean():.4f}")
    res = {"density": counts.mean() / nw, "expected": 2 / (args.w + 1),
           "count_mean": counts.mean(), "count_var": counts.var(), "via": via}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
