"""Quick latency probe of `Builder.run` (the reference's examples/bench.rs,
min of samples), host included.

    python -m simd_minimizers_tpu_torch.examples.bench --n 10000000 --k 21 --w 11 --canonical

The counterpart of the JAX package's examples/bench.py: random 2-bit bases
from seed 0, one warm call, then the least wall time of `--samples` calls
of `Builder.run` on `--device` (default the card), each ending with the
positions on the host. Prints the time, ns/bp and the count, then one JSON
line of the same.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10**7)
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--w", type=int, default=11)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.utils.device import require_cuda

    dev = require_cuda(args.device)
    seq = smt.PackedSeqVec.random(args.n, np.random.default_rng(0))
    b = (smt.canonical_minimizers if args.canonical else smt.minimizers)(args.k, args.w)
    count = b.run(seq, device=dev).positions.size  # build and warm
    best = float("inf")
    for _ in range(args.samples):
        t0 = time.perf_counter()
        b.run(seq, device=dev)
        best = min(best, time.perf_counter() - t0)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"n={args.n} k={args.k} w={args.w} canonical={args.canonical} on {where}: "
          f"{best:.4f}s ({best * 1e9 / args.n:.4f} ns/bp incl. host), {count} minimizers")
    res = {"n": args.n, "k": args.k, "w": args.w, "canonical": args.canonical,
           "device": where, "best_s": best, "ns_per_bp": best * 1e9 / args.n, "count": count}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
