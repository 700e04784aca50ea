"""Genome sketching from the command line: FASTA in, minimizers out.

    python -m simd_minimizers_tpu_torch.sketch_fasta genome.fa --k 21 --w 11 \\
        --canonical --skip-ambiguous --out sketch.npz [--values] \\
        [--syncmers closed|open] [--device cuda]

The port's counterpart of examples/sketch_fasta.py, with its options and
its .npz layout: `<record>/positions` (np.uint32, window indices for
syncmers) and, with --values for minimizers, `<record>/values` (u64 k-mer
values). It parses the FASTA (`seq.fasta.read_fasta`), sketches every
record through `ops.backend.sketch_records` on `--device` (the Hopper
kernels on a CUDA card, their plain versions on the CPU), and prints the
times of its stages to standard error: CUDA set-up and the kernel
library's load (on a card), parse, sketch, values and the .npz write.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fasta")
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--w", type=int, default=11)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--values", action="store_true", help="also write u64 k-mer values")
    ap.add_argument("--syncmers", choices=["closed", "open"], default=None)
    ap.add_argument("--skip-ambiguous", action="store_true",
                    help="skip windows containing non-ACGT bases")
    ap.add_argument("--out", default="sketch.npz")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from .hashers import NtHasher
    from .ops import _build, backend, pipeline, values
    from .seq.fasta import read_fasta
    from .utils.device import require_cuda

    def log(msg):
        print(msg, file=sys.stderr)

    mode = {None: pipeline.MODE_MINIMIZERS,
            "closed": pipeline.MODE_CLOSED_SYNCMERS,
            "open": pipeline.MODE_OPEN_SYNCMERS}[args.syncmers]
    h = NtHasher(args.k, canonical=args.canonical)
    device = require_cuda(args.device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        _build.library()
        log(f"CUDA set-up {t1 - t0:.2f}s, kernel library load {time.perf_counter() - t1:.2f}s")
    t0 = time.perf_counter()
    recs = read_fasta(args.fasta)
    t1 = time.perf_counter()
    total_bp = sum(len(r) for r in recs)
    log(f"parsed {len(recs)} records, {total_bp / 1e6:.1f} Mbp in {t1 - t0:.2f}s")

    amb = [r.ambiguous for r in recs] if args.skip_ambiguous else None
    # the FASTA reader gives 2-bit codes: no probe of the input
    all_pos = backend.sketch_records([r.codes for r in recs], args.k, args.w, h, mode, amb,
                                     dna=True, device=device)
    t2 = time.perf_counter()
    out = {}
    total_pos = 0
    for rec, pos in zip(recs, all_pos):
        out[f"{rec.name}/positions"] = pos
        total_pos += pos.size
        if args.values and mode == pipeline.MODE_MINIMIZERS:
            fn = values.canonical_kmer_values_u64 if args.canonical else values.kmer_values_u64
            out[f"{rec.name}/values"] = fn(rec.codes, pos, args.k)
    t3 = time.perf_counter()
    log(f"sketched {total_pos} positions in {t2 - t1:.2f}s "
        f"({total_bp / max(t2 - t1, 1e-9) / 1e9:.2f} Gbp/s wall)"
        + (f", values {t3 - t2:.2f}s" if args.values else ""))
    np.savez_compressed(args.out, **out)
    log(f"wrote {args.out} in {time.perf_counter() - t3:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
