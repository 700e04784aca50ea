"""Two-process multi-host sketch demo on one machine.

    python -m simd_minimizers_tpu_torch.examples.multihost_demo [n_chars] [--device cuda|cpu]

The counterpart of the JAX package's examples/multihost_demo.py. It starts
two processes, a torch.distributed world of two over gloo
(tcp://127.0.0.1 at a free port). Both call `multihost_sketch`
identically: each sketches its shard of the same seeded genome on
`--device` (default the card; both ranks share it), the shards'
results are all-gathered over gloo, and both ranks must return the
oracle's global list, for canonical minimizers, super-k-mers (the two-plane
all-gather) and skip-ambiguous minimizers (the seam merge of SKIPPED
runs). NCCL refuses two ranks on one card, so the collectives run over
gloo on CPU tensors. Each process has a timeout on its group and the
parent on each process; it exits nonzero if a rank fails or hangs.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import time

import numpy as np

WORLD = 2
TIMEOUT_S = 300


def worker(rank: int, world: int, init: str, n: int, device: str) -> None:
    import torch.distributed as dist

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.ops import oracle
    from simd_minimizers_tpu_torch.parallel import multihost

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        rng = np.random.default_rng(77)
        codes = rng.integers(0, 4, n, dtype=np.uint8)  # the same data in every process
        k, w = 21, 11
        h = smt.NtHasher(k, canonical=True)
        got = multihost.multihost_sketch(codes, k, w, h, device=device)
        want = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
        np.testing.assert_array_equal(got, want)
        print(f"[rank {rank}] {got.size} positions on {device}, bit-exact", flush=True)
        got_p, got_i = multihost.multihost_sketch(codes, k, w, h, mode="superkmers",
                                                  device=device)
        want_p, want_i = oracle.collect_and_dedup_with_index(
            oracle.selected_stream(codes, k, w, h))
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_i, want_i)
        amb = (rng.random(n) < 0.005).astype(np.uint8)
        got_a = multihost.multihost_sketch(codes, k, w, h, ambiguous_np=amb, device=device)
        want_a = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h, ambiguous=amb),
                                          skip_sentinel=True)
        np.testing.assert_array_equal(got_a, want_a)
        print(f"[rank {rank}] super-k-mers and skip-ambiguous bit-exact", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=50_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.rank, WORLD, args.init, args.n, args.device)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("multihost_demo: --device cuda needs a CUDA card", file=sys.stderr)
            return 2
    init = f"tcp://127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "simd_minimizers_tpu_torch.examples."
                               "multihost_demo", str(args.n), "--device", args.device,
                               "--rank", str(r), "--init", init], cwd=root,
                              stdout=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    rcs = []
    try:
        for p in procs:  # each rank's lines, in rank order
            out, _ = p.communicate(timeout=TIMEOUT_S + 60)
            print(out, end="", flush=True)
            rcs.append(p.returncode)
    except subprocess.TimeoutExpired:
        rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * WORLD:
        print(f"multihost demo: rank exit codes {rcs}", file=sys.stderr)
        return 1
    print(f"multihost demo: both processes produced the bit-exact global list on "
          f"{args.device} ({time.perf_counter() - t:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
