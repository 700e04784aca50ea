"""One process of a gloo world for tests/test_torch_shard.py (started by
torch.multiprocessing; imports neither JAX nor the JAX package).

Each rank sketches the same seeded input with `multihost_sketch` in every
mode (and with a mask), runs the ragged all-gather of two planes of its own
length while counting the collectives, and saves what it got to
`<out>/rank<r>.npz`.
"""

from __future__ import annotations

import datetime

import numpy as np


def inputs(n: int, seed: int):
    """(codes, mask) that every rank makes alike."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    return codes, (rng.random(n) < 0.005).astype(np.uint8)


RUNS = [("minimizers", True, False), ("superkmers", True, False),
        ("closed_syncmers", False, False), ("open_syncmers", False, False),
        ("minimizers", True, True)]  # (mode, canonical, masked)


def run(rank: int, world: int, port: int, n: int, seed: int, out: str) -> None:
    import torch.distributed as dist

    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.parallel import multihost

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        k, w = 11, 7
        codes, mask = inputs(n, seed)
        res = {}
        for mode, canonical, masked in RUNS:
            got = multihost.multihost_sketch(codes, k, w, smt.NtHasher(k, canonical=canonical),
                                             mode, mask if masked else None, device="cpu")
            for i, plane in enumerate(got if mode == "superkmers" else (got,)):
                res[f"{mode}{'_masked' if masked else ''}_{i}"] = plane
        calls = []
        gather = multihost.dist.all_gather

        def counted(*args, **kwargs):
            calls.append(1)
            return gather(*args, **kwargs)

        multihost.dist.all_gather = counted
        try:
            a = np.arange(3 * rank, dtype=np.uint32)
            parts, aux = multihost._allgather_ragged_planes([a, a + 1000], world)
        finally:
            multihost.dist.all_gather = gather
        res["collectives"] = np.asarray([len(calls)])
        for p in range(world):
            res[f"gathered_{p}"] = parts[p]
            res[f"gathered_aux_{p}"] = aux[p]
        np.savez(f"{out}/rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
