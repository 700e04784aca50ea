"""Sharded and multi-process sketching through the port on the CPU.

`parallel/shard.fused_sharded_sketch` over a mesh of eight CPU entries ==
the JAX package's `fused_sharded_sketch(..., interpret=True)` on its
8-device CPU mesh == the NumPy oracle, in every mode (one size per mode
family, so the JAX side compiles little); the empty shards of an input
with fewer windows than devices; the seam merge with ambiguous runs at the
seam; large w. Then `parallel/multihost` in gloo worlds of two and of
three processes (one with an empty shard), started by
torch.multiprocessing with a timeout on the process group and the join:
every rank returns the one-process result, and the ragged all-gather takes
exactly two collectives. Integer outputs: tolerance 0.
"""

import socket

import numpy as np
import pytest
import torch.multiprocessing as mp

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.parallel import shard as jshard
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import spans
from simd_minimizers_tpu_torch.parallel import multihost, shard

RNG = np.random.default_rng(0xD15)
CPU8 = shard.default_mesh(8, device="cpu")


def _want(codes, k, w, h, mode, amb=None):
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == "superkmers":
        return oracle.collect_and_dedup_with_index(sel)
    if mode.endswith("syncmers"):
        return oracle.collect_syncmers(sel, w, mode == "open_syncmers")
    return oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)


def _equal(got, *wants):
    for want in wants:
        for g, p in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,), strict=True):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("mode", ["minimizers", "superkmers", "closed_syncmers",
                                  "open_syncmers", "skip_ambiguous"])
def test_fused_sharded_all_modes_on_mesh(mode):
    """test_multihost.py's case: k=11, w=7, 30,000 bases, eight shards."""
    k, w, n = 11, 7, 30000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=mode in ("minimizers", "superkmers", "skip_ambiguous"))
    amb, kernel_mode = None, mode
    if mode == "skip_ambiguous":
        kernel_mode = "minimizers"
        amb = (RNG.random(n) < 0.005).astype(np.uint8)
    got = shard.fused_sharded_sketch(codes, k, w, convert.hasher_from(h), kernel_mode, amb,
                                     mesh=CPU8)
    ref = jshard.fused_sharded_sketch(codes, k, w, h, mode=kernel_mode, ambiguous_np=amb,
                                      mesh=jshard.default_mesh(), C=1024, interpret=True)
    _equal(got, ref, _want(codes, k, w, h, kernel_mode, amb))
    assert shard.sharded_sketch is shard.fused_sharded_sketch


def test_fused_sharded_with_empty_trailing_shards():
    """nw = 5 < 8 shards: the trailing shards launch nothing and add
    nothing, for minimizers and super-k-mers (two planes)."""
    k, w = 5, 7
    codes = RNG.integers(0, 4, k + w - 1 + 4, dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    ph = convert.hasher_from(h)
    for mode in ("minimizers", "superkmers"):
        got = shard.fused_sharded_sketch(codes, k, w, ph, mode, mesh=CPU8)
        ref = jshard.fused_sharded_sketch(codes, k, w, h, mode=mode, mesh=jshard.default_mesh(),
                                          C=1024, interpret=True)
        _equal(got, ref, _want(codes, k, w, h, mode))
    empty = shard.fused_sharded_sketch(codes[:10], k, w, ph, "superkmers", mesh=CPU8)
    assert len(empty) == 2 and all(e.size == 0 for e in empty)


def test_seam_merge_with_trailing_skipped_run():
    """Two shards whose seam lies among ambiguous chars: the seam-aware
    merge equals the oracle (and the JAX package's)."""
    k, w, n = 5, 7, 220
    rng = np.random.default_rng(7)
    h = NtHasher(k, canonical=True)
    for trial in range(8):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        amb = np.zeros(n, np.uint8)
        amb[rng.integers(90, 130, 3)] = 1
        got = shard.fused_sharded_sketch(codes, k, w, convert.hasher_from(h), "minimizers", amb,
                                         mesh=shard.default_mesh(2, device="cpu"))
        np.testing.assert_array_equal(got, _want(codes, k, w, h, "minimizers", amb),
                                      err_msg=f"trial {trial}")


def test_fused_sharded_large_w_on_mesh():
    """w = 1,200 (the large-w route on a card) over eight shards."""
    k, w, n = 5, 1200, 60000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=False)
    got = shard.fused_sharded_sketch(codes, k, w, convert.hasher_from(h), mesh=CPU8)
    _equal(got, _want(codes, k, w, h, "minimizers"))


def test_asserts_and_default_mesh():
    """The JAX package's AssertionErrors; the CPU mesh on request."""
    codes = RNG.integers(0, 4, 200, dtype=np.uint8)
    with pytest.raises(AssertionError, match="odd w"):
        shard.fused_sharded_sketch(codes, 5, 8, convert.hasher_from(NtHasher(5)),
                                   "open_syncmers", mesh=CPU8)
    with pytest.raises(AssertionError, match="odd"):
        shard.fused_sharded_sketch(codes, 5, 8, convert.hasher_from(NtHasher(5, canonical=True)),
                                   mesh=CPU8)
    assert [d.type for d in shard.default_mesh(3, device="cpu")] == ["cpu"] * 3


@pytest.mark.parametrize("mode", ["minimizers", "superkmers", "closed_syncmers"])
def test_local_shards_merge_to_the_whole(mode):
    """local_shard_sketch of three shards, merged by mode, == the oracle;
    shard_bounds cover every window once; super-k-mers with a mask raise."""
    k, w, n = 11, 7, 20000
    codes = RNG.integers(0, 4, n, dtype=np.uint8)
    h = NtHasher(k, canonical=mode != "closed_syncmers")
    ph = convert.hasher_from(h)
    parts = [multihost.local_shard_sketch(codes, k, w, ph, 3, s, mode, device="cpu")
             for s in range(3)]
    starts = [multihost.shard_bounds(n, k + w - 1, 3, s)[0] for s in range(3)]
    _equal(spans.merge(parts, starts, mode, k, w, ph, codes), _want(codes, k, w, h, mode))
    covered = []
    for s in range(3):
        a, e = multihost.shard_bounds(n, k + w - 1, 3, s)
        covered.extend(range(a, e - (k + w - 1) + 1))
    assert covered == list(range(n - k - w + 2))
    with pytest.raises(AssertionError):
        multihost.local_shard_sketch(codes, k, w, ph, 3, 0, "superkmers",
                                     np.zeros(n, np.uint8), device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world,n", [(2, 20000), (3, 18)])
def test_gloo_world(tmp_path, world, n):
    """multihost_sketch in a gloo world (n = 18 leaves the third shard of
    three without a window): every rank returns the one-process result in
    every mode, and the ragged all-gather of two planes takes two
    collectives and returns each rank's planes."""
    import torch_gloo_worker as worker

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.run, args=(r, world, port, n, 5, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(timeout=10)
    assert not hung, "a rank of the gloo world did not finish"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    codes, mask = worker.inputs(n, 5)
    k, w = 11, 7
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["collectives"][0]) == 2
        for p in range(world):
            np.testing.assert_array_equal(got[f"gathered_{p}"], np.arange(3 * p, dtype=np.uint32))
            np.testing.assert_array_equal(got[f"gathered_aux_{p}"],
                                          np.arange(3 * p, dtype=np.uint32) + 1000)
        for mode, canonical, masked in worker.RUNS:
            h = NtHasher(k, canonical=canonical)
            want = multihost.multihost_sketch(codes, k, w, convert.hasher_from(h), mode,
                                              mask if masked else None, device="cpu")
            ref = _want(codes, k, w, h, mode, mask if masked else None)
            tag = f"{mode}{'_masked' if masked else ''}"
            planes = 2 if mode == "superkmers" else 1
            _equal(tuple(got[f"{tag}_{i}"] for i in range(planes)) if planes == 2
                   else got[f"{tag}_0"], want, ref)
