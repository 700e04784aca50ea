"""The wall-time split of the port's entry points (utils/profiling): stages
are timed only inside `split_wall`, a stage inside another is charged to
the outer one, and the split leaves every result as it was. `trace` writes
a Chrome trace of a block; `timed_amortized` gives a positive time per
call."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch.ops import backend, pipeline
from simd_minimizers_tpu_torch.utils import profiling


def test_stages_are_free_outside_a_split():
    with profiling.stage("a"):
        pass
    with profiling.split_wall() as parts:
        pass
    assert parts == {}


def test_inner_stage_is_charged_to_the_outer():
    with profiling.split_wall() as parts:
        with profiling.stage("outer"):
            with profiling.stage("inner"):
                pass
        with profiling.stage("outer"):
            pass
        with profiling.stage("other"):
            pass
    assert sorted(parts) == ["other", "outer"]
    assert all(sec >= 0 for sec in parts.values())


def test_split_wall_does_not_nest():
    with profiling.split_wall():
        with pytest.raises(RuntimeError, match="nest"):
            with profiling.split_wall():
                pass
    with profiling.split_wall() as parts:  # the failed one left no state behind
        with profiling.stage("a"):
            pass
    assert list(parts) == ["a"]


def test_run_batch_split_keeps_the_result():
    """Builder.run_batch on the CPU: the stages of its host fold, slot
    fill, upload, kernels and read attribution (the download is a stage on
    a card only), and the same result as without the split."""
    rng = np.random.default_rng(0x5917)
    reads = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(n))].tobytes()
             for n in rng.integers(30, 400, 40)]
    b = smt.canonical_minimizers(7, 5)
    want = b.run_batch(reads, device="cpu")
    with profiling.split_wall() as parts:
        got = b.run_batch(reads, device="cpu")
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    assert {"fold reads to codes", "slot fill", "upload and padding plane", "kernels",
            "read attribution and order"} <= set(parts)


@pytest.mark.parametrize("batch_max_bp", [0, 1000])
def test_records_split_keeps_the_result(batch_max_bp):
    """backend.sketch_records with masks, on the span route and the batch
    route: the same records as without the split, and its stages."""
    k, w = 5, 7
    rng = np.random.default_rng(0x5918)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in rng.integers(40, 900, 10)]
    recs.append(rng.integers(0, 4, 5000, dtype=np.uint8))
    ambs = [(rng.random(r.size) < 0.02).astype(np.uint8) for r in recs]
    h = smt.NtHasher(k, canonical=True)
    want = backend.sketch_records(recs, k, w, h, pipeline.MODE_MINIMIZERS, ambs, device="cpu",
                                  batch_max_bp=batch_max_bp)
    with profiling.split_wall() as parts:
        got = backend.sketch_records(recs, k, w, h, pipeline.MODE_MINIMIZERS, ambs,
                                     device="cpu", batch_max_bp=batch_max_bp)
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    assert {"mask packing", "upload", "kernels", "seam merge"} <= set(parts)
    assert ("split by record" in parts) == bool(batch_max_bp)


def test_trace_writes_a_chrome_trace(tmp_path):
    """A torch.profiler trace of one Builder.run on the CPU, exported into
    the log directory, holds the run's CPU operations."""
    seq = smt.PackedSeqVec.random(3000, np.random.default_rng(1))
    logdir = tmp_path / "logs"
    with profiling.trace(str(logdir)) as path:
        out = smt.canonical_minimizers(5, 7).run(seq, device="cpu")
    assert os.path.dirname(path) == str(logdir) and os.path.isfile(path)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert out.positions.size


def test_trace_leaves_no_file_on_error(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            1 / 0
    assert not list(tmp_path.iterdir())


def test_timed_amortized():
    """Seconds per call of a CPU function: positive, and larger for more work."""
    calls = []

    def fn():
        calls.append(1)
        return sum(range(20_000))

    t = profiling.timed_amortized(fn, reps=4, probes=2)
    assert 0 < t < 1
    assert len(calls) == 1 + 2 * 1 + 1 * 5  # warm, probes of one, one batch of reps + 1
