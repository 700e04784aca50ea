"""Tests of the strobealign cell's parts: the open-syncmer reference against
the program on the CPU and against the port's oracle, its least work, its
refusals, the control, a forward-strand value kernel, the s-mers' values and
half of the answers left out coming out not correct, a sound run coming out
correct, and the cell's counter metrics in a traced CPU run.

    python -m pytest benchmark/tests/test_syncmer_values.py -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import control  # noqa: E402
import plugins  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
SEED = 2**31 + 2525  # past 32 signed bits, as the checker's seeds are
CELL = "strobealign.genome-resident"
_FILE_TRAFFIC = run.load_traffic


def small_traffic(name: str) -> dict:
    """The traffic's inputs shrunk by its generator's `small`, its sample
    drawn from the first two calls."""
    spec = _FILE_TRAFFIC(name)
    return {**spec, **plugins.load("inputs", spec["inputs"]).small(spec),
            "sample": {**spec["sample"], "calls": 2}}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run, "load_traffic", small_traffic)


def cpu_run(trace: bool = False) -> dict:
    return run.run_cell(CELL, SEED, 0.3, trace, bench=BENCH, t_start=time.perf_counter())


def syncmers_ref(k, w, canonical, control=False):
    return reference.make({"mode": "open_syncmers", "hasher": "nt", "values": "u64", "k": k,
                           "w": w, "canonical": canonical}, control)


@pytest.mark.parametrize("k,w,canonical", [(17, 7, True), (21, 11, True), (16, 5, False)])
def test_reference_agrees_with_the_program_and_the_oracle(k, w, canonical):
    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import backend, oracle, values
    from simd_minimizers_tpu_torch.seq.packed import PackedSeqVec

    ref, l = syncmers_ref(k, w, canonical), k + w - 1
    h = smt.NtHasher(k, canonical=canonical)
    rng = np.random.default_rng(k * w)
    for n in (30_000, 4_097, l, 3):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        want = ref.sequence(torch.from_numpy(codes), block_windows=1_001)
        chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
        idx, vals = backend.sketch(chars, n, k, w, h, "open_syncmers", values=True)
        halves = plugins.load("entries", "sketch_values").halves(vals)
        assert reference.same((idx, *halves), want)
        # the port's NumPy oracle and values, which share nothing with either
        pos = oracle.collect_syncmers(oracle.selected_stream(codes, k, w, h), w, True)
        fn = values.canonical_kmer_values_u64 if canonical else values.kmer_values_u64
        np.testing.assert_array_equal(pos, want[0].numpy())
        np.testing.assert_array_equal(fn(codes, pos, l, 2),
                                      (want[1] | want[2] << 32).numpy().view(np.uint64))


def test_least_work_adds_the_value():
    config = run.cell_spec(CELL, BENCH)[1]
    syn, mins = reference.make(config), plugins.load("references", "minimizers").make(config)
    ops, nbytes = mins.least_work(60, 64, 10, packed=True, masked=False)
    assert syn.least_work(60, 64, 10, packed=True, masked=False) == (ops, nbytes + 8 * 10)


@pytest.mark.parametrize("change,match", [({"w": 6}, "odd w"), ({"w": 17}, "at most 32"),
                                          ({"values": None}, "u64 values")])
def test_reference_refuses_what_it_cannot_answer(change, match):
    config = {"mode": "open_syncmers", "hasher": "nt", "values": "u64", "k": 17, "w": 7,
              "canonical": True, **change}
    with pytest.raises(ValueError, match=match):
        reference.make(config)
    ref = syncmers_ref(17, 7, True)
    with pytest.raises(ValueError, match="no ambiguity mask"):
        ref.sequence(torch.zeros(100, dtype=torch.uint8), torch.zeros(100, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        ref.rows(torch.zeros((2, 100), dtype=torch.uint8))


def test_control_is_not_correct():
    res = control.control_reading(CELL, SEED, BENCH)
    assert res["differing_parts"] >= 1 and res["parts"] >= 1


def test_sound_run_is_correct():
    res = cpu_run()
    assert res["correct"] is True and res["checks"]["checked_parts"]["value"] >= 2


def test_forward_values_are_not_correct(monkeypatch):
    """Each value altered to the forward strand's: the window indices stay
    right, the values not."""
    from simd_minimizers_tpu_torch.ops import device_values

    orig = device_values.kmer_values_limbs
    monkeypatch.setattr(device_values, "kmer_values_limbs",
                        lambda chars, pos, k, canonical=False, byte_codes=False:
                        orig(chars, pos, k, False, byte_codes))
    res = cpu_run()
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_values_of_the_s_mers_are_not_correct(monkeypatch):
    """Values of the s-mer (k chars) at each window index in place of the
    syncmer's l chars."""
    from simd_minimizers_tpu_torch.ops import spans

    orig = spans.with_values
    monkeypatch.setattr(spans, "with_values", lambda res, chars, length, *a, **kw:
                        orig(res, chars, 17, *a, **kw))
    res = cpu_run()
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_half_left_out_is_not_correct(monkeypatch):
    """Every other record's answer left out of the entry's calls."""
    from simd_minimizers_tpu_torch.ops import backend

    orig, seen = backend.sketch, []

    def sketch(*a, **kw):
        seen.append(1)
        out = orig(*a, **kw)
        return out if len(seen) % 2 else tuple(p[:0] for p in out)

    monkeypatch.setattr(backend, "sketch", sketch)
    res = cpu_run()
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_traced_run_reads_the_counters():
    """On the CPU the cell's host waits read (`sshash.syncs_per_gbp`, the
    resident cells' `resident.syncs_per_gbp`); its launches, which the CPU
    makes none of, are read in the cell on a card."""
    from simd_minimizers_tpu_torch.utils import profiling

    for c in profiling.PROFILED.values():
        c.clear()
    res = cpu_run(trace=True)
    m = res["metrics"]
    assert res["correct"] is True
    assert m["sshash.syncs_per_gbp"]["value"] > 0
    for name in ("sshash.syncs_per_gbp", "resident.launches_per_gbp"):
        assert CELL in next(x for x in BENCH["per_layer"] if x["name"] == name)["workloads"]
