"""Tests of the SSHash cell's and the command line cell's parts: the
super-k-mer reference against the program on the CPU, the controls, the
command line cell's answer with its values, values altered to the forward
strand's and half of the answers left out in both cells' entries, and the
FASTA that `inputs/fasta.py` writes read back by the program's reader.

    python -m pytest benchmark/tests/test_superkmers.py -q
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
import gen  # noqa: E402
import plugins  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
SEED = 2**31 + 4099  # past 32 signed bits, as the checker's seeds are
SSHASH, CLI = "sshash.genome-resident", "k21w11.fasta-cli"
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


def cpu_run(cell: str) -> dict:
    return run.run_cell(cell, SEED, 0.3, False, bench=BENCH, t_start=time.perf_counter())


@pytest.mark.parametrize("k,w,canonical", [(21, 11, True), (31, 5, True), (16, 9, False)])
def test_reference_agrees_with_the_program_on_the_cpu(k, w, canonical):
    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch import convert
    from simd_minimizers_tpu_torch.ops import backend
    from simd_minimizers_tpu_torch.seq.packed import PackedSeqVec

    ref = reference.make({"mode": "superkmers", "hasher": "nt", "values": "u64", "k": k, "w": w,
                          "canonical": canonical})
    rng = np.random.default_rng(k * w)
    for n in (30_000, 4_097, 31, 3):
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
        pos, idx, vals = backend.sketch(chars, n, k, w, smt.NtHasher(k, canonical=canonical),
                                        "superkmers", values=True)
        halves = plugins.load("entries", "sketch_values").halves(vals)
        want = ref.sequence(torch.from_numpy(codes), block_windows=1_001)
        assert reference.same((pos, idx, *halves), want)
    with pytest.raises(ValueError, match="no ambiguity mask"):
        ref.sequence(torch.zeros(100, dtype=torch.uint8), torch.zeros(100, dtype=torch.bool))


def test_least_work_adds_the_index_and_the_value():
    config = run.cell_spec(SSHASH, BENCH)[1]
    skm, mins = reference.make(config), plugins.load("references", "minimizers").make(config)
    ops, nbytes = mins.least_work(60, 64, 10, packed=True, masked=False)
    assert skm.least_work(60, 64, 10, packed=True, masked=False) == (ops, nbytes + 12 * 10)


@pytest.mark.parametrize("cell", [SSHASH, CLI], ids=["sshash", "fasta-cli"])
def test_control_is_not_correct(cell):
    res = control.control_reading(cell, SEED, BENCH)
    assert res["differing_parts"] >= 1 and res["parts"] >= 1


def test_fasta_cli_answer_holds_the_values():
    """The command line cell's reference answer: the minimizers' positions,
    and at each the canonical u64 value of the k-mer as two 32-bit planes."""
    _, config, traffic = run.cell_spec(CLI, BENCH)
    ref = reference.make(config)
    inputs = gen.make(traffic, SEED, "cpu")
    try:
        (r, (pos, lo, hi)), = gen.expected(inputs, [1], ref, "cpu")
        assert torch.equal(pos, ref.sequence(torch.from_numpy(inputs.parts[r]),
                                             torch.from_numpy(inputs.masks[r])))
        k, codes = config["k"], inputs.parts[r].tolist()
        want = [min(sum(c << 2 * j for j, c in enumerate(codes[p:p + k])),
                    sum((c ^ 2) << 2 * (k - 1 - j) for j, c in enumerate(codes[p:p + k])))
                for p in pos[:200].tolist()]
        assert pos.numel() > 200 and (lo | hi << 32)[:200].tolist() == want
    finally:
        inputs.remove()


def _forward_kernel(monkeypatch):
    """The values kernel (its plain version here) made to give the forward
    strand's value."""
    from simd_minimizers_tpu_torch.ops import device_values

    orig = device_values.kmer_values_limbs
    monkeypatch.setattr(device_values, "kmer_values_limbs",
                        lambda chars, pos, k, canonical=False, byte_codes=False:
                        orig(chars, pos, k, False, byte_codes))


def _forward_record_values(monkeypatch):
    """The command line's values of a record made the forward strand's."""
    from simd_minimizers_tpu_torch import sketch_fasta

    orig = sketch_fasta.record_values
    monkeypatch.setattr(sketch_fasta, "record_values",
                        lambda codes, pos, k, canonical, device: orig(codes, pos, k, False, device))


@pytest.mark.parametrize("cell,fault", [(SSHASH, _forward_kernel),
                                        (CLI, _forward_record_values)],
                         ids=["sshash", "fasta-cli"])
def test_forward_values_are_not_correct(cell, fault, monkeypatch):
    """Each value altered to the forward strand's where the configuration
    states canonical values: the positions stay right, the values not."""
    fault(monkeypatch)
    res = cpu_run(cell)
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_sound_runs_are_correct():
    for cell in (SSHASH, CLI):
        res = cpu_run(cell)
        assert res["correct"] is True and res["checks"]["checked_parts"]["value"] >= 2, cell


def _half_sketch(monkeypatch):
    """Every other record's answer left out of the SSHash entry's calls."""
    from simd_minimizers_tpu_torch.ops import backend

    orig, seen = backend.sketch, []

    def sketch(*a, **kw):
        seen.append(1)
        out = orig(*a, **kw)
        return out if len(seen) % 2 else tuple(p[:0] for p in out)

    monkeypatch.setattr(backend, "sketch", sketch)


def _half_records(monkeypatch):
    """Every other record of the command line's sketch left empty."""
    from simd_minimizers_tpu_torch.ops import backend

    orig = backend.sketch_records
    monkeypatch.setattr(backend, "sketch_records", lambda *a, **kw: [
        o if i % 2 else o[:0] for i, o in enumerate(orig(*a, **kw))])


@pytest.mark.parametrize("cell,fault", [(SSHASH, _half_sketch), (CLI, _half_records)],
                         ids=["sshash", "fasta-cli"])
def test_half_left_out_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(cell)
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_fasta_reads_back_to_the_codes_and_masks():
    from simd_minimizers_tpu_torch.seq.fasta import read_fasta

    inputs = gen.make(small_traffic("fasta-cli"), SEED, "cpu")
    try:
        recs = read_fasta(inputs.path)
        assert [r.name for r in recs] == inputs.names == ["chr21", "chr22"]
        for rec, codes, mask in zip(recs, inputs.parts, inputs.masks, strict=True):
            np.testing.assert_array_equal(rec.codes, codes)
            np.testing.assert_array_equal(rec.ambiguous.astype(bool), mask)
            assert mask.any()
        with open(inputs.path, "rb") as f:
            lines = f.read().split(b"\n")
        assert {len(x) for x in lines if not x.startswith(b">")} <= {0, *range(1, 61)}
        assert max(len(x) for x in lines) == 60
    finally:
        inputs.remove()
    assert not Path(inputs.path).exists()
