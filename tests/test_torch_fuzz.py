"""The port's randomized differential fuzz (`simd_minimizers_tpu_torch/tools/fuzz.py`)
on the CPU, where the kernels' plain versions run: fixed seeds pass and
cover every entry, mode, hasher and input kind; a planted mismatch (a
monkeypatched oracle, or wrong values) exits nonzero and prints the config
line; an exception is not swallowed; `--index` re-runs one config. The
fuzz's reference (the port's oracle over the port's hashers) is held against
the JAX package's oracle over the JAX package's hashers on every config of
two seeds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from simd_minimizers_tpu import hashers as jhashers
from simd_minimizers_tpu.ops import oracle as joracle
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline
from simd_minimizers_tpu_torch.tools import fuzz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_on_cpu(seed):
    """A few dozen configs of a fixed seed, every one equal to the oracle,
    covering every entry, mode, hasher and input kind, both routes and
    every mask kind."""
    s = fuzz.run(seed=seed, configs=35, device="cpu")
    assert s["configs"] == 35 and s["mismatches"] == 0 and s["device"] == "cpu"
    assert set(s["by_entry"]) == set(fuzz.ENTRIES)
    assert all(c == 5 for c in s["by_entry"].values())
    assert s["by_route"]["large-w"] >= 35 // fuzz.LARGE_W_EVERY
    assert {h.split(",")[0] for h in s["by_hasher"]} == set(fuzz.HASHERS)
    assert set(s["by_mode"]) == set(pipeline.MODES) and set(s["by_kind"]) == set(fuzz.KINDS)
    assert set(s["by_mask"]) == set(fuzz.MASKS)


JAX_HASHERS = {"nt": jhashers.NtHasher, "mul": jhashers.MulHasher,
               "antilex": jhashers.AntiLexHasher}


def _jax_expected(cfg, pieces):
    """The JAX package's oracle planes of each piece, over its own hasher."""
    h = JAX_HASHERS[cfg.hasher](cfg.k, canonical=cfg.canonical, seed=cfg.hasher_seed)
    out = []
    for chars, amb in pieces:
        sel = joracle.selected_stream(chars, cfg.k, cfg.w, h, ambiguous=amb)
        if cfg.mode == pipeline.MODE_SUPERKMERS:
            out.append(joracle.collect_and_dedup_with_index(sel))
        elif cfg.mode in pipeline.SYNCMER_MODES:
            out.append((joracle.collect_syncmers(sel, cfg.w,
                                                 cfg.mode == pipeline.MODE_OPEN_SYNCMERS),))
        else:
            out.append((joracle.collect_and_dedup(sel, skip_sentinel=amb is not None),))
    return h, out


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_reference_is_the_jax_oracle(seed):
    """Every config of a seed (both routes, every mode, hasher, input kind
    and mask): `fuzz.expected` equals the JAX package's oracle bit for bit,
    and the fuzz's hasher is the JAX hasher as `convert.hasher_from` takes
    it over."""
    for i in range(35):
        cfg = fuzz.draw(seed, i)
        pieces = fuzz.make_inputs(cfg)
        h, want = _jax_expected(cfg, pieces)
        mine, theirs = fuzz.hasher_of(cfg), convert.hasher_from(h)
        assert (type(mine), mine.k, mine.canonical, mine.seed) == (
            type(theirs), theirs.k, theirs.canonical, theirs.seed), cfg.line()
        got = fuzz.expected(cfg, pieces)
        assert len(got) == len(want) == len(pieces), cfg.line()
        for g, p in zip(got, want):
            assert len(g) == len(p), cfg.line()
            for a, b in zip(g, p):
                assert a.dtype == b.dtype == np.uint32, cfg.line()
                np.testing.assert_array_equal(a, b, err_msg=cfg.line())


def test_fuzz_covers_the_config_space():
    """Over 210 draws: every mode, hasher (default and seeded), input kind,
    mask kind and alphabet; tile edges; canonical only at odd l; antilex at
    k <= 32; the large-w configs inside TILE + w <= 2^16."""
    cfgs = [fuzz.draw(5, i) for i in range(210)]
    assert {c.mode for c in cfgs} == set(pipeline.MODES)
    assert {(c.hasher, c.hasher_seed is None) for c in cfgs} == {
        ("nt", True), ("nt", False), ("mul", True), ("mul", False), ("antilex", True)}
    assert {c.kind for c in cfgs} == set(fuzz.KINDS)
    assert {c.mask for c in cfgs} == set(fuzz.MASKS)
    assert {c.alphabet for c in cfgs} == {1, 2, 4}
    assert {c.shards for c in cfgs if c.entry in ("shard", "multihost")} <= set(range(1, 10))
    assert len({c.shards for c in cfgs}) >= 6
    assert all(c.l % 2 == 1 for c in cfgs if c.canonical)
    assert all(c.k <= 32 for c in cfgs if c.hasher == "antilex")
    assert all(c.mask == "none" for c in cfgs if c.mode == pipeline.MODE_SUPERKMERS)
    large = [c for c in cfgs if c.route() == "large-w"]
    assert len(large) == 210 // fuzz.LARGE_W_EVERY
    assert all(fused.LARGE_W_MIN <= c.w and fused.TILE + c.w <= 1 << 16 for c in large)
    edges = [c for c in cfgs if (c.lengths[0] - c.l + 1) % fused.TILE in (fused.TILE - 1, 0, 1)]
    assert len(edges) >= 10
    assert all(c.lengths[0] <= 8 * 1024 + c.l - 1 for c in cfgs if c.entry == "short")
    assert fuzz.draw(5, 17) == cfgs[17]  # a config depends on (seed, index) alone


def test_fuzz_hands_run_batch_matrices():
    """Every other run_batch config of packed, 2-bit or text kind hands a
    (B, L) ASCII matrix of equal-length rows, never of ACGT text (a matrix
    folds that to codes), and a text matrix has no all-ACGTacgt row; each
    runs equal to the oracle on the CPU."""
    cfgs = [fuzz.draw(5, i) for i in range(210)]
    batch = [c for c in cfgs if c.entry == "run_batch"]
    matrices = [c for c in batch if c.matrix]
    assert not any(c.matrix for c in cfgs if c.entry != "run_batch")
    assert {c.kind for c in matrices} == {"packed", "codes", "text"}
    assert all(len(set(c.lengths)) == 1 for c in matrices)
    assert any(c.mask != "none" for c in matrices)
    assert any(c.kind != "acgt_text" and not c.matrix for c in batch)
    for c in matrices:
        if c.kind == "text":
            for chars, _ in fuzz.make_inputs(c):
                assert not np.isin(chars, np.frombuffer(b"ACGTacgt", np.uint8)).any()
    for c in matrices[:4]:
        assert fuzz.run(seed=5, index=c.index, device="cpu")["configs"] == 1


def test_index_reruns_one_config():
    s = fuzz.run(seed=3, index=11, device="cpu")
    assert s["configs"] == 1 and s["slowest"]["config"] == fuzz.draw(3, 11).line()


def test_planted_mismatch_exits_nonzero(monkeypatch, capsys):
    """An oracle that moves one position: exit 1 and one line with the
    whole config, enough to re-run it."""
    real = fuzz.oracle.collect_and_dedup

    def shifted(sel, skip_sentinel=False):
        out = real(sel, skip_sentinel).copy()
        out[:1] += 1
        return out

    monkeypatch.setattr(fuzz.oracle, "collect_and_dedup", shifted)
    assert fuzz.main(["--device", "cpu", "--configs", "12", "--seed", "4"]) == 1
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("FUZZ")]
    assert len(lines) == 1 and lines[0].startswith("FUZZ MISMATCH seed=4 index=")
    for key in ("k=", "w=", "n=", "mode=", "hasher=", "kind=", "mask=", "entry=", "shards="):
        assert f" {key}" in lines[0]
    index = int(lines[0].split("index=")[1].split()[0])
    assert fuzz.draw(4, index).line() in lines[0]


def test_wrong_values_are_a_mismatch(monkeypatch, capsys):
    """Output.values_* against NumPy's values: a planted error is caught."""
    real = fuzz.values.kmer_values_u128_limbs
    monkeypatch.setattr(fuzz.values, "kmer_values_u128_limbs",
                        lambda *a: tuple(x ^ np.uint64(1) for x in real(*a)))
    monkeypatch.setattr(fuzz.values, "canonical_kmer_values_u128_limbs",
                        fuzz.values.kmer_values_u128_limbs)
    idx = next(i for i in range(100) if fuzz.draw(0, i).values)
    assert fuzz.main(["--device", "cpu", "--index", str(idx)]) == 1
    assert "values differ" in capsys.readouterr().out


def test_exception_is_not_swallowed(monkeypatch, capsys):
    """An entry that raises: the config line, then the exception itself."""
    def broken(*_):
        raise ZeroDivisionError("planted")

    monkeypatch.setattr(fuzz, "run_entry", broken)
    with pytest.raises(fuzz.FuzzFailure) as info:
        fuzz.main(["--device", "cpu", "--configs", "3"])
    assert isinstance(info.value.__cause__, ZeroDivisionError)
    assert capsys.readouterr().out.startswith("FUZZ ERROR seed=0 index=0 ")


def test_cli_prints_the_summary():
    """`python -m simd_minimizers_tpu_torch.tools.fuzz --device cpu`: the
    counts and one JSON line last."""
    res = subprocess.run([sys.executable, "-m", "simd_minimizers_tpu_torch.tools.fuzz",
                          "--device", "cpu", "--configs", "8", "--seed", "9"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["configs"] == 8 and last["mismatches"] == 0
    assert "configs/s" in res.stdout and "slowest" in res.stdout
