"""The port's examples (`simd_minimizers_tpu_torch/examples`) at a tiny size
on the CPU: `bench` (min of samples of Builder.run), `variance` (density
and count variance through the oracle, and through Builder.run held equal
to it) and `multihost_demo` (two processes over gloo, each checked against
the oracle). Counts and positions: tolerance 0; the density of random
input within 0.02 of 2/(w+1).
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.seq.packed import PackedSeqVec
from simd_minimizers_tpu_torch.examples import bench, variance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("canonical", [False, True])
def test_bench_on_cpu(canonical, capsys):
    """The count equals the JAX package's oracle on the same seeded input."""
    argv = ["--n", "20000", "--samples", "2", "--device", "cpu"]
    res = bench.main(argv + (["--canonical"] if canonical else []))
    import numpy as np

    seq = PackedSeqVec.random(20000, np.random.default_rng(0))
    sel = oracle.selected_stream(seq.codes(), 21, 11, NtHasher(21, canonical=canonical))
    assert res["count"] == oracle.collect_and_dedup(sel).size
    assert res["device"] == "cpu" and res["best_s"] > 0 and res["ns_per_bp"] > 0
    assert "ns/bp incl. host" in capsys.readouterr().out


@pytest.mark.parametrize("device", [None, "cpu"])
def test_variance(device):
    argv = ["--len", "3000", "--reps", "8", "--k", "15", "--w", "9"]
    res = variance.main(argv + (["--device", device] if device else []))
    assert abs(res["density"] - 2 / 10) < 0.02 and res["count_var"] >= 0
    assert res["via"] == ("oracle" if device is None else "Builder.run on cpu (= oracle)")


def test_multihost_demo_gloo():
    """Two processes over gloo, each rank bit-equal to the oracle in three
    modes, the demo's exit 0."""
    res = subprocess.run([sys.executable, "-m", "simd_minimizers_tpu_torch.examples.multihost_demo",
                          "30000", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=400)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    for r in (0, 1):
        assert f"[rank {r}] super-k-mers and skip-ambiguous bit-exact" in lines
        assert any(x.startswith(f"[rank {r}] ") and x.endswith("on cpu, bit-exact") for x in lines)
    assert "both processes produced the bit-exact global list on cpu" in res.stdout


def test_bench_refuses_a_missing_card(monkeypatch):
    """--device cuda without a card raises; it does not fall back to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--n", "100", "--device", "cuda"])
