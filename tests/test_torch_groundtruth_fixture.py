"""The port's side of tests/test_groundtruth_fixture.py: with the Rust
crate's ground truth at tests/groundtruth.json (made by
tools/gen_groundtruth.rs on a machine with the network; nothing here
downloads it), every case through the port's oracle and its CPU path
(`Builder.run(device="cpu")`). Without the fixture the test skips, as the
JAX package's does; SMTPU_REQUIRE_GROUNDTRUTH=1 turns the absence into a
failure. Integer outputs: tolerance 0.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import simd_minimizers_tpu_torch as smt

FIXTURE = os.path.join(os.path.dirname(__file__), "groundtruth.json")
HASHERS = {"nt": smt.NtHasher, "mul": smt.MulHasher, "antilex": smt.AntiLexHasher}


def test_groundtruth_required_flag():
    if not os.environ.get("SMTPU_REQUIRE_GROUNDTRUTH"):
        pytest.skip("SMTPU_REQUIRE_GROUNDTRUTH not set")
    assert os.path.exists(FIXTURE), (
        "SMTPU_REQUIRE_GROUNDTRUTH=1 but tests/groundtruth.json is absent: generate it with "
        "tools/gen_groundtruth.rs against the real simd-minimizers crate")


def test_groundtruth_fixture():
    if not os.path.exists(FIXTURE):
        pytest.skip("no ground-truth fixture (tools/gen_groundtruth.rs makes one where the "
                    "network is reachable)")
    with open(FIXTURE) as f:
        cases = json.load(f)["cases"]
    assert cases, "empty fixture"
    for i, case in enumerate(cases):
        k, w = case["k"], case["w"]
        h = HASHERS[case["hasher"]](k, canonical=case["canonical"], seed=case.get("seed"))
        b = (smt.canonical_minimizers if case["canonical"] else smt.minimizers)(k, w).hasher(h)
        seq = smt.AsciiSeq(case["seq"].encode())
        want = np.asarray(case["positions"], np.uint32)
        np.testing.assert_array_equal(b.run_scalar_once(seq), want, err_msg=f"case {i} (oracle)")
        np.testing.assert_array_equal(b.run_once(seq, device="cpu"), want,
                                      err_msg=f"case {i} (CPU path)")
