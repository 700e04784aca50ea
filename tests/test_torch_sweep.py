"""The port's side of tests/test_sweep.py: the (k, w, length, offset) grid of
the reference's `test_on_inputs` (the crate's src/test.rs:24-51) through the
port's CPU path (`Builder.run(device="cpu")`: the kernels' plain versions),
against the JAX package's oracle and a naive per-window minimizer over the
JAX package's hashers.

The same KWS, LENS and 8192-base BASE as tests/test_sweep.py, drawn from
the same seed in the same order. Parametrised by k (and by length for the
length sweep, by hasher for the hasher sweep), so each case counts.
Integer outputs: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import oracle as joracle
from simd_minimizers_tpu.utils.bits import VAL_MASK
import simd_minimizers_tpu_torch as smt

RNG = np.random.default_rng(0x5EED5)
BASE = RNG.integers(0, 4, 8192, dtype=np.uint8)

KWS = sorted({1, 2, 3, 4, 5, 31, 32, 33, 63, 64, 65}
             | set(int(x) for x in RNG.integers(6, 100, 6)))
LENS = list(range(0, 40)) + [63, 64, 65, 100, 255, 1024] + [
    int(x) for x in RNG.integers(100, 8192, 6)
]

PORT_HASHERS = {NtHasher: smt.NtHasher, MulHasher: smt.MulHasher,
                AntiLexHasher: smt.AntiLexHasher}


def naive_positions(codes, k, w, hasher):
    """Per-window argmin of the top-16 hash, then dedup (independent of any
    sliding-window code)."""
    n = len(codes)
    l = k + w - 1
    if n < l:
        return np.zeros(0, np.uint32)
    hashes = hasher.hash_kmers_np(codes) & VAL_MASK
    out = []
    for i in range(n - l + 1):
        p = i + int(hashes[i:i + w].argmin())
        if not out or out[-1] != p:
            out.append(p)
    return np.asarray(out, np.uint32)


def _slice(off: int, n: int) -> smt.PackedSeq:
    """Bases BASE[off:off + n] as a PackedSeq slice at base offset `off`
    (an unaligned view of the packed bytes for off % 4 != 0)."""
    return smt.PackedSeqVec.from_codes(BASE[:off + n]).slice(off, off + n)


@pytest.mark.parametrize("k", KWS)
def test_fwd_sweep_over_w_and_len(k):
    rng = np.random.default_rng(k)
    for w in sorted({1, 2, 11, int(rng.integers(3, 40))}):
        b = smt.minimizers(k, w)
        for n in [0, 1, k + w - 2, k + w - 1, k + w, 3 * (k + w), 500]:
            n = max(n, 0)
            off = int(rng.integers(0, 4))
            codes = BASE[off:off + n]
            got = b.run(_slice(off, n), device="cpu").positions
            want = naive_positions(codes, k, w, NtHasher(k))
            np.testing.assert_array_equal(got, want, err_msg=f"k={k} w={w} n={n} off={off}")
            np.testing.assert_array_equal(
                got, joracle.collect_and_dedup(joracle.selected_stream(codes, k, w, NtHasher(k))))


@pytest.mark.parametrize("n", LENS)
def test_len_sweep(n):
    """Every length of LENS at offsets 0..3, packed and as ASCII, forward
    and canonical, against the JAX package's oracle."""
    for k, w in [(1, 1), (5, 7), (21, 11), (31, 2)]:
        for canonical in (False, True):
            if canonical and (k + w - 1) % 2 == 0:
                continue
            b = (smt.canonical_minimizers if canonical else smt.minimizers)(k, w)
            h = NtHasher(k, canonical=canonical)
            for off in range(4):
                codes = BASE[off:off + n]
                want = joracle.collect_and_dedup(joracle.selected_stream(codes, k, w, h))
                got = b.run(_slice(off, n), device="cpu").positions
                np.testing.assert_array_equal(got, want, err_msg=f"k={k} w={w} off={off}")
            ascii_seq = smt.AsciiSeq(np.frombuffer(b"ACTG", np.uint8)[BASE[:n]])
            np.testing.assert_array_equal(
                b.run(ascii_seq, device="cpu").positions,
                joracle.collect_and_dedup(joracle.selected_stream(BASE[:n], k, w, h)))


@pytest.mark.parametrize("hasher_cls", [NtHasher, MulHasher, AntiLexHasher])
def test_fwd_sweep_hashers(hasher_cls):
    for k, w in [(1, 1), (5, 7), (21, 11), (63, 4), (65, 2)]:
        h = hasher_cls(k)
        b = smt.minimizers(k, w).hasher(PORT_HASHERS[hasher_cls](k))
        for n in [k + w - 1, 300, 2048]:
            codes = BASE[:n]
            got = b.run(_slice(0, n), device="cpu").positions
            np.testing.assert_array_equal(got, naive_positions(codes, k, w, h),
                                          err_msg=f"k={k} w={w} n={n}")


@pytest.mark.parametrize("k, w", [(5, 7), (21, 11), (31, 5), (63, 3), (2, 2)])
def test_canonical_rc_sweep(k, w):
    """Canonical positions x of the forward strand and y of the reverse
    complement pair up as x + y = n - k, and each equals the JAX oracle."""
    h = NtHasher(k, canonical=True)
    b = smt.canonical_minimizers(k, w)
    for n in [k + w - 1, 257, 2048]:
        codes = BASE[:n]
        rc = (codes ^ 2)[::-1].astype(np.uint8)
        fwd = b.run(smt.PackedSeqVec.from_codes(codes), device="cpu").positions
        bwd = b.run(smt.PackedSeqVec.from_codes(codes).to_revcomp(), device="cpu").positions
        np.testing.assert_array_equal(
            fwd, joracle.collect_and_dedup(joracle.selected_stream(codes, k, w, h)))
        np.testing.assert_array_equal(
            bwd, joracle.collect_and_dedup(joracle.selected_stream(rc, k, w, h)))
        np.testing.assert_array_equal(
            np.sort(fwd), np.sort(n - k - bwd.astype(np.int64)).astype(np.uint32),
            err_msg=f"k={k} w={w} n={n}")
