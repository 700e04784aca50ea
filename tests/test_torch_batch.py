"""Batched reads: the port's `ops/batch.sketch_batch` on the CPU (the
kernels' plain versions, and the plain pipeline route) == the JAX package's
`sketch_batch(backend="fused", interpret=True)` (C=1024) on the cases of
tests/test_batch.py == the per-read NumPy oracle; and `Builder.run_batch`
against the JAX builder's.

Integer outputs: tolerance 0. The kernels run the same launches on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest

import simd_minimizers_tpu as sm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import MulHasher, NtHasher
from simd_minimizers_tpu.ops import batch as jbatch
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import batch, fused, pipeline

C = 1024
SKM = pipeline.MODE_SUPERKMERS


def _reads(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]


def _both(reads, k, w, jh, mode=pipeline.MODE_MINIMIZERS, ambiguous=None, **kw):
    """(port on the CPU through the fused route, the JAX fused kernel in
    interpret mode); the port's pipeline route must give the same."""
    h = convert.hasher_from(jh)
    before = dict(fused.LAUNCHES)
    got = batch.sketch_batch(reads, k, w, h, mode, ambiguous, device="cpu", **kw)
    assert fused.LAUNCHES == before
    plain = batch.sketch_batch(reads, k, w, h, mode, ambiguous, device="cpu",
                               backend="pipeline", **kw)
    want = jbatch.sketch_batch(reads, k, w, jh, mode=mode, ambiguous=ambiguous, C=C,
                               backend="fused", interpret=True)
    for g, p, r in zip(got, plain, want, strict=True):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(p, r)
    return got


def _oracle(rd, k, w, h, mode=pipeline.MODE_MINIMIZERS, amb=None):
    if len(rd) < k + w - 1:
        return (np.zeros(0, np.uint32),) * (2 if mode == SKM else 1)
    sel = oracle.selected_stream(rd, k, w, h, ambiguous=amb)
    if mode == SKM:
        if amb is None:
            return oracle.collect_and_dedup_with_index(sel)
        keep = np.ones(sel.size, bool)
        keep[1:] = sel[1:] != sel[:-1]
        keep &= sel != np.uint32(0xFFFF_FFFE)
        return sel[keep], np.flatnonzero(keep).astype(np.uint32)
    if mode in pipeline.SYNCMER_MODES:
        return (oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS),)
    return (oracle.collect_and_dedup(sel, skip_sentinel=amb is not None),)


def _check_oracle(got, reads, k, w, h, mode=pipeline.MODE_MINIMIZERS, ambs=None):
    rid, *planes = got
    assert np.all(np.diff(rid.astype(np.int64)) >= 0)  # ordered by read
    for i, rd in enumerate(reads):
        want = _oracle(rd, k, w, h, mode, None if ambs is None else ambs[i])
        for p, wnt in zip(planes, want, strict=True):
            np.testing.assert_array_equal(p[rid == i], wnt, err_msg=f"read {i}")


def test_stride_bucket():
    """The port's copy against the JAX package's over 0..2^20."""
    xs = np.arange(0, 1 << 20)
    got = np.fromiter((batch._stride_bucket(int(x)) for x in xs), np.int64, xs.size)
    want = np.fromiter((jbatch._stride_bucket(int(x)) for x in xs), np.int64, xs.size)
    np.testing.assert_array_equal(got, want)
    assert batch._stride_bucket(151) == 160 and batch._stride_bucket(1025) == 1152


@pytest.mark.parametrize("canonical", [False, True])
def test_batch_minimizers(canonical):
    k, w = 21, 11
    reads = _reads([500, 31, 30, 0, 1024, 77, 300, 1024, 999, 64, 150], 1)
    h = NtHasher(k, canonical=canonical)
    _check_oracle(_both(reads, k, w, h), reads, k, w, h)


def test_batch_superkmers():
    k, w = 5, 7
    reads = _reads([200, 64, 1000], 2)
    h = NtHasher(k, canonical=True)
    _check_oracle(_both(reads, k, w, h, SKM), reads, k, w, h, SKM)


@pytest.mark.parametrize("mode", pipeline.SYNCMER_MODES)
def test_batch_syncmers(mode):
    k, w = 11, 7
    reads = _reads([300, 500], 3)
    h = NtHasher(k)
    _check_oracle(_both(reads, k, w, h, mode), reads, k, w, h, mode)


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, pipeline.MODE_CLOSED_SYNCMERS])
def test_batch_skip_ambiguous(mode):
    """A mask per read, in every mode: super-k-mers with a mask run below
    the builder (the padding plane is a mask already)."""
    k, w = 5, 7
    lens = [400, 700, 20, 900]
    reads = _reads(lens, 4)
    rng = np.random.default_rng(44)
    amb = [(rng.random(n) < 0.02).astype(np.uint8) for n in lens]
    h = NtHasher(k, canonical=True)
    _check_oracle(_both(reads, k, w, h, mode, amb), reads, k, w, h, mode, amb)


def test_batch_split_over_launch_cap(monkeypatch):
    """Batches above the per-launch char cap split and merge seamlessly."""
    monkeypatch.setattr(batch, "MAX_LAUNCH_CHARS", 4 * 72)  # 4 slots of stride 72
    monkeypatch.setattr(jbatch, "MAX_LAUNCH_CHARS", 4 * 72)
    k, w = 5, 7
    reads = np.random.default_rng(5).integers(0, 4, (11, 64), dtype=np.uint8)
    h = NtHasher(k, canonical=True)
    _check_oracle(_both(reads, k, w, h), list(reads), k, w, h)


@pytest.mark.parametrize("canonical", [False, True])
def test_batch_dense_short_reads(canonical):
    """Mixed lengths over several stride buckets up to one 10 kbp read."""
    k, w = 21, 11
    lens = [150, 0, 200, 31, 100, 250, 37, 250, 199, 64, 250, 180, 90, 10_000]
    reads = _reads(lens, 6)
    h = NtHasher(k, canonical=canonical)
    _check_oracle(_both(reads, k, w, h), reads, k, w, h)


def test_batch_dense_superkmers_and_ambiguous():
    k, w = 5, 7
    lens = [100, 120, 50, 128, 90]
    reads = _reads(lens, 7)
    h = NtHasher(k, canonical=True)
    _check_oracle(_both(reads, k, w, h, SKM), reads, k, w, h, SKM)
    rng = np.random.default_rng(77)
    amb = [(rng.random(n) < 0.05).astype(np.uint8) for n in lens]
    _check_oracle(_both(reads, k, w, h, ambiguous=amb), reads, k, w, h, ambs=amb)


def test_batch_text_reads():
    """General text reads go through the kernel's byte input (the JAX
    package takes its pipeline route for them)."""
    k, w = 7, 5
    rng = np.random.default_rng(8)
    texts = [rng.integers(32, 127, n, dtype=np.uint8) for n in [100, 300, 50]]
    h = MulHasher(k)
    got = batch.sketch_batch(texts, k, w, convert.hasher_from(h), device="cpu")
    want = jbatch.sketch_batch(texts, k, w, h)
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    _check_oracle(got, texts, k, w, h)


def test_padding_plane():
    """The batch's plane: padding flagged, the reads' own flags or'ed in,
    whole bytes flagged past the end."""
    lens, stride = [3, 0, 9], 10
    user = np.zeros(30, np.uint8)
    user[1] = user[25] = 1
    plane = convert.padding_plane(lens, stride, "cpu", convert.code_bytes(user, "cpu"))
    bits = np.unpackbits(plane.numpy(), bitorder="little")
    want = np.ones(32, np.uint8)
    want[0:3] = want[20:29] = 0
    want[[1, 25]] = 1
    np.testing.assert_array_equal(bits, want)


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, pipeline.MODE_OPEN_SYNCMERS])
def test_run_batch_vs_jax_builder(mode):
    """Builder.run_batch(device="cpu") and the JAX builder's run_batch: DNA
    as bytes, str, AsciiSeq and PackedSeq, a (B, L) matrix, text reads."""
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    raw = [acgt[rng.integers(0, 4, n)].tobytes() for n in (200, 17, 0, 555, 64)]
    mats = acgt[rng.integers(0, 4, (6, 80))]
    text = [rng.integers(32, 127, n, dtype=np.uint8).tobytes() for n in (90, 300)]
    k, w = 5, 7
    syncmer = 2 if mode == pipeline.MODE_OPEN_SYNCMERS else 0
    port = smt.Builder(k, w, True, syncmer=syncmer)
    ref = sm.Builder(k, w, True, syncmer=syncmer)
    if mode == SKM:
        port, ref = port.super_kmers(), ref.super_kmers()
    cases = [(raw, raw), ([r.decode() for r in raw], raw),
             ([smt.AsciiSeq(r) for r in raw], raw),
             ([smt.PackedSeqVec.from_ascii(r) for r in raw], raw),
             (mats, mats), (text + raw[:2], text + raw[:2])]
    for reads, jreads in cases:
        got = port.run_batch(reads, device="cpu")
        want = ref.run_batch(jreads)
        for g, p in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, p)
    amb = [np.zeros(len(r), np.uint8) for r in raw]
    amb[0][50] = 1
    if mode == SKM:
        for b in (port, ref):
            kw = {"device": "cpu"} if b is port else {}
            with pytest.raises(AssertionError, match="cannot be combined with an ambiguity"):
                b.run_batch(raw, ambiguous=amb, **kw)
    else:
        got = port.run_batch(raw, ambiguous=amb, device="cpu")
        for g, p in zip(got, ref.run_batch(raw, ambiguous=amb), strict=True):
            np.testing.assert_array_equal(g, p)
