"""Batched reads: the port's `ops/batch.sketch_batch` on the CPU (the
kernels' plain versions, and the plain pipeline route) == the JAX package's
`sketch_batch(backend="fused", interpret=True)` (C=1024) on the cases of
tests/test_batch.py == the per-read NumPy oracle; and `Builder.run_batch`
against the JAX builder's. A (B, L) ASCII matrix takes its own route
(folded and slotted by `fused.ascii_slots`, here its plain version): held
to the host route's slots and plane, and to the same rows as a list and
to the JAX builder's run_batch in three modes.

Integer outputs: tolerance 0. The kernels run the same launches on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

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


# -- the matrix route: a (B, L) ASCII matrix folded and slotted on the device --


def _host_slots(rows, stride, amb):
    """What the host route makes of an ASCII matrix: the fold of
    Builder.run_batch before the matrix route (as_seq row by row), then
    `_fill_slots` and `convert.padding_plane`."""
    from simd_minimizers_tpu_torch.seq.packed import _ASCII_TO_CODE, _IS_ACGT

    acgt = _IS_ACGT[rows].all(axis=1)
    codes = np.where(acgt[:, None], _ASCII_TO_CODE[rows], rows)
    chars, flags = batch._fill_slots(codes, None if amb is None else list(amb), stride)
    plane = convert.padding_plane([rows.shape[1]] * rows.shape[0], stride, "cpu",
                                  None if flags is None else convert.code_bytes(flags, "cpu"))
    return chars, plane.numpy(), bool(acgt.all())


@pytest.mark.parametrize("L,stride,masked", [(150, 160, False), (150, 160, True), (1, 8, True),
                                             (7, 9, False), (13, 14, True), (31, 36, False),
                                             (62, 64, True), (497, 512, False),
                                             (600, 640, True)])
@pytest.mark.parametrize("alphabet", ["bytes", "acgt", "acgt and one N"])
def test_ascii_slots_plain_is_the_host_route(L, stride, masked, alphabet):
    """fused.ascii_slots on the CPU (its plain version) gives the host
    route's slots, plane and DNA verdict bit for bit."""
    rng = np.random.default_rng(L * 7 + stride)
    if alphabet == "bytes":
        rows = rng.integers(0, 256, (9, L), dtype=np.uint8)
    else:
        rows = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, (9, L))]
        if alphabet != "acgt":
            rows[4, L // 2] = ord("N")
    amb = (rng.random((9, L)) < 0.1).astype(np.uint8) * 3 if masked else None
    dna = torch.ones(1, dtype=torch.int32)
    chars, plane = fused.ascii_slots(torch.from_numpy(rows), stride, dna,
                                     None if amb is None else torch.from_numpy(amb))
    want_chars, want_plane, want_dna = _host_slots(rows, stride, amb)
    np.testing.assert_array_equal(chars.numpy(), want_chars)
    np.testing.assert_array_equal(plane.numpy(), want_plane)
    assert bool(dna.item()) == want_dna


def _matrix_case(case):
    """(matrix, masks or None) of a named case of the matrix route."""
    rng = np.random.default_rng(sum(map(ord, case)))
    mixed = np.frombuffer(b"ACGTacgt", np.uint8)
    rows = mixed[rng.integers(0, 8, (7, 90))]
    if case == "upper and lower case":
        return rows, None
    if case == "one N":
        rows[3, 40] = ord("N")
        return rows, None
    if case == "all text":
        return rng.integers(32, 127, (5, 120), dtype=np.uint8), None
    if case == "shorter than a window":
        return rows[:, :10].copy(), None
    if case == "one read":
        return rows[:1].copy(), None
    if case == "masks":
        return rows, (rng.random(rows.shape) < 0.03).astype(np.uint8)
    if case == "split launches":
        return mixed[rng.integers(0, 8, (11, 64))], None
    if case == "non-contiguous view":
        return mixed[rng.integers(0, 8, (14, 200))][::2, 5:150], None
    raise ValueError(case)


MATRIX_CASES = ["upper and lower case", "one N", "all text", "shorter than a window",
                "one read", "masks", "split launches", "non-contiguous view"]


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, pipeline.MODE_OPEN_SYNCMERS])
@pytest.mark.parametrize("case", MATRIX_CASES)
def test_run_batch_matrix_route(case, mode, monkeypatch):
    """Builder.run_batch of a (B, L) matrix (folded and slotted by
    fused.ascii_slots, here its plain version) == the same rows as a list
    (folded on the host) == the JAX builder's run_batch."""
    rows, masks = _matrix_case(case)
    if case == "split launches":
        monkeypatch.setattr(batch, "MAX_LAUNCH_CHARS", 3 * 72)  # 3 rows of stride 72 a launch
    syncmer = 2 if mode == pipeline.MODE_OPEN_SYNCMERS else 0
    port = smt.Builder(5, 7, True, syncmer=syncmer)
    ref = sm.Builder(5, 7, True, syncmer=syncmer)
    if mode == SKM:
        port, ref = port.super_kmers(), ref.super_kmers()
    listed = [r.tobytes() for r in rows]
    amb = None if masks is None else list(masks)
    if mode == SKM and masks is not None:
        with pytest.raises(AssertionError, match="cannot be combined with an ambiguity"):
            port.run_batch(rows, ambiguous=masks, device="cpu")
        return
    called = []
    slots = fused.ascii_slots
    monkeypatch.setattr(fused, "ascii_slots", lambda *a: called.append(1) or slots(*a))
    got = port.run_batch(rows, ambiguous=masks, device="cpu")
    want_launches = 0 if rows.shape[1] < 11 else 4 if case == "split launches" else 1
    assert len(called) == want_launches
    for g, h, r in zip(got, port.run_batch(listed, ambiguous=amb, device="cpu"),
                       ref.run_batch(listed, ambiguous=amb), strict=True):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, h)
        np.testing.assert_array_equal(g, r)
    if case == "shorter than a window":
        assert got[0].size == 0


def test_matrix_route_takes_no_dna_and_a_mask_per_row():
    """sketch_batch's ascii flag is the matrix route's key: it refuses a
    dna verdict (the device probes it) and masks of another shape; a
    matrix of codes without the flag is not folded again."""
    h = convert.hasher_from(NtHasher(5, canonical=True))
    rows = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, (4, 40))]
    with pytest.raises(ValueError, match="pass no dna"):
        batch.sketch_batch(rows, 5, 7, h, ascii=True, dna=True, device="cpu")
    with pytest.raises(ValueError, match="flags for"):
        batch.sketch_batch(rows, 5, 7, h, ambiguous=np.zeros((4, 39), np.uint8), ascii=True,
                           device="cpu")
    codes = (rows >> 1) & 3
    got = batch.sketch_batch(codes, 5, 7, h, dna=True, device="cpu")
    for g, r in zip(got, batch.sketch_batch(rows, 5, 7, h, ascii=True, device="cpu"),
                    strict=True):
        np.testing.assert_array_equal(g, r)
