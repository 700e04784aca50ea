"""Syncmers with their values in one call (`backend.sketch(..., "open_syncmers"
| "closed_syncmers", values=True)`): strobealign's seeds, canonical open
syncmers with each syncmer's u64 value, against the JAX package's `Output`
of the same builder on the same codes (its accelerated run on the CPU, its
NumPy oracle beside a card) and against the benchmark's plain reference
(`benchmark/references/open_syncmers.py`, plain PyTorch over
`references/minimizers.py`), which imports nothing of the program.

On the CPU: open and closed syncmers, canonical and forward, at k=17 w=7,
k=21 w=11 and k=11 w=5 and a sequence shorter than one window, through
`backend.sketch` and `Builder.run(..., values=True)`, against the JAX
package; open syncmers against the reference; the CPU's spans and their
blocks of values, the values step's host waits and bus bytes (none),
`Builder.run(..., values=True)` against `values_u64` asked after a run, the
crate's all-G case and its reverse-complement symmetry, and the values
that still raise. The cases marked `cuda` hold the kernel route and
`sketch_long` on a card to the same, and `Builder.run(..., values=True)`
to its single upload; they import no JAX, skip without a card and run as

    python -m pytest --noconftest -m cuda tests/test_torch_syncmer_values.py -q
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simd_minimizers_tpu as jsm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.seq.packed import PackedSeqVec as JPackedSeqVec
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, device_values, fused, pipeline, spans
from simd_minimizers_tpu_torch.seq.packed import GenericSeq, PackedSeqVec
from simd_minimizers_tpu_torch.utils import profiling

BENCH_DIR = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH_DIR)]

import reference  # noqa: E402

OPEN, CLOSED = pipeline.MODE_OPEN_SYNCMERS, pipeline.MODE_CLOSED_SYNCMERS
TILE = fused.TILE
# (k, w, canonical, n): strobealign's k=23 s=17, two more with l <= 32, each
# canonical and forward, and a sequence shorter than one window
CASES = [(17, 7, True, 60_000), (17, 7, False, 60_000), (21, 11, True, 40_000),
         (21, 11, False, 40_000), (11, 5, True, 30_000), (11, 5, False, 30_000),
         (17, 7, True, 20)]
CASE_IDS = ["k17w7", "k17w7-forward", "k21w11", "k21w11-forward", "k11w5", "k11w5-forward",
            "shorter-than-l"]


def _codes(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)


def _chars(codes, device="cpu"):
    return convert.packed_words(PackedSeqVec.from_codes(codes), device)


def _want(k, w, canonical, codes):
    """The reference's planes: window indices, value low and high 32 bits."""
    ref = reference.make({"mode": "open_syncmers", "hasher": "nt", "values": "u64", "k": k,
                          "w": w, "canonical": canonical})
    return ref.sequence(torch.from_numpy(codes), block_windows=997)


def _jax_output(k, w, canonical, mode, codes, scalar=False):
    """The JAX package's `Output` of the same syncmers of `codes`: its
    accelerated run, or with `scalar` its NumPy oracle (`run_scalar`, which
    imports no JAX)."""
    b = jsm.Builder(k, w, canonical=canonical, syncmer=2 if mode == OPEN else 1)
    seq = JPackedSeqVec.from_codes(codes)
    return b.run_scalar(seq) if scalar else b.run(seq)


def _assert_as_jax(positions, values, want):
    """Window indices (u32 or their int32 bits) and u64 values (or their
    int64 bits) equal to the JAX package's `Output` `want`."""
    np.testing.assert_array_equal(np.asarray(positions).view(np.uint32), want.positions)
    np.testing.assert_array_equal(np.asarray(values).view(np.uint64), want.values_u64())


def _as_reference_planes(res):
    """The program's planes with the int64 values split into their 32-bit
    halves, as the benchmark compares them."""
    *planes, vals = res
    return (*planes, vals & 0xFFFF_FFFF, (vals >> 32) & 0xFFFF_FFFF)


def _u64(planes):
    """The reference's two value planes as np.uint64."""
    return (planes[1] | planes[2] << 32).numpy().view(np.uint64)


@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_sketch_values_match_the_reference(k, w, canonical, n):
    codes = _codes(n, k * 1000 + w)
    chars = _chars(codes)
    h = smt.NtHasher(k, canonical=canonical)
    res = backend.sketch(chars, n, k, w, h, OPEN, values=True)
    assert len(res) == 2 and res[-1].dtype == torch.int64
    assert reference.same(_as_reference_planes(res), _want(k, w, canonical, codes))
    # the window indices are those of the call without values
    assert torch.equal(backend.sketch(chars, n, k, w, h, OPEN), res[0])


@pytest.mark.parametrize("entry", ["sketch", "builder"])
@pytest.mark.parametrize("mode", [OPEN, CLOSED], ids=["open", "closed"])
@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_values_vs_jax(k, w, canonical, n, mode, entry):
    """Window indices and values of `backend.sketch(..., values=True)` and of
    `Builder.run(..., values=True)` equal the JAX package's `Output` and its
    `values_u64` for the same builder on the same codes."""
    codes = _codes(n, k * 1000 + w + (mode == CLOSED))
    want = _jax_output(k, w, canonical, mode, codes)
    assert want.length == k + w - 1
    if entry == "sketch":
        pos, vals = backend.sketch(_chars(codes), n, k, w, smt.NtHasher(k, canonical=canonical),
                                   mode, values=True)
        _assert_as_jax(pos.numpy(), vals.numpy(), want)
    else:
        b = smt.Builder(k, w, canonical, syncmer=2 if mode == OPEN else 1)
        out = b.run(PackedSeqVec.from_codes(codes), device="cpu", values=True)
        assert out._values_u64 is not None and out.length == want.length
        _assert_as_jax(out.positions, out.values_u64(), want)
    assert (want.positions.size > 0) == (n >= k + w - 1)


@pytest.mark.parametrize("byte_codes", [False, True], ids=["packed", "code-bytes"])
def test_chunked_route_values_match_the_reference(byte_codes):
    """The CPU's spans (`spans.sketch_long`), seams every 2 * TILE windows:
    global window indices, and the values of the whole sequence's l-mers."""
    k, w, n = 17, 7, 5 * 2 * TILE + 333
    codes = _codes(n, 77)
    chars = convert.code_bytes(codes, "cpu") if byte_codes else _chars(codes)
    res = spans.sketch_long(chars, n, k, w, smt.NtHasher(k, canonical=True), OPEN,
                            byte_codes=byte_codes, span_chars=2 * TILE + k + w - 2)
    res = spans.with_values(res, chars, spans.value_length(k, w, OPEN), True, byte_codes)
    assert reference.same(_as_reference_planes(res), _want(k, w, True, codes))


def test_chunked_route_values_stay_in_blocks(monkeypatch):
    """On the CPU, backend.sketch's syncmer values take the window indices
    in blocks of spans.PIPELINE_CHUNK_WINDOWS: no values call sees more, each
    at length l, and the planes equal the reference's."""
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", 2 * TILE)
    sizes, real = [], device_values.kmer_values_limbs

    def limbs(chars, positions, k, *a, **kw):
        sizes.append((positions.numel(), k))
        return real(chars, positions, k, *a, **kw)

    monkeypatch.setattr(device_values, "kmer_values_limbs", limbs)
    k, w, n = 17, 7, 40 * 2 * TILE + 71
    codes = _codes(n, 78)
    res = backend.sketch(_chars(codes), n, k, w, smt.NtHasher(k, canonical=True), OPEN,
                         values=True)
    assert len(sizes) > 1 and max(m for m, _ in sizes) <= 2 * TILE
    assert sum(m for m, _ in sizes) == res[0].numel() and {k for _, k in sizes} == {23}
    assert reference.same(_as_reference_planes(res), _want(k, w, True, codes))


@pytest.mark.parametrize("route", ["one launch", "chunked"])
def test_values_add_no_host_wait_and_no_bus_bytes(route):
    """The values step waits for nothing and moves nothing across the bus:
    the calls with and without it count the same SYNCS and BUS_BYTES."""
    k, w, n = 17, 7, 3 * 2 * TILE + 5
    chars = _chars(_codes(n, 5))
    h = smt.NtHasher(k, canonical=True)

    def counted(values):
        syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
        if route == "chunked":
            res = spans.sketch_long(chars, n, k, w, h, OPEN, span_chars=2 * TILE + k + w - 2)
            if values:
                spans.with_values(res, chars, k + w - 1, True)
        else:
            backend.sketch(chars, n, k, w, h, OPEN, values=values)
        return profiling.SYNCS - syncs, profiling.BUS_BYTES - bus

    counted(False)  # the hasher's tables kept from here on, for both calls
    assert counted(True) == counted(False)


@pytest.mark.parametrize("values", [False, True], ids=["asked-later", "in-the-run"])
@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "forward"])
def test_builder_values_u64_match_the_reference(canonical, values):
    """`values_u64` of an open-syncmer run, computed when asked or in the
    run itself (`values=True`), the l-mer's at each window index."""
    k, w, n = 17, 7, 50_000
    codes = _codes(n, 31)
    b = smt.Builder(k, w, canonical, syncmer=2)
    assert b._mode == OPEN
    out = b.run(PackedSeqVec.from_codes(codes), device="cpu", values=values)
    assert (out._values_u64 is not None) == values and out.length == k + w - 1
    want = _want(k, w, canonical, codes)
    np.testing.assert_array_equal(out.positions, want[0].numpy())
    np.testing.assert_array_equal(out.values_u64(), _u64(want))
    np.testing.assert_array_equal(out.positions, b.run_scalar(codes).positions)


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "forward"])
def test_closed_syncmer_values_match_output(canonical):
    """Closed syncmers with values in the run give the JAX package's window
    indices and `values_u64`, and what the port's `Output.values_u64`
    computes after a run without them."""
    k, w, n = 11, 9, 40_000  # l = 19
    codes = _codes(n, 32)
    seq = PackedSeqVec.from_codes(codes)
    b = smt.canonical_closed_syncmers(k, w) if canonical else smt.closed_syncmers(k, w)
    out = b.run(seq, device="cpu", values=True)
    later = b.run(seq, device="cpu")
    assert later._values_u64 is None and out.positions.size > 0
    _assert_as_jax(out.positions, out.values_u64(), _jax_output(k, w, canonical, CLOSED, codes))
    np.testing.assert_array_equal(out.positions, later.positions)
    np.testing.assert_array_equal(out.values_u64(), later.values_u64())


def test_all_g_closed_syncmer_values():
    """The crate's all-G case (src/test.rs:577-597): every window is a
    forward closed syncmer, each value all ones, 4^l - 1."""
    n = 100
    chars = _chars(np.full(n, 3, np.uint8))  # G is code 3
    for k in range(1, 8):
        for w in range(1, 8):
            l = k + w - 1
            idx, vals = backend.sketch(chars, n, k, w, smt.NtHasher(k), CLOSED, values=True)
            assert idx.tolist() == list(range(n - l + 1)), (k, w)
            assert set(vals.tolist()) == {4**l - 1}, (k, w)


@pytest.mark.parametrize("mode", [OPEN, CLOSED])
def test_reverse_complement_symmetry(mode):
    """Canonical syncmers of a sequence and of its reverse complement
    (src/test.rs:641-708): window x of one is window len - l - x of the
    other, with the same canonical value."""
    k, w, n = 17, 7, 20_000
    l = k + w - 1
    seq = PackedSeqVec.from_codes(_codes(n, 33))
    b = smt.Builder(k, w, True, syncmer=2 if mode == OPEN else 1)
    f = b.run(seq, device="cpu", values=True)
    r = b.run(seq.to_revcomp(), device="cpu", values=True)
    assert f.positions.size == r.positions.size > 0
    np.testing.assert_array_equal(f.positions.astype(np.int64),
                                  n - l - r.positions[::-1].astype(np.int64))
    np.testing.assert_array_equal(f.values_u64(), r.values_u64()[::-1])


@pytest.mark.parametrize("mode", [OPEN, CLOSED])
def test_values_past_l_32_raise(mode):
    """Syncmers of more than 32 chars (k=17 w=17: l = 33) have no u64 value."""
    codes = _codes(5000, 6)
    with pytest.raises(NotImplementedError, match="values=True.*k=17, w=17"):
        backend.sketch(_chars(codes), codes.size, 17, 17, smt.NtHasher(17, canonical=True),
                       mode, values=True)
    with pytest.raises(NotImplementedError, match="values=True"):
        smt.Builder(17, 17, True, syncmer=2 if mode == OPEN else 1).run(
            PackedSeqVec.from_codes(codes), device="cpu", values=True)


def test_values_of_syncmer_text_raise():
    text = np.random.default_rng(4).integers(32, 127, 5000, dtype=np.uint8)
    chars = convert.text_bytes(GenericSeq(text), "cpu")
    h = convert.hasher_from(smt.MulHasher(7))
    with pytest.raises(NotImplementedError, match="values=True"):
        backend.sketch(chars, text.size, 7, 5, h, OPEN, text=True, values=True)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [OPEN, CLOSED])
@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_kernel_route_values_match_the_reference(dev, k, w, canonical, n, mode):
    """The three kernels and `kmer_values`, one launch each, no host wait
    and no bus bytes besides the call without values; open and closed
    syncmers against the JAX package's NumPy oracle and its host values,
    open syncmers against the reference too."""
    codes = _codes(n, k * 1000 + w)
    chars = _chars(codes, dev)
    h = smt.NtHasher(k, canonical=canonical)
    convert.hasher_tensors(h, dev)  # the tables kept on the card, for both calls
    before = dict(fused.LAUNCHES)
    syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
    res = backend.sketch(chars, n, k, w, h, mode, values=True)
    torch.cuda.synchronize()
    with_values = profiling.SYNCS - syncs, profiling.BUS_BYTES - bus
    grew = {key: c - before[key] for key, c in fused.LAUNCHES.items() if c != before[key]}
    assert res[-1].device.type == "cuda"
    _assert_as_jax(res[0].cpu().numpy(), res[1].cpu().numpy(),
                   _jax_output(k, w, canonical, mode, codes, scalar=True))
    if mode == OPEN:
        assert reference.same(_as_reference_planes(res), _want(k, w, canonical, codes))
    if n >= k + w - 1:
        assert grew == {fused.instance_name(canonical, mode, False): 1, "tile_offsets": 1,
                        "tile_append": 1, "kmer_values": 1}
    syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
    backend.sketch(chars, n, k, w, h, mode)
    assert with_values == (profiling.SYNCS - syncs, profiling.BUS_BYTES - bus)


@pytest.mark.cuda
def test_sketch_long_values_match_the_reference(dev):
    """Spans of 2^20 chars on the card: global window indices across four
    seams and the values of the whole sequence's l-mers, one `kmer_values`
    launch after the concatenation."""
    k, w, n = 17, 7, 4 * (1 << 20) + 12_345
    codes = _codes(n, 2525)
    chars = _chars(codes, dev)
    before = fused.LAUNCHES["kmer_values"]
    res = spans.with_values(spans.sketch_long(chars, n, k, w, smt.NtHasher(k, canonical=True),
                                              OPEN, span_chars=1 << 20), chars, k + w - 1, True)
    assert fused.LAUNCHES["kmer_values"] == before + 1
    want = _want(k, w, True, codes)
    assert reference.same(_as_reference_planes(res), tuple(p.to(dev) for p in want))


@pytest.mark.cuda
def test_builder_run_with_values_uploads_once(dev):
    """Builder.run(..., values=True) of syncmers on the card uploads the
    words once, as the run without values does, and no positions; only the
    download grows, by 8 B a value. values_u64 then crosses the bus no
    more, and they are the JAX package's `values_u64`."""
    codes = _codes(200_000, 11)
    seq = PackedSeqVec.from_codes(codes)
    for mode, b in ((OPEN, smt.canonical_open_syncmers(17, 7)),
                    (CLOSED, smt.canonical_closed_syncmers(17, 7))):
        b.run(seq, device=dev)  # the hasher's tables kept on the card, for both runs
        counts = {}
        for values in (False, True):
            syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
            out = b.run(seq, device=dev, values=values)
            counts[values] = profiling.SYNCS - syncs, profiling.BUS_BYTES - bus
        (syncs0, bus0), (syncs1, bus1) = counts[False], counts[True]
        assert syncs1 == syncs0 and "positions upload" not in syncs1
        assert bus1 - bus0 == collections.Counter({"d2h pinned": 8 * out.positions.size})
        assert bus1["h2d pageable"] == bus0["h2d pageable"]
        syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
        vals = out.values_u64()
        assert profiling.SYNCS == syncs and profiling.BUS_BYTES == bus
        _assert_as_jax(out.positions, vals, _jax_output(17, 7, True, mode, codes, scalar=True))
