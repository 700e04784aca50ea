"""The sketch with its k-mer values in one call (`backend.sketch(...,
values=True)`): SSHash's parse, super-k-mers with each minimizer's u64
value, against the benchmark's plain reference (`benchmark/references/
superkmers.py`, plain PyTorch over `references/minimizers.py`), which
imports nothing of the program.

On the CPU: super-k-mers and minimizers with their values on seeded 2-bit
sequences (canonical k=21 w=11 and k=31 w=5, forward k=16 w=9, a sequence
shorter than one window), the CPU's spans and their blocks of values, the
values step's host waits and bus bytes (none),
`Builder(...).super_kmers().run(...).values_u64()` asked later or in the
run (`values=True`), an `Output` that holds no tensor, and the inputs that
raise (syncmers' values: `test_torch_syncmer_values.py`). The cases marked `cuda` hold the kernel route and
`sketch_long` on a card to the same, `Builder.run(..., values=True)` to
its single upload, and a run to the card memory it leaves (none); they
skip without a card and run as

    python -m pytest --noconftest -m cuda tests/test_torch_superkmer_values.py -q
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, device_values, fused, pipeline, spans
from simd_minimizers_tpu_torch.seq.packed import GenericSeq, PackedSeqVec
from simd_minimizers_tpu_torch.utils import profiling

BENCH_DIR = Path(__file__).resolve().parents[1] / "benchmark"
sys.path[:0] = [str(BENCH_DIR)]

import reference  # noqa: E402

SKM, MIN = pipeline.MODE_SUPERKMERS, pipeline.MODE_MINIMIZERS
TILE = fused.TILE
# (k, w, canonical, n): the deployment, the KMC/GGCAT-style k=31, a forward
# k=16 (one limb), and a sequence shorter than one window
CASES = [(21, 11, True, 100_000), (31, 5, True, 40_000), (16, 9, False, 60_000),
         (21, 11, True, 30)]
CASE_IDS = ["k21w11", "k31w5", "k16w9-forward", "shorter-than-l"]


def superkmers_ref(k, w, canonical, control=False):
    return reference.make({"mode": "superkmers", "hasher": "nt", "values": "u64", "k": k,
                           "w": w, "canonical": canonical}, control)


def _codes(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)


def _want(k, w, canonical, codes, mode):
    """The reference's planes for `mode`: super-k-mers (positions, indices,
    value low, value high), minimizers without the indices."""
    planes = superkmers_ref(k, w, canonical).sequence(torch.from_numpy(codes),
                                                      block_windows=997)
    return planes if mode == SKM else (planes[0], *planes[2:])


def _as_reference_planes(res):
    """The program's planes with the int64 values split into their 32-bit
    halves, as the benchmark compares them."""
    *planes, vals = res
    return (*planes, vals & 0xFFFF_FFFF, (vals >> 32) & 0xFFFF_FFFF)


@pytest.mark.parametrize("mode", [SKM, MIN])
@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_sketch_values_match_the_reference(k, w, canonical, n, mode):
    codes = _codes(n, k * 1000 + w)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
    h = smt.NtHasher(k, canonical=canonical)
    res = backend.sketch(chars, n, k, w, h, mode, values=True)
    assert len(res) == (3 if mode == SKM else 2) and res[-1].dtype == torch.int64
    assert reference.same(_as_reference_planes(res), _want(k, w, canonical, codes, mode))
    # the positions and indices are those of the call without values
    plain = backend.sketch(chars, n, k, w, h, mode)
    for a, b in zip(plain if mode == SKM else (plain,), res[:-1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", [SKM, MIN])
@pytest.mark.parametrize("byte_codes", [False, True], ids=["packed", "code-bytes"])
def test_chunked_route_values_match_the_reference(mode, byte_codes):
    """The CPU's spans (`spans.sketch_long`), seams every 2 * TILE windows: global
    positions, and the values of the whole sequence's k-mers."""
    k, w, n = 21, 11, 5 * 2 * TILE + 333
    codes = _codes(n, 77)
    chars = (convert.code_bytes(codes, "cpu") if byte_codes
             else convert.packed_words(PackedSeqVec.from_codes(codes), "cpu"))
    h = smt.NtHasher(k, canonical=True)
    res = spans.with_values(spans.sketch_long(chars, n, k, w, h, mode, byte_codes=byte_codes,
                                              span_chars=2 * TILE + k + w - 2),
                            chars, k, True, byte_codes)
    assert reference.same(_as_reference_planes(res), _want(k, w, True, codes, mode))


@pytest.mark.parametrize("mode", [SKM, MIN])
def test_chunked_route_values_stay_in_blocks(mode, monkeypatch):
    """On the CPU, backend.sketch's values take the positions in blocks of
    spans.PIPELINE_CHUNK_WINDOWS, as its CPU spans take the windows:
    no values call sees more, and the planes equal the reference's."""
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", 2 * TILE)
    sizes, real = [], device_values.kmer_values_limbs

    def limbs(chars, positions, *a, **kw):
        sizes.append(positions.numel())
        return real(chars, positions, *a, **kw)

    monkeypatch.setattr(device_values, "kmer_values_limbs", limbs)
    k, w, n = 21, 11, 40 * 2 * TILE + 71
    codes = _codes(n, 78)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
    res = backend.sketch(chars, n, k, w, smt.NtHasher(k, canonical=True), mode, values=True)
    assert len(sizes) > 1 and max(sizes) <= 2 * TILE and sum(sizes) == res[0].numel()
    assert reference.same(_as_reference_planes(res), _want(k, w, True, codes, mode))


@pytest.mark.parametrize("route", ["one launch", "chunked"])
def test_values_add_no_host_wait_and_no_bus_bytes(route):
    """The values step waits for nothing and moves nothing across the bus:
    the calls with and without it count the same SYNCS and BUS_BYTES."""
    k, w, n = 21, 11, 3 * 2 * TILE + 5
    codes = _codes(n, 5)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
    h = smt.NtHasher(k, canonical=True)

    def counted(values):
        syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
        if route == "chunked":
            res = spans.sketch_long(chars, n, k, w, h, SKM, span_chars=2 * TILE + k + w - 2)
            if values:
                spans.with_values(res, chars, k, True)
        else:
            backend.sketch(chars, n, k, w, h, SKM, values=values)
        return profiling.SYNCS - syncs, profiling.BUS_BYTES - bus

    assert counted(True) == counted(False)


@pytest.mark.parametrize("values", [False, True], ids=["asked-later", "in-the-run"])
@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_builder_values_u64_match_the_reference(k, w, canonical, n, values):
    """`values_u64` of a run, computed when asked or in the run itself."""
    codes = _codes(n, k * 1000 + w)
    b = smt.Builder(k, w, canonical=canonical).super_kmers()
    out = b.run(PackedSeqVec.from_codes(codes), device="cpu", values=values)
    assert (out._values_u64 is not None) == values
    pos, idx, lo, hi = superkmers_ref(k, w, canonical).sequence(torch.from_numpy(codes))
    np.testing.assert_array_equal(out.positions, pos.numpy())
    np.testing.assert_array_equal(out.superkmer_indices, idx.numpy())
    np.testing.assert_array_equal(out.values_u64(), (lo | hi << 32).numpy().view(np.uint64))


@pytest.mark.parametrize("values", [False, True], ids=["plain", "values"])
@pytest.mark.parametrize("super_kmers", [False, True], ids=["minimizers", "super-k-mers"])
def test_builder_run_keeps_no_tensor(super_kmers, values):
    """An Output holds host arrays only: nothing of the run (its words, its
    positions) outlives it on the device."""
    codes = _codes(20_000, 12)
    b = smt.canonical_minimizers(21, 11)
    b = b.super_kmers() if super_kmers else b
    out = b.run(PackedSeqVec.from_codes(codes), device="cpu", values=values)
    assert not any(isinstance(v, torch.Tensor) for v in vars(out).values())
    np.testing.assert_array_equal(out.values_u64(),
                                  b.run(PackedSeqVec.from_codes(codes), device="cpu").values_u64())


def test_reference_golden_values():
    """The crate's doc-test: canonical k=5 w=7 minimizers of
    ACGTGCTCAGAGACTCAGAGGA at 0, 7, 9, 15, the first value 721 (0x2D1)."""
    seq = torch.frombuffer(bytearray(b"ACGTGCTCAGAGACTCAGAGGA"), dtype=torch.uint8)
    pos, idx, lo, hi = superkmers_ref(5, 7, True).sequence(reference.ascii_codes(seq))
    assert pos.tolist() == [0, 7, 9, 15] and int(lo[0]) == 721 and not hi.any()
    assert idx[0] == 0 and idx.tolist() == sorted(idx.tolist())


@pytest.mark.parametrize("mode", [SKM, MIN])
def test_values_of_text_raise(mode):
    text = np.random.default_rng(4).integers(32, 127, 5000, dtype=np.uint8)
    chars = convert.text_bytes(GenericSeq(text), "cpu")
    h = convert.hasher_from(smt.MulHasher(7))
    with pytest.raises(NotImplementedError, match="values=True"):
        backend.sketch(chars, text.size, 7, 11, h, mode, text=True, values=True)


def test_values_past_k_32_raise():
    codes = _codes(5000, 6)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
    with pytest.raises(NotImplementedError, match="k=33"):
        backend.sketch(chars, codes.size, 33, 11, smt.NtHasher(33, canonical=False), MIN,
                       values=True)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [SKM, MIN])
@pytest.mark.parametrize("k,w,canonical,n", CASES, ids=CASE_IDS)
def test_kernel_route_values_match_the_reference(dev, k, w, canonical, n, mode):
    """The three kernels and `kmer_values`, one launch each, no host wait
    and no bus bytes besides the call without values."""
    codes = _codes(n, k * 1000 + w)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    h = smt.NtHasher(k, canonical=canonical)
    before = dict(fused.LAUNCHES)
    syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
    res = backend.sketch(chars, n, k, w, h, mode, values=True)
    torch.cuda.synchronize()
    with_values = profiling.SYNCS - syncs, profiling.BUS_BYTES - bus
    grew = {key: c - before[key] for key, c in fused.LAUNCHES.items() if c != before[key]}
    assert res[-1].device.type == "cuda"
    assert reference.same(_as_reference_planes(res), _want(k, w, canonical, codes, mode))
    if n >= k + w - 1:
        assert grew == {fused.instance_name(canonical, mode, False): 1, "tile_offsets": 1,
                        "tile_append": 1, "kmer_values": 1}
    syncs, bus = profiling.SYNCS.copy(), profiling.BUS_BYTES.copy()
    backend.sketch(chars, n, k, w, h, mode)
    assert with_values == (profiling.SYNCS - syncs, profiling.BUS_BYTES - bus)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [SKM, MIN])
def test_sketch_long_values_match_the_reference(dev, mode):
    """Spans of 2^20 chars on the card: global positions across four seams
    and the values of the whole sequence's k-mers, one `kmer_values` launch
    after the merge."""
    k, w, n = 21, 11, 4 * (1 << 20) + 12_345
    codes = _codes(n, 2020)
    chars = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    before = fused.LAUNCHES["kmer_values"]
    res = spans.with_values(spans.sketch_long(chars, n, k, w, smt.NtHasher(k, canonical=True),
                                              mode, span_chars=1 << 20), chars, k, True)
    assert fused.LAUNCHES["kmer_values"] == before + 1
    want = _want(k, w, True, codes, mode)
    assert reference.same(_as_reference_planes(res), tuple(p.to(dev) for p in want))


@pytest.mark.cuda
def test_builder_run_with_values_uploads_nothing_more(dev):
    """Builder.run(..., values=True) on the card uploads the words once, as
    the run without values does, and no positions; only the download
    grows, by 8 B a value. values_u64 then crosses the bus no more."""
    codes = _codes(200_000, 11)
    seq = PackedSeqVec.from_codes(codes)
    for b in (smt.canonical_minimizers(21, 11), smt.canonical_minimizers(21, 11).super_kmers()):
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
        np.testing.assert_array_equal(vals, b.run(seq, device="cpu").values_u64())


@pytest.mark.cuda
@pytest.mark.parametrize("values", [False, True], ids=["plain", "values"])
def test_builder_run_keeps_no_card_memory(dev, values):
    """A run returns with nothing of it left on the card, whether or not it
    was asked for values."""
    seq = PackedSeqVec.from_codes(_codes(1_000_000, 13))
    b = smt.canonical_minimizers(21, 11).super_kmers()
    b.run(seq, device=dev, values=values)  # builds and caches what every run shares
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = b.run(seq, device=dev, values=values)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before and out.positions.size
