"""The hasher's char tables kept on their device (`convert.hasher_tensors`):
the first call for a device and a table builds and uploads it, every later
one finds the same tensor (no build, no upload, no sync); the key is what
the kernels read, so hashers of one (kind, canonical, rot_offset) with
tables of their own each get their own entry, and the oldest entry goes
past `convert.TABLES_KEPT`."""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend
from simd_minimizers_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _cold():
    convert._tables.clear()
    yield
    convert._tables.clear()


def _counts():
    return [collections.Counter(c) for c in (profiling.SYNCS, profiling.BUS_BYTES,
                                             profiling.TABLES)]


def _added(before):
    return [dict(c - b) for c, b in zip((profiling.SYNCS, profiling.BUS_BYTES,
                                         profiling.TABLES), before)]


@pytest.mark.parametrize("text", [False, True], ids=["2-bit", "text"])
@pytest.mark.parametrize("hasher", [smt.NtHasher(21, True), smt.NtHasher(21, seed=5),
                                    smt.MulHasher(21, True), smt.MulHasher(21, seed=9)],
                         ids=["nt", "nt-seeded", "mul", "mul-seeded"])
def test_second_call_returns_the_same_tensor(hasher, text):
    """One upload (its sync and bytes), then a hit that counts no sync and
    no byte and returns the very tensor, equal to the hasher's char tables."""
    before = _counts()
    key, first = convert.hasher_tensors(hasher, "cpu", text)
    entries = convert.TABLE_ENTRIES[text]
    assert _added(before) == [{"tables upload": 1}, {"h2d pageable": 2 * entries * 8},
                              {"uploads": 1}]
    before = _counts()
    key2, second = convert.hasher_tensors(hasher, "cpu", text)
    assert _added(before) == [{}, {}, {"hits": 1}]
    assert second is first and key2 == key == (hasher.kind, hasher.canonical, 23)
    np.testing.assert_array_equal(first.numpy(),
                                  convert.char_tables(hasher, text).astype(np.int64))


def _rotated(h):
    h.rot_offset = 11
    return h


# (first, second, text of each): two tables the kernels read differently
DISTINCT = {
    "nt seeded and unseeded": (smt.NtHasher(21), smt.NtHasher(21, seed=3), False, False),
    "two nt seeds": (smt.NtHasher(21, seed=3), smt.NtHasher(21, seed=4), False, False),
    "two mul seeds": (smt.MulHasher(21, seed=3), smt.MulHasher(21, seed=4), False, False),
    "mul seeded and unseeded": (smt.MulHasher(21), smt.MulHasher(21, seed=3), False, False),
    "nt and mul": (smt.NtHasher(21), smt.MulHasher(21), False, False),
    "canonical and forward": (smt.NtHasher(21, True), smt.NtHasher(21, False), False, False),
    "text and 2-bit": (smt.MulHasher(21), smt.MulHasher(21), True, False),
    "rot_offset": (smt.NtHasher(21), _rotated(smt.NtHasher(21)), False, False),
}


@pytest.mark.parametrize("case", list(DISTINCT))
def test_each_table_gets_its_own_entry(case):
    """Two hashers of which the kernels would read different tables or keys
    are two uploads; each then finds its own tensor again."""
    a, b, text_a, text_b = DISTINCT[case]
    before = _counts()
    key_a, ta = convert.hasher_tensors(a, "cpu", text_a)
    key_b, tb = convert.hasher_tensors(b, "cpu", text_b)
    assert _added(before)[2] == {"uploads": 2}
    assert tb is not ta
    assert (key_a, ta) == convert.hasher_tensors(a, "cpu", text_a)
    assert (key_b, tb) == convert.hasher_tensors(b, "cpu", text_b)
    assert convert.hasher_tensors(a, "cpu", text_a)[1] is ta
    assert convert.hasher_tensors(b, "cpu", text_b)[1] is tb
    for h, text, t in ((a, text_a, ta), (b, text_b, tb)):
        np.testing.assert_array_equal(t.numpy(), convert.char_tables(h, text).astype(np.int64))


@pytest.mark.parametrize("kind", [smt.NtHasher, smt.MulHasher])
def test_same_table_shares_an_entry(kind):
    """What the kernels do not read of the table, k and the object itself,
    keeps one entry: a hasher of another k and an equal copy hit it."""
    _, t = convert.hasher_tensors(kind(21, True, seed=7), "cpu")
    before = _counts()
    assert convert.hasher_tensors(kind(31, True, seed=7), "cpu")[1] is t
    assert convert.hasher_tensors(kind(21, True, seed=7), "cpu")[1] is t
    assert _added(before) == [{}, {}, {"hits": 2}]


def test_antilex_has_no_table():
    before = _counts()
    assert convert.hasher_tensors(smt.AntiLexHasher(21, True), "cpu") == (
        ("antilex", True, 0), None)
    assert _added(before) == [{}, {}, {}] and not convert._tables


@pytest.mark.parametrize("kind", [smt.NtHasher, smt.MulHasher])
@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "forward"])
def test_alternating_seeded_hashers_match_the_oracle(kind, canonical):
    """Sketches that alternate between two seeded hashers of one (kind,
    canonical, rot_offset) each equal the port's NumPy oracle for their own
    hasher: neither is served the other's table."""
    k, w = 9, 7
    seq = smt.PackedSeqVec.random(6000, np.random.default_rng(11))
    chars = convert.packed_words(seq, "cpu")
    hashers = [kind(k, canonical, seed=s) for s in (101, 202)]
    make = smt.canonical_minimizers if canonical else smt.minimizers
    want = [make(k, w).hasher(h).run_scalar_once(seq) for h in hashers]
    assert list(want[0]) != list(want[1])
    before = _counts()
    for rnd in range(3):
        for h, pos in zip(hashers, want):
            got = backend.sketch(chars, len(seq), k, w, h)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), pos)
    assert _added(before)[2] == {"uploads": 2, "hits": 4}


@pytest.mark.parametrize("kind", [smt.NtHasher, smt.MulHasher])
def test_the_bound_drops_the_oldest(kind):
    """Past TABLES_KEPT entries the oldest goes: it is uploaded again, a
    later one is still found."""
    hashers = [kind(21, seed=s) for s in range(convert.TABLES_KEPT + 1)]
    tensors = [convert.hasher_tensors(h, "cpu")[1] for h in hashers]
    assert len(convert._tables) == convert.TABLES_KEPT
    before = _counts()
    assert convert.hasher_tensors(hashers[1], "cpu")[1] is tensors[1]
    assert convert.hasher_tensors(hashers[-1], "cpu")[1] is tensors[-1]
    assert _added(before)[2] == {"hits": 2}
    again = convert.hasher_tensors(hashers[0], "cpu")[1]
    assert again is not tensors[0] and torch.equal(again, tensors[0])
    assert _added(before)[2] == {"hits": 2, "uploads": 1}
    assert len(convert._tables) == convert.TABLES_KEPT
    before = _counts()
    convert.hasher_tensors(hashers[1], "cpu")  # the oldest now: dropped for hashers[0]
    assert _added(before)[2] == {"uploads": 1}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k,w", [("superkmers", 21, 11), ("open_syncmers", 17, 7)])
def test_resident_records_wait_once_a_record(dev, mode, k, w):
    """24 records already on the card through backend.sketch(..., values=True),
    as the resident cells send them: every plane of a warm call equals the
    plane of a cold-cache call, and the warm pass waits for the card only
    at each record's totals readback, finding the tables kept each time."""
    rng = np.random.default_rng(2026)
    lengths = rng.integers(100_000, 3_000_000, 24)
    records = [(convert.packed_words(smt.PackedSeqVec.from_codes(
        rng.integers(0, 4, int(n), dtype=np.uint8)), dev), int(n)) for n in lengths]
    h = smt.NtHasher(k, canonical=True)
    cold = []
    for chars, n in records:
        convert._tables.clear()
        cold.append(backend.sketch(chars, n, k, w, h, mode, values=True))
    torch.cuda.synchronize(dev)
    before = _counts()
    warm = [backend.sketch(chars, n, k, w, h, mode, values=True) for chars, n in records]
    torch.cuda.synchronize(dev)
    syncs, _, tables = _added(before)
    assert syncs == {"totals readback": len(records)}
    assert tables == {"hits": len(records)}
    for c, g in zip(cold, warm, strict=True):
        assert len(c) == len(g) == (3 if mode == "superkmers" else 2)
        assert c[0].numel() > 0
        for pc, pg in zip(c, g, strict=True):
            assert pc.device.type == pg.device.type == "cuda" and torch.equal(pc, pg)
