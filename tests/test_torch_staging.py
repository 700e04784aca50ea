"""The staged upload of a read matrix (`convert.staged_rows`, `convert.Stager`).

On the CPU: the piece plan covers every byte of a (B, L) matrix once, in
order and in whole rows; a `Stager` on the CPU (the same plan, pool and
ring, plain buffers) gives every byte back, reuses its ring across calls
and holds under many threads at once; `staged_rows` on the CPU is the array
itself, counted as a card's upload would be (`STAGED`, "h2d pinned").

On a card (marked `cuda`; this file imports no JAX, so run it there as
`python -m pytest --noconftest -m cuda tests/test_torch_staging.py -q`):
byte-equal to `torch.from_numpy(x).to("cuda")` at every size and for
read-only and strided arrays, `run_batch` of a matrix equal to its list
route, and back-to-back calls whose callers overwrite their arrays at once
each get their own answer.
"""

from __future__ import annotations

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.utils import profiling

CPUS = len(os.sched_getaffinity(0))
CPU = torch.device("cpu")


def _matrix(rows: int, width: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(0, 4, (rows, width))
    return np.frombuffer(b"ACGT", np.uint8)[codes]


# -- the piece plan ------------------------------------------------------------------------------


@pytest.mark.parametrize("rows,width", [(0, 150), (5, 0), (1, 150), (7, 150), (100, 300),
                                        (872, 150), (1001, 150), (3, 70_000)])
def test_piece_plan_covers_every_row_once(rows, width, monkeypatch):
    """The pieces run over rows 0..rows in order, each non-empty and of
    whole rows, PIECE bytes at most (one row where a row passes it), all
    full but the last; none for a matrix of no bytes. At PIECE = 64 KiB
    (436 rows of 150 B a piece): B = 0, no width, one row, fewer rows than
    a piece, two full pieces, a remainder piece, rows past a piece."""
    monkeypatch.setattr(convert, "PIECE", 64 << 10)
    plan = convert.piece_rows(rows, width)
    if rows * width == 0:
        assert plan == []
        return
    per = max(convert.PIECE // width, 1)
    assert [r0 for r0, _ in plan] == list(range(0, rows, per))
    assert plan[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(0 < r1 - r0 <= per for r0, r1 in plan)
    assert all(r1 - r0 == per for r0, r1 in plan[:-1])
    assert all((r1 - r0) * width <= max(convert.PIECE, width) for r0, r1 in plan)
    covered = np.concatenate([np.arange(r0, r1) for r0, r1 in plan])
    np.testing.assert_array_equal(covered, np.arange(rows))


def test_piece_plan_at_the_read_batch_size():
    """1,000,000 x 150 bp reads: pieces of 111,848 rows (16 MiB), 9 of them."""
    plan = convert.piece_rows(1_000_000, 150)
    assert convert.PIECE == 16 << 20
    assert plan[0] == (0, 111_848) and len(plan) == 9 and plan[-1][1] == 1_000_000


# -- the Stager on the CPU -----------------------------------------------------------------------


def _cases():
    """(name, matrix) of the shapes and layouts a caller may hand over."""
    wide = _matrix(40, 300, 3)
    return [("no rows", _matrix(0, 150, 0)), ("one row", _matrix(1, 150, 1)),
            ("7 rows", _matrix(7, 150, 2)), ("many pieces", _matrix(1001, 150, 4)),
            ("L 300", _matrix(97, 300, 5)),
            ("read-only bytes", np.frombuffer(_matrix(333, 150, 6).tobytes(),
                                              np.uint8).reshape(333, 150)),
            ("strided rows", wide[:, 7:157]), ("every other row", wide[::2])]


@pytest.mark.parametrize("case", [name for name, _ in _cases()])
def test_stager_gives_every_byte_back(case, monkeypatch):
    """A Stager on the CPU, at pieces of 1 KiB (so more pieces than its ring
    holds): the tensor equals the matrix, contiguous and (B, L)."""
    monkeypatch.setattr(convert, "PIECE", 1 << 10)
    x = dict(_cases())[case]
    st = convert.Stager(CPU)
    got = st.upload(x, convert.piece_rows(*x.shape))
    assert got.shape == x.shape and got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), x)
    assert len(st.ring) <= convert.IN_FLIGHT * st.cpus


@pytest.mark.parametrize("pieces", [3, 2 * convert.IN_FLIGHT * CPUS + 1])
def test_stager_reuses_its_ring_across_calls(pieces, monkeypatch):
    """Buffers are made as a call first needs them, as many as its pieces
    up to the ring's size, and kept: a second call takes the same buffers
    and answers its own matrix although the first one's bytes sat in
    them."""
    monkeypatch.setattr(convert, "PIECE", 1 << 10)
    st = convert.Stager(CPU)
    first, second = _matrix(6 * pieces, 150, 7), _matrix(6 * pieces, 150, 8)
    plan = convert.piece_rows(*first.shape)
    assert len(plan) == pieces
    np.testing.assert_array_equal(st.upload(first, plan).numpy(), first)
    held = [s.host.data_ptr() for s in st.ring]
    assert len(held) == min(pieces, convert.IN_FLIGHT * st.cpus)
    np.testing.assert_array_equal(st.upload(second, plan).numpy(), second)
    assert [s.host.data_ptr() for s in st.ring] == held
    assert st.pool is not None


def test_stager_grows_a_buffer_for_a_row_past_a_piece(monkeypatch):
    """A row wider than PIECE is a piece of its own, in a buffer grown to
    hold it; a one-piece matrix runs on the calling thread (no pool)."""
    monkeypatch.setattr(convert, "PIECE", 1 << 10)
    st = convert.Stager(CPU)
    small = _matrix(3, 150, 9)
    np.testing.assert_array_equal(st.upload(small, convert.piece_rows(3, 150)).numpy(), small)
    assert st.pool is None
    wide = _matrix(5, 5000, 10)
    np.testing.assert_array_equal(st.upload(wide, convert.piece_rows(5, 5000)).numpy(), wide)
    assert any(s.host.numel() >= 5000 for s in st.ring)


def test_stager_under_many_threads():
    """More threads than CPUs upload through one Stager at once, with the
    interpreter switching threads often: each gets its own matrix back."""
    st = convert.Stager(CPU)
    threads_n = 2 * CPUS + 3
    errors, done = [], []
    old = sys.getswitchinterval()

    def one(i: int):
        try:
            x = _matrix(50 + i, 150, 100 + i)
            for _ in range(5):
                got = st.upload(x, [(r, min(r + 7, x.shape[0])) for r in range(0, x.shape[0], 7)])
                if not np.array_equal(got.numpy(), x):
                    errors.append(i)
            done.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and sorted(done) == list(range(threads_n))


# -- staged_rows on the CPU ----------------------------------------------------------------------


def test_staged_rows_on_the_cpu_is_the_array():
    """On the CPU the tensor is the caller's array itself (no copy where
    it is contiguous), and a strided one comes back contiguous."""
    x = _matrix(9, 150, 11)
    got = convert.staged_rows(x, "cpu")
    assert got.data_ptr() == x.ctypes.data
    view = _matrix(9, 300, 12)[:, 1:151]
    got = convert.staged_rows(view, "cpu")
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), view)
    with pytest.raises(ValueError, match="uint8"):
        convert.staged_rows(x.astype(np.int16), "cpu")
    with pytest.raises(ValueError, match="1-D"):
        convert.staged_rows(x[0], "cpu")


@pytest.mark.parametrize("rows", [0, 1, 7, 1001])
def test_staged_counts_pieces_workers_and_bytes(rows, monkeypatch):
    """STAGED takes the plan's pieces, the workers that copy them (the
    calling thread for one piece, else as many threads as pieces up to the
    CPUs) and the bytes; BUS_BYTES the bytes as pinned; no sync site."""
    monkeypatch.setattr(convert, "PIECE", 1 << 10)
    x = _matrix(rows, 150, 13)
    pieces = len(convert.piece_rows(rows, 150))
    staged, moved = collections.Counter(profiling.STAGED), collections.Counter(profiling.BUS_BYTES)
    syncs = collections.Counter(profiling.SYNCS)
    convert.staged_rows(x, "cpu")
    assert profiling.STAGED - staged == collections.Counter(
        {"pieces": pieces, "workers": min(CPUS, pieces), "bytes": x.nbytes})
    assert profiling.BUS_BYTES - moved == collections.Counter({"h2d pinned": x.nbytes})
    assert profiling.SYNCS == syncs


def test_staged_counts_go_to_profiled_under_a_span():
    """Under a recording profiler and inside a span, STAGED's counts go to
    PROFILED["staged"] as well."""
    from torch.profiler import ProfilerActivity, profile

    for c in profiling.PROFILED.values():
        c.clear()
    x = _matrix(20, 150, 14)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("run_batch"):
            convert.staged_rows(x, "cpu")
    assert profiling.PROFILED["staged"] == {"pieces": 1, "workers": 1, "bytes": x.nbytes}
    assert profiling.PROFILED["bus_bytes"] == {"h2d pinned": x.nbytes}
    for c in profiling.PROFILED.values():
        c.clear()


# -- on a card -----------------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 7, 100_003])
@pytest.mark.parametrize("width", [150, 300])
def test_staged_rows_equals_a_plain_upload(dev, rows, width):
    """The staged upload is byte-equal to torch.from_numpy(x).to("cuda")."""
    x = _matrix(rows, width, rows + width)
    got = convert.staged_rows(x, dev)
    want = torch.from_numpy(x).to(dev)
    assert got.shape == want.shape and got.device.type == "cuda"
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["read-only bytes", "strided rows", "every other row"])
def test_staged_rows_takes_any_layout_on_the_card(dev, layout):
    """A read-only bytes-backed matrix and two non-contiguous row slices,
    each of several pieces."""
    base = _matrix(200_001, 300, 15)
    x = {"read-only bytes": np.frombuffer(base[:60_000].tobytes(), np.uint8).reshape(60_000, 300),
         "strided rows": base[:, 11:161], "every other row": base[::2]}[layout]
    assert len(convert.piece_rows(*x.shape)) > 1
    got = convert.staged_rows(x, dev)
    assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(x)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_matrix_run_batch_equals_the_list_route_on_the_card(dev, masked):
    """run_batch of a matrix of several pieces (with and without a flags
    matrix) equals the same rows as a list, bit for bit; its upload is
    pinned and blocks nowhere."""
    rows = _matrix(250_001, 150, 16 + masked)
    masks = (np.random.default_rng(18).random(rows.shape) < 0.01).astype(np.uint8) \
        if masked else None
    b = smt.canonical_minimizers(21, 11)
    b.run_batch(rows[:10], device=dev)  # built and warm
    syncs, staged = collections.Counter(profiling.SYNCS), collections.Counter(profiling.STAGED)
    got = b.run_batch(rows, ambiguous=masks, device=dev)
    assert "ascii upload" not in profiling.SYNCS - syncs
    pieces = len(convert.piece_rows(*rows.shape))
    assert (profiling.STAGED - staged)["pieces"] == pieces * (2 if masked else 1)
    want = b.run_batch([r.tobytes() for r in rows],
                       ambiguous=None if masks is None else list(masks), device=dev)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_back_to_back_calls_answer_their_own_matrices(dev):
    """Two calls on different matrices, each caller overwriting its array
    as soon as its call returns (the second call's pieces in the buffers of
    the first's, after a wait on each): each tensor and each run_batch
    holds its own matrix's answer, so nothing is kept for an array across
    calls."""
    shape = (3 * (convert.PIECE // 150) + 1, 150)
    assert len(convert.piece_rows(*shape)) == 4
    first, second = _matrix(*shape, 19), _matrix(*shape, 20)
    want = [first.copy(), second.copy()]
    waits = profiling.SYNCS["staging wait"]
    got = []
    for x in (first, second):
        got.append(convert.staged_rows(x, dev))
        x[:] = ord("N")
    assert profiling.SYNCS["staging wait"] > waits
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(w).to(dev))
    b = smt.canonical_minimizers(21, 11)
    reads = [_matrix(90_001, 150, 21), _matrix(90_001, 150, 22)]
    answers = [b.run_batch(x.copy(), device="cpu") for x in reads]
    for x, answer in zip(reads, answers):
        out = b.run_batch(x, device=dev)
        x[:] = ord("N")
        for g, w in zip(out, answer, strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_staged_rows_under_many_threads_on_the_card(dev):
    """More threads than CPUs stage matrices of three pieces at once: each
    tensor is its own matrix."""
    errors = []

    def one(i: int):
        try:
            x = _matrix(120_000 + i, 300, 200 + i)
            if not torch.equal(convert.staged_rows(x, dev), torch.from_numpy(x).to(dev)):
                errors.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2 * CPUS + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
