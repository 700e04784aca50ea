"""Many records: the port's `backend.sketch_records` and `fused.sketch_records`
on the CPU (the kernels' plain versions) == the JAX package's
`backend.sketch_records` and `fused.sketch_records` (its Pallas kernel in
interpret mode, C=1024) == the NumPy oracle per record: empty, sub-window
and multi-span records, at least 8 small records on the batch route, mask
lists with None entries, and the wave-budget edges of
tests/test_drivers.py.

Integer outputs: tolerance 0. The kernels run the same launches on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import MulHasher, NtHasher
from simd_minimizers_tpu.ops import backend as jbackend
from simd_minimizers_tpu.ops import batch as jbatch
from simd_minimizers_tpu.ops import fused as jfused
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, batch, fused, pipeline

C = 1024
SKM = pipeline.MODE_SUPERKMERS


def _planes(x):
    return list(x) if isinstance(x, tuple) else [x]


def _assert_records(got, want):
    assert len(got) == len(want)
    for i, (g, p) in enumerate(zip(got, want)):
        for gp, pp in zip(_planes(g), _planes(p), strict=True):
            assert gp.dtype == np.uint32
            np.testing.assert_array_equal(gp, pp, err_msg=f"record {i}")


def _want(codes, k, w, h, mode, amb=None):
    empty = np.zeros(0, np.uint32)
    if codes.size < k + w - 1:
        return (empty, empty) if mode == SKM else empty
    sel = oracle.selected_stream(codes, k, w, h, ambiguous=amb)
    if mode == SKM:
        return oracle.collect_and_dedup_with_index(sel)
    if mode in pipeline.SYNCMER_MODES:
        return oracle.collect_syncmers(sel, w, mode == pipeline.MODE_OPEN_SYNCMERS)
    return oracle.collect_and_dedup(sel, skip_sentinel=amb is not None)


def _mixed_records(l, seed):
    rng = np.random.default_rng(seed)
    return [np.zeros(0, np.uint8),                        # empty
            rng.integers(0, 4, l - 1, dtype=np.uint8),    # sub-window
            rng.integers(0, 4, 900, dtype=np.uint8),      # one span
            rng.integers(0, 4, 33_000, dtype=np.uint8),   # several spans
            rng.integers(0, 4, 2500, dtype=np.uint8)]


@pytest.mark.parametrize("mode", pipeline.MODES)
def test_sketch_records_vs_jax(mode):
    """fused.sketch_records: mixed lengths incl. empty, sub-window and
    multi-span records, each equal to the JAX package's and the oracle's."""
    k, w = 7, 5
    recs = _mixed_records(k + w - 1, 0x5EC5)
    got = fused.sketch_records(recs, k, w, smt.NtHasher(k, canonical=True), mode, device="cpu",
                               span_chars=12_000)
    want = jfused.sketch_records(recs, k, w, NtHasher(k, canonical=True), mode=mode, C=C,
                                 span_chars=12_000, interpret=True)
    _assert_records(got, want)
    _assert_records(got, [_want(r, k, w, NtHasher(k, canonical=True), mode) for r in recs])


def test_sketch_records_masks_with_none_entries():
    """Per-record masks (None entries allowed) through the span path and the
    backend; super-k-mers with a mask are refused as in the JAX package."""
    k, w = 5, 7
    h, jh = smt.NtHasher(k, canonical=True), NtHasher(k, canonical=True)
    rng = np.random.default_rng(0xA11B)
    recs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (400, 15_000, 64)]
    ambs = [None, (rng.random(15_000) < 0.01).astype(np.uint8),
            (rng.random(64) < 0.2).astype(np.uint8)]
    got = fused.sketch_records(recs, k, w, h, ambiguous=ambs, device="cpu", span_chars=6000)
    _assert_records(got, jfused.sketch_records(recs, k, w, jh, ambiguous=ambs, C=C,
                                               span_chars=6000, interpret=True))
    _assert_records(got, [_want(r, k, w, jh, "minimizers", a) for r, a in zip(recs, ambs)])
    _assert_records(backend.sketch_records(recs, k, w, h, ambiguous=ambs, device="cpu"),
                    jbackend.sketch_records(recs, k, w, jh, ambiguous=ambs))
    for fn, kw in ((fused.sketch_records, {"device": "cpu"}), (backend.sketch_records,
                                                               {"device": "cpu"})):
        with pytest.raises(AssertionError):
            fn(recs, k, w, h, SKM, ambs, **kw)
    with pytest.raises(AssertionError, match="align"):
        backend.sketch_records(recs, k, w, h, ambiguous=ambs[:2], device="cpu")


def _jax_batch_route(monkeypatch):
    """The JAX package's backend routes as it does on a TPU (batch engine
    and span waves, interpret mode)."""
    monkeypatch.setenv("SMTPU_RECORDS_BATCH_MAX_BP", "1000")
    monkeypatch.setattr(jbackend, "_use_fused", lambda: True)
    monkeypatch.setattr(jbackend, "sketch_batch",
                        functools.partial(jbatch.sketch_batch, interpret=True))
    monkeypatch.setattr(jfused, "sketch_records",
                        functools.partial(jfused.sketch_records, interpret=True, C=C))


@pytest.mark.parametrize("mode", pipeline.MODES)
def test_backend_records_batch_routing(mode, monkeypatch):
    """At least 8 small records take the batch engine, the big one the span
    waves, in any order; equal to the JAX package's routed records."""
    k, w = 7, 5
    l = k + w - 1
    rng = np.random.default_rng(0xBA7C)
    recs = ([rng.integers(0, 4, int(n), dtype=np.uint8) for n in rng.integers(l, 300, 12)]
            + [np.zeros(0, np.uint8), rng.integers(0, 4, l - 1, dtype=np.uint8),
               rng.integers(0, 4, 5000, dtype=np.uint8)])
    recs = [recs[i] for i in rng.permutation(len(recs))]
    calls = []
    real = batch.sketch_batch
    monkeypatch.setattr(batch, "sketch_batch",
                        lambda reads, *a, **kw: calls.append(len(reads)) or real(reads, *a, **kw))
    got = backend.sketch_records(recs, k, w, smt.NtHasher(k, canonical=True), mode,
                                 device="cpu", batch_max_bp=1000)
    assert calls == [12]
    _jax_batch_route(monkeypatch)
    want = jbackend.sketch_records(recs, k, w, NtHasher(k, canonical=True), mode=mode, dna=True)
    _assert_records(got, want)
    _assert_records(got, [_want(r, k, w, NtHasher(k, canonical=True), mode) for r in recs])


def test_backend_records_batch_routing_ambiguous(monkeypatch):
    """Batch-routed small records keep their masks; None entries become
    clean masks for the batch engine."""
    k, w = 5, 7
    rng = np.random.default_rng(0xA3B1)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8)
            for n in rng.integers(40, 300, 10)] + [rng.integers(0, 4, 4000, dtype=np.uint8)]
    ambs = [(rng.random(r.size) < 0.05).astype(np.uint8) if i % 2 else None
            for i, r in enumerate(recs)]
    got = backend.sketch_records(recs, k, w, smt.NtHasher(k, canonical=True), ambiguous=ambs,
                                 device="cpu", batch_max_bp=1000)
    _jax_batch_route(monkeypatch)
    _assert_records(got, jbackend.sketch_records(recs, k, w, NtHasher(k, canonical=True),
                                                 ambiguous=ambs, dna=True))


@pytest.mark.parametrize("mode", ["minimizers", "superkmers"])
def test_sketch_records_wave_budget_edges(mode, monkeypatch):
    """A budget smaller than one launch (every launch flushes the one
    before: the eager schedule), 0, and one that holds all: one result."""
    k, w = 7, 5
    rng = np.random.default_rng(0xA3E)
    recs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (5000, 33_000, 900, 12_000)]
    h = smt.NtHasher(k, canonical=True)
    want = jfused.sketch_records(recs, k, w, NtHasher(k, canonical=True), mode=mode, C=C,
                                 span_chars=12_000, interpret=True)
    flushes = []
    real = fused._LaunchWave.flush

    def count(self):
        flushes.append(len(self.wave))
        real(self)

    monkeypatch.setattr(fused._LaunchWave, "flush", count)
    launches = sum(len(fused.span_bounds(r.size, k + w - 1, 12_000)) for r in recs)
    for budget, widest in ((1, 1), (0, 1), (4 << 30, launches)):
        flushes.clear()
        got = fused.sketch_records(recs, k, w, h, mode, device="cpu", span_chars=12_000,
                                   wave_bytes=budget)
        _assert_records(got, want)
        assert sum(flushes) == launches and max(flushes) == widest


def test_records_text_and_probe():
    """Text records (dna=False, or probed) take the kernel's text input;
    2-bit records probe as DNA."""
    k, w = 7, 5
    rng = np.random.default_rng(3)
    recs = [rng.integers(32, 127, 3000, dtype=np.uint8), rng.integers(0, 4, 2000, dtype=np.uint8)]
    jh = MulHasher(k)
    h = convert.hasher_from(jh)
    got = fused.sketch_records(recs, k, w, h, device="cpu", span_chars=1200)
    _assert_records(got, [_want(r, k, w, jh, "minimizers") for r in recs])
    _assert_records(fused.sketch_records(recs[:1], k, w, h, dna=False, device="cpu"), got[:1])
