"""The bounded-memory CPU spans (ops/spans.py) against one launch and the
JAX package's `chunked.sketch`.

With spans of a few TILEs of windows the seams fall every few thousand
chars: every mode, both strands, with and without an ambiguity mask, on
2-bit DNA (packed and code bytes) and on text, bit-equal to the unchunked
plain path (one `fused_sketch` on a CPU tensor) and to the JAX package's
`chunked.sketch` (its XLA pipeline in chunks, with the one-u32 dedup
seam). One rule (`spans.span_chars`) cuts a sequence for `backend.sketch`
and `backend.sketch_records`: on the CPU, spans of PIPELINE_CHUNK_WINDOWS
windows for inputs of more than that many. Integer outputs: every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import MulHasher, NtHasher
from simd_minimizers_tpu.ops import chunked as jchunked
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, fused, pipeline, spans

TILE = fused.TILE
SKM = pipeline.MODE_SUPERKMERS


def _planes(x):
    xs = x if isinstance(x, tuple) else (x,)
    return [t.numpy().view(np.uint32) if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in xs]


def _assert_equal(got, want):
    for g, p in zip(_planes(got), _planes(want), strict=True):
        np.testing.assert_array_equal(g, p)


def _inputs(n, seed, text=False):
    rng = np.random.default_rng(seed)
    codes = (rng.integers(32, 127, n, dtype=np.uint8) if text
             else rng.integers(0, 4, n, dtype=np.uint8))
    mask = rng.random(n) < 0.005
    mask[2 * TILE - 30:2 * TILE + 50] = True  # a run of flags across the second seam
    return codes, mask


def _one_launch(chars, n, k, w, h, mode, plane, **kw):
    (kind, canonical, rot), tables = convert.hasher_tensors(h, "cpu", kw.get("text", False))
    return fused.fused_sketch(chars, n, k, w, tables, rot, canonical, mode, plane, kind=kind,
                              **kw)


@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dna_chunks_vs_one_launch_and_jax(mode, canonical, masked):
    """2-bit DNA, packed and as code bytes, in chunks of 2 * TILE windows."""
    k, w = (21, 11) if canonical else (15, 8)
    n = 3 * 2 * TILE + 777
    codes, mask = _inputs(n, 7 * k + masked)
    h = smt.NtHasher(k, canonical=canonical)
    plane = convert.ambiguity_plane(mask, n, "cpu") if masked else None
    for byte_codes in (False, True):
        chars = (convert.code_bytes(codes, "cpu") if byte_codes
                 else convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu"))
        got = spans.sketch_long(chars, n, k, w, h, mode, plane, byte_codes=byte_codes,
                                span_chars=2 * TILE + k + w - 2)
        _assert_equal(got, _one_launch(chars, n, k, w, h, mode, plane, byte_codes=byte_codes))
    want = jchunked.sketch(codes, k, w, NtHasher(k, canonical=canonical), mode=mode,
                           ambiguous_np=mask.astype(np.uint8) if masked else None,
                           chunk_windows=2 * TILE)
    _assert_equal(got, want)


@pytest.mark.parametrize("mode", pipeline.MODES)
@pytest.mark.parametrize("masked", [False, True])
def test_text_chunks_vs_one_launch_and_jax(mode, masked):
    """Text bytes with the mul hasher, in chunks of TILE windows."""
    k, w = 7, 5
    n = 4 * TILE + 123
    codes, mask = _inputs(n, 31 + masked, text=True)
    h = smt.MulHasher(k)
    chars = convert.code_bytes(codes, "cpu")
    plane = convert.ambiguity_plane(mask, n, "cpu") if masked else None
    got = spans.sketch_long(chars, n, k, w, h, mode, plane, text=True,
                            span_chars=TILE + k + w - 2)
    _assert_equal(got, _one_launch(chars, n, k, w, h, mode, plane, text=True))
    want = jchunked.sketch(codes, k, w, MulHasher(k), mode=mode,
                           ambiguous_np=mask.astype(np.uint8) if masked else None,
                           chunk_windows=TILE)
    _assert_equal(got, want)


def test_chunk_windows_are_whole_tiles(monkeypatch):
    assert spans.span_chars("cpu", 31) == spans.PIPELINE_CHUNK_WINDOWS + 30
    assert spans.PIPELINE_CHUNK_WINDOWS == 1 << 24 and spans.PIPELINE_CHUNK_WINDOWS % TILE == 0
    assert spans.span_chars("cuda", 31) == spans.SPAN_CHARS == 1 << 29
    for bad in (TILE + 1, 0):
        monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", bad)
        with pytest.raises(ValueError):
            spans.span_chars("cpu", 31)


def _count_launches(monkeypatch):
    """Record the windows of every launch of the plain kernels."""
    windows = []
    real = fused._fused_launch

    def launch(chars, n, k, w, *args, **kw):
        windows.append(n - (k + w - 1) + 1)
        return real(chars, n, k, w, *args, **kw)

    monkeypatch.setattr(fused, "_fused_launch", launch)
    return windows


@pytest.mark.parametrize("mode", [pipeline.MODE_MINIMIZERS, SKM, pipeline.MODE_OPEN_SYNCMERS])
def test_backend_routes_cpu_inputs_in_chunks(mode, monkeypatch):
    """backend.sketch (Builder.run's route) streams a CPU input of more than
    PIPELINE_CHUNK_WINDOWS windows in spans of at most that many windows,
    and one of at most that many in one launch; the result is the same."""
    k, w = 21, 11
    n = 3 * TILE + 500
    codes, mask = _inputs(n, 5)
    seq = smt.PackedSeqVec.from_codes(codes)
    b = smt.canonical_minimizers(k, w)
    b = {SKM: b.super_kmers(), pipeline.MODE_OPEN_SYNCMERS: smt.canonical_open_syncmers(k, w)}.get(
        mode, b)
    amb = None if mode == SKM else mask
    whole = b.run(seq, ambiguous=amb, device="cpu")
    windows = _count_launches(monkeypatch)
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", TILE)
    out = b.run(seq, ambiguous=amb, device="cpu")
    assert windows == [TILE, TILE, TILE, n - (k + w - 1) + 1 - 3 * TILE]
    np.testing.assert_array_equal(out.positions, whole.positions)
    if mode == SKM:
        np.testing.assert_array_equal(out.superkmer_indices, whole.superkmer_indices)
    windows.clear()
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", 4 * TILE)
    np.testing.assert_array_equal(b.run(seq, ambiguous=amb, device="cpu").positions,
                                  whole.positions)
    assert windows == [n - (k + w - 1) + 1]


def test_sketch_records_caps_cpu_spans(monkeypatch):
    """spans.sketch_records on the CPU cuts records into spans of at most
    PIPELINE_CHUNK_WINDOWS windows, whatever span_chars asks for; the
    per-record results are those of one launch each."""
    k, w = 15, 9
    recs = [_inputs(n, n)[0] for n in (3 * TILE + 17, 900, TILE + 300)]
    h = smt.NtHasher(k)
    want = spans.sketch_records(recs, k, w, h, device="cpu")
    windows = _count_launches(monkeypatch)
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", TILE)
    got = spans.sketch_records(recs, k, w, h, device="cpu", span_chars=1 << 29)
    l = k + w - 1
    assert windows == [TILE, TILE, TILE - (l - 1) + 17, 900 - l + 1, TILE, 300 - l + 1]
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    windows.clear()
    got = backend.sketch_records(recs, k, w, h, device="cpu")
    assert len(windows) == 6 and max(windows) == TILE
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)


def _count_tiles(monkeypatch):
    """Record (offset, chars) of every minimizer_tiles call."""
    calls = []
    real = fused.minimizer_tiles

    def tiles(chars, n, *args, **kw):
        calls.append((kw.get("offset", 0), n))
        return real(chars, n, *args, **kw)

    monkeypatch.setattr(fused, "minimizer_tiles", tiles)
    return calls


@pytest.mark.parametrize("past", [0, 1, TILE + 1])
def test_one_span_rule_for_sequences_and_records(past, monkeypatch):
    """backend.sketch and backend.sketch_records cut one masked sequence
    `past` chars beyond the span size (spans.span_chars on the CPU, with
    PIPELINE_CHUNK_WINDOWS lowered to three tiles) at the same windows, and
    give bit-equal results."""
    monkeypatch.setattr(spans, "PIPELINE_CHUNK_WINDOWS", 3 * TILE)
    k, w = 21, 11
    l = k + w - 1
    n = spans.span_chars("cpu", l) + past
    codes, mask = _inputs(n, 11 + past)
    h = smt.NtHasher(k, canonical=True)
    calls = _count_tiles(monkeypatch)
    seq = backend.sketch(convert.packed_words(smt.PackedSeqVec.from_codes(codes), "cpu"), n, k, w,
                         h, ambiguous=convert.ambiguity_plane(mask, n, "cpu"))
    seq_calls = list(calls)
    calls.clear()
    rec = backend.sketch_records([codes], k, w, h, ambiguous=[mask], device="cpu")[0]
    assert calls == seq_calls == ([(0, n)] if not past
                                  else [(0, 3 * TILE + l - 1), (3 * TILE, n - 3 * TILE)])
    np.testing.assert_array_equal(rec, seq.numpy().view(np.uint32))
