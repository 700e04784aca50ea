"""The span driver: where a sequence is cut into launches, the waves that
queue and harvest the launches, and the exact merge of the pieces' results
at their seams.

Counterpart of the JAX package's drivers in `simd_minimizers_tpu/ops/fused.py`
(`_LaunchWave`, `sketch_long`, `sketch_records`), of its bounded CPU route
(`ops/chunked.py`) and of the seam merge in its `parallel/multihost.py`. It
sits between the entry points (`ops/backend.py`, `parallel/`) and the
kernel wrappers (`ops/fused.py`), and imports only downward.

One rule cuts a sequence (`span_chars`): up to the span size it is one
launch, past it spans of that size. On a card a span holds SPAN_CHARS
chars. On the CPU it owns PIPELINE_CHUNK_WINDOWS windows, because the plain
version of the kernels builds a launch's whole lane matrix at once, about
100 bytes a char at its peak. Both `sketch_long` and `sketch_records` take
the rule, which a `span_chars=` keyword can only lower.

The drivers keep the JAX package's contracts (spans overlap by l - 1 chars
and merge at their seams exactly, syncmer spans concatenate, positions are
u32) but not its TPU design: the input is uploaded once and every span is
a view of it that starts at a multiple of TILE windows (so on a byte of the
2-bit stream and of the 1-bit plane), launches need no grid buckets, and a
record's results come down through pinned host memory on a side stream
while the next launches run.

A piece computed windows [starts[i], starts[i + 1]) with no predecessor
for its first window; `merge_adjacent_shards` re-evaluates the two windows
at each seam on the host (O(l) work each) to decide whether the oracle's
adjacent dedup drops that first value. The pieces may be numpy arrays or
tensors holding u32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..utils.bits import SKIPPED
from ..utils.device import require_cuda
from ..utils.profiling import count_bytes, count_sync, span, stage
from . import device_values, fused, oracle, pipeline

SPAN_CHARS = 1 << 29  # chars per span on a card (the JAX package's)
# windows per span on the CPU (the JAX package's chunk); read at call time
PIPELINE_CHUNK_WINDOWS = 1 << 24
MAX_SEQUENCE_CHARS = 1 << 32  # chars of one sequence: positions are u32
_MASK32 = 0xFFFF_FFFF


def span_chars(device: torch.device | str, l: int) -> int:
    """Chars of one launch over a sequence of windows of l chars on
    `device`: SPAN_CHARS on a card, PIPELINE_CHUNK_WINDOWS windows (a
    positive multiple of fused.TILE) on the CPU."""
    if torch.device(device).type != "cpu":
        return SPAN_CHARS
    if PIPELINE_CHUNK_WINDOWS <= 0 or PIPELINE_CHUNK_WINDOWS % fused.TILE:
        raise ValueError(f"PIPELINE_CHUNK_WINDOWS={PIPELINE_CHUNK_WINDOWS} is not a positive "
                         f"multiple of {fused.TILE} windows")
    return PIPELINE_CHUNK_WINDOWS + l - 1


def _span_limit(device: torch.device | str, l: int, asked: int | None) -> int:
    """`span_chars(device, l)`, lowered to `asked` chars where given."""
    rule = span_chars(device, l)
    return rule if asked is None else min(asked, rule)


def span_bounds(n: int, l: int, span_chars: int) -> list[tuple[int, int]]:
    """(first window, chars) of each launch over a sequence of n chars: one
    launch if n <= span_chars, else spans of at most span_chars chars that
    overlap by l - 1, each owning a multiple of TILE windows (the last
    fewer), so each starts on a byte of the 2-bit stream and of the 1-bit
    plane. The seam merge makes the result independent of the split."""
    nw = n - l + 1
    if nw <= 0:
        return []
    if n <= span_chars:
        return [(0, n)]
    step = max((span_chars - (l - 1)) // fused.TILE, 1) * fused.TILE
    return [(s, min(s + step, nw) - 1 + l - s) for s in range(0, nw, step)]


def check_sequence_length(n: int) -> None:
    if n >= MAX_SEQUENCE_CHARS:  # the JAX package's check (sketch_long)
        raise AssertionError("positions are u32: 2^32 chars max per sequence")


class LaunchWave:
    """Launches queued without a host sync and harvested in waves.

    Counterpart of the JAX package's `_LaunchWave`: a wave is flushed before
    a launch that would take its device footprint past `budget` bytes or
    make it 129 launches, so in-flight scratch stays bounded; a flush
    fetches every launch's total in one stacked copy and hands each
    harvested result (device tensors) to `sink(key, result)`. A budget of 0
    is the eager schedule: each launch is harvested before the next one.
    """

    MAX_LAUNCHES = 128

    def __init__(self, mode: str, sink, budget: int):
        self.mode = mode
        self.sink = sink
        self.budget = budget
        self.wave = []  # (key, handles)
        self.bytes = 0

    def launch(self, key, chars: torch.Tensor, n: int, k: int, w: int, tables, rot: int,
               canonical: bool, ambiguous: torch.Tensor | None = None, **kw) -> None:
        """Queue `fused._fused_launch` of the first n chars of `chars` in the
        wave's mode under `key` (`kw`: minimizer_tiles' keywords), after a
        flush if needed. Until its harvest a launch holds its scratch and, at
        most as large, its output, per plane."""
        windows = -(-max(n - (k + w - 1) + 1, 0) // fused.TILE) * fused.TILE
        footprint = 2 * 4 * windows * (2 if self.mode == pipeline.MODE_SUPERKMERS else 1)
        if self.wave and (self.bytes + footprint > self.budget
                          or len(self.wave) >= self.MAX_LAUNCHES):
            self.flush()
        with stage("kernels"):
            self.wave.append((key, fused._fused_launch(chars, n, k, w, tables, rot, canonical,
                                                       self.mode, ambiguous, **kw)))
        self.bytes += footprint

    def flush(self) -> None:
        if not self.wave:
            return
        with stage("kernels"), span("totals readback"):
            count_sync("wave totals")
            count_bytes("d2h pageable", 4 * len(self.wave))
            totals = torch.stack([h[2][-1] for _, h in self.wave]).tolist()
        for (key, handles), cnt in zip(self.wave, totals):
            with stage("kernels"):
                res = fused._fused_harvest(handles, self.mode, cnt)
            self.sink(key, res)
        self.wave.clear()
        self.bytes = 0


class _SeamChars:
    """Chars of a buffer as the seam merge reads them: `view[a:b]` is a
    uint8 numpy array of chars [a, b) of `buf` (a numpy array or a tensor
    on any device, copied to the host): the 0/1 flags of a 1-bit plane
    (`per` = 8), the 2-bit codes of a 2-bit stream (4), or the bytes (1),
    of which code bytes keep their low two bits as the kernel does."""

    def __init__(self, buf, per: int, text: bool = False):
        self.buf, self.per, self.text = buf, per, text

    def __getitem__(self, sl: slice) -> np.ndarray:
        a, b = sl.start, sl.stop
        raw = self.buf[a // self.per:-(-b // self.per)]
        if isinstance(raw, torch.Tensor):
            with span("seam chars"):
                count_sync("seam chars")
                count_bytes("d2h pageable", raw.numel())
                raw = raw.cpu().numpy()
        else:
            raw = np.asarray(raw, np.uint8)
        if self.per == 1:
            return raw if self.text else raw & 3
        bits = np.unpackbits(raw, bitorder="little")
        vals = bits if self.per == 8 else bits[0::2] | bits[1::2] << 1
        return vals[a % self.per:a % self.per + b - a]


def concat(parts):
    """One array of the parts: torch.cat for tensors, else np.concatenate."""
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def seam_window_sel(codes_np, k, w, hasher, win: int, ambiguous_np=None) -> int:
    """sel value of ONE global window (host-side, O(l) work). `codes_np` and
    `ambiguous_np` are read only as `x[win:win + l]`."""
    l = k + w - 1
    if ambiguous_np is not None and bool(np.any(ambiguous_np[win : win + l])):
        return int(SKIPPED)
    sel = oracle.selected_stream(codes_np[win : win + l], k, w, hasher)
    return int(sel[0]) + win


def merge_adjacent_shards(parts, starts, codes_np, k, w, hasher,
                          ambiguous_np=None, aux=None):
    """Merge per-shard dedup'd minimizer outputs with EXACT seam semantics.

    Each shard computed windows [starts[i], starts[i+1]) with prev=INVALID
    at its first window, so its first output must be dropped iff the
    oracle's adjacent dedup would have dropped window starts[i]: its sel
    equals the previous (global) window's sel. With skip-ambiguous the
    last *output* of the previous shard is not necessarily the previous
    window's sel (trailing SKIPPED runs), so both seam windows are
    re-evaluated directly (O(l) each). `aux` optionally carries a parallel
    plane (super-k-mer indices) dropped in lockstep — the first window
    index of a seam-straddling run is the earlier shard's, matching
    the crate's src/collect.rs:106-110.
    """
    out = [parts[0]]
    aux_out = [aux[0]] if aux is not None else None
    for i in range(1, len(parts)):
        p = parts[i]
        drop = 0
        if len(p):
            s = int(starts[i])
            w0 = seam_window_sel(codes_np, k, w, hasher, s, ambiguous_np)
            if w0 != int(SKIPPED) and int(p[0]) & _MASK32 == w0:
                wprev = seam_window_sel(codes_np, k, w, hasher, s - 1, ambiguous_np)
                drop = 1 if w0 == wprev else 0
        out.append(p[drop:])
        if aux is not None:
            aux_out.append(aux[i][drop:])
    if aux is not None:
        return concat(out), concat(aux_out)
    return concat(out)


def merge(parts, starts, mode: str, k: int, w: int, hasher, codes, ambiguous=None):
    """One sequence's result from the results of its pieces (spans or
    shards, in order, each the pair (positions, indices) for super-k-mers)
    that start at windows `starts`: syncmer window indices concatenate (the
    pieces own disjoint window ranges); the others drop a piece's first
    value where the seam dedups it (`merge_adjacent_shards`), with the index
    plane of super-k-mers in lockstep. `codes` and `ambiguous` are read as
    `x[a:b]` around each seam."""
    if len(parts) == 1:
        return parts[0]
    if mode in pipeline.SYNCMER_MODES:
        return concat(parts)
    if mode == pipeline.MODE_SUPERKMERS:
        return merge_adjacent_shards([p[0] for p in parts], starts, codes, k, w, hasher,
                                     ambiguous, aux=[p[1] for p in parts])
    return merge_adjacent_shards(parts, starts, codes, k, w, hasher, ambiguous)


def _submit_spans(wave: LaunchWave, key, chars: torch.Tensor, n: int,
                  plane: torch.Tensor | None, per: int, limit: int, k: int, w: int,
                  tables, rot: int, canonical: bool, **kw) -> list[int]:
    """Queue on `wave`, under `key`, one launch per span of a sequence of n
    chars (`span_bounds` at `limit` chars): a view of `chars` (`per` chars
    per byte) and of the 1-bit `plane`, launched with its first char as the
    offset (`kw`: minimizer_tiles' keywords). Returns the spans' first
    windows."""
    bounds = span_bounds(n, k + w - 1, limit)
    for s, m in bounds:
        sub = convert.span(chars, s, s + m, per)
        amb = None if plane is None else convert.span(plane, s, s + m, 8)
        wave.launch(key, sub, m, k, w, tables, rot, canonical, amb, offset=s, **kw)
    return [s for s, _ in bounds]


def sketch_long(chars: torch.Tensor, n: int, k: int, w: int, hasher,
                mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None, *,
                text: bool = False, byte_codes: bool = False, span_chars: int | None = None,
                wave_bytes: int = 0):
    """`fused.fused_sketch` of a sequence of up to 2^32 chars: one launch up
    to the span size (`span_chars(chars.device, l)`, lowered to the keyword
    `span_chars` where given), past it spans of that size (`span_bounds`)
    that are views of `chars` and of the plane `ambiguous`, each launched
    with its first char as the offset, then merged at the seams (`merge`).
    Results stay on chars.device as int32 tensors holding u32 bits.
    `wave_bytes` is the launch wave's budget (0: eager, each span harvested
    before the next is launched)."""
    check_sequence_length(n)
    l = k + w - 1
    (kind, canonical, rot), tables = convert.hasher_tensors(hasher, chars.device, text)
    kw = {"text": text, "kind": kind, "byte_codes": byte_codes}
    limit = _span_limit(chars.device, l, span_chars)
    if n <= limit or n < l:
        with span("kernels"):
            return fused.fused_sketch(chars, n, k, w, tables, rot, canonical, mode, ambiguous,
                                      **kw)
    per = 1 if text or byte_codes else 4
    parts = []
    wave = LaunchWave(mode, lambda _key, res: parts.append(res), wave_bytes)
    starts = _submit_spans(wave, None, chars, n, ambiguous, per, limit, k, w, tables, rot,
                           canonical, **kw)
    wave.flush()
    return merge(parts, starts, mode, k, w, hasher, _SeamChars(chars, per, text),
                 None if ambiguous is None else _SeamChars(ambiguous, 8))


def value_length(k: int, w: int, mode: str) -> int:
    """Chars of the value at each answer of a sketch in `mode`: the k-mer at
    a minimizer's position, the (k + w - 1)-mer at a syncmer's window index
    (the crate's `Output` length, src/lib.rs:439-447)."""
    return k + w - 1 if mode in pipeline.SYNCMER_MODES else k


def check_values(k: int, w: int, mode: str, text: bool) -> None:
    """Raise NotImplementedError where a sketch's values have no route:
    text (8-bit chars) and values of more than 32 chars (they are u64)."""
    if text or value_length(k, w, mode) > 32:
        raise NotImplementedError(
            f"values=True covers 2-bit values of at most 32 chars (k of minimizers and "
            f"super-k-mers, k + w - 1 of syncmers), not {mode} of "
            f"{'text' if text else '2-bit DNA'} at k={k}, w={w} (Output computes the others)")


def with_values(res, chars: torch.Tensor, length: int, canonical: bool,
                byte_codes: bool = False):
    """`res` (positions or window indices, or (positions, first-window
    indices)) with one more plane behind it: the 2-bit value of the
    `length`-mer (at most 32 chars; `value_length`) at each of the first
    plane's positions of the sequence in `chars`, canonical the least of the
    forward and the reverse complement value, as an int64 tensor holding the
    u64 bits. On a card one `kmer_values` launch computes it from the
    positions tensor as the sketch left it, on the current stream: no host
    sync and no upload. On the CPU the plain version takes the positions in
    blocks of PIPELINE_CHUNK_WINDOWS, which bounds its memory as the CPU's
    spans bound the sketch's."""
    pos = res[0] if isinstance(res, tuple) else res
    block = PIPELINE_CHUNK_WINDOWS if chars.device.type == "cpu" else pos.numel()
    with span("values"):
        vals = [_u64(device_values.kmer_values_limbs(chars, pos[s:s + block], length, canonical,
                                                     byte_codes))
                for s in range(0, max(pos.numel(), 1), max(block, 1))]
        vals = vals[0] if len(vals) == 1 else torch.cat(vals)
    return (*res, vals) if isinstance(res, tuple) else (res, vals)


def _u64(limbs: torch.Tensor) -> torch.Tensor:
    """(m, 1 or 2) u32 limbs, low first, as int64 holding the u64 values."""
    if limbs.shape[1] == 2:  # the little-endian u64
        return limbs.view(torch.int64).view(-1)
    return limbs[:, 0].to(torch.int64) & 0xFFFF_FFFF


def record_masks(records, ambiguous, mode: str) -> list:
    """The per-record masks as a list aligned with `records` (None entries
    allowed), with the JAX package's AssertionErrors for a list of another
    length and for super-k-mers with a mask."""
    masks = list(ambiguous) if ambiguous is not None else [None] * len(records)
    if len(masks) != len(records):
        raise AssertionError("ambiguous must align with records")
    pipeline.assert_no_superkmer_ambiguity(mode, any(a is not None for a in masks))
    return masks


def sketch_records(records, k: int, w: int, hasher, mode: str = pipeline.MODE_MINIMIZERS,
                   ambiguous=None, *, dna: bool | None = None,
                   device: torch.device | str = "cuda", span_chars: int | None = None,
                   wave_bytes: int = 4 << 30):
    """Per-record results (positions, or (positions, super-k-mer indices);
    record-local np.uint32; empty below one window) of many sequences of
    uint8 codes (2-bit codes if `dna`, text bytes if not; None probes each
    record), with the per-record masks `ambiguous` (None entries allowed).

    Each record is uploaded once as bytes and cut by the rule of
    `sketch_long` (`span_chars(device, l)`, lowered to the keyword where
    given); the launches of all records go through one `LaunchWave` of
    `wave_bytes` (default 4 GiB, the JAX package's
    SMTPU_RECORDS_WAVE_BYTES), and each harvested span comes down through
    pinned host memory on a side stream while the next launches run.
    Bit-identical to sketching each record alone.
    """
    masks = record_masks(records, ambiguous, mode)
    l = k + w - 1
    nrec = len(records)
    device = require_cuda(device)
    limit = _span_limit(device, l, span_chars)
    copies = torch.cuda.Stream(device) if device.type == "cuda" else None
    rec_parts = [[] for _ in range(nrec)]
    wave = LaunchWave(mode, lambda ri, res: rec_parts[ri].append(convert.Download(res, copies)),
                      wave_bytes)
    tables_for = {}
    starts = [[] for _ in range(nrec)]
    texts = [False] * nrec
    for ri, rec in enumerate(records):
        with span("record probe"):
            codes = np.asarray(rec, dtype=np.uint8)
            n = codes.shape[0]
            check_sequence_length(n)
            if n >= l:
                texts[ri] = not (dna if dna is not None else convert.is_dna(codes))
        if n < l:
            continue
        text = texts[ri]
        if text not in tables_for:
            tables_for[text] = convert.hasher_tensors(hasher, device, text)
        (kind, canonical, rot), tables = tables_for[text]
        chars = convert.code_bytes(codes, device)
        plane = None if masks[ri] is None else convert.ambiguity_plane(masks[ri], n, device)
        starts[ri] = _submit_spans(wave, ri, chars, n, plane, 1, limit, k, w, tables, rot,
                                   canonical, text=text, kind=kind, byte_codes=not text)
    wave.flush()
    empty = np.zeros(0, np.uint32)
    out = []
    with stage("seam merge"):
        for ri, rec in enumerate(records):
            if not rec_parts[ri]:
                out.append((empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty)
                continue
            out.append(merge([d.result() for d in rec_parts[ri]], starts[ri], mode, k, w, hasher,
                             _SeamChars(rec, 1, texts[ri]), masks[ri]))
    return out
