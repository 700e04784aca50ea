"""NumPy scalar oracle: the reference's semantics, written for clarity.

The port's own copy of `simd_minimizers_tpu/ops/oracle.py`, trimmed to what
the port uses (`Builder.run_scalar`) and the single-window definition
`one_minimizer`; the CPU tests hold it equal to the JAX package's. It
mirrors the reference crate's observable behavior:

- window minima compare only the TOP 16 BITS of each 32-bit kmer hash,
  ties broken towards the leftmost (or, for the canonical right-arm,
  rightmost) position (the crate's src/sliding_min.rs:104-106,190-192 and
  src/minimizers.rs:22-28).
- a window of l = w+k-1 chars is "canonical" iff strictly more than half of
  its chars have bit 1 set (T/G for 2-bit codes; the raw byte for text);
  l must be odd (the crate's src/canonical.rs:12-31).
- canonical minimizer = leftmost min if canonical else rightmost min
  (the crate's src/minimizers.rs:117-128).
- adjacent equal positions are deduplicated; with ambiguous-window skipping
  the SKIPPED sentinel is dropped *after* the adjacent comparison
  (the crate's src/intrinsics/dedup.rs:127-159).
- closed syncmers: windows whose min is the first or last kmer; open:
  the exact middle kmer (w odd) (the crate's src/syncmers.rs:112-120).
- super-kmer index: for each deduplicated minimizer, the first window index
  where it became minimal (the crate's src/collect.rs:106-110).
"""

from __future__ import annotations

import numpy as np

from ..hashers import KmerHasher
from ..utils.bits import SKIPPED, VAL_MASK


def _window_view(a: np.ndarray, w: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(a, w)


def window_lr_min(hashes: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-window (leftmost, rightmost) positions of the minimal top-16 hash.

    Returns two uint32 arrays of length ``len(hashes) - w + 1`` holding
    absolute kmer indices.
    """
    hv = (hashes & VAL_MASK).astype(np.uint32)
    nw = len(hv) - w + 1
    if nw <= 0:
        return np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.uint32)
    # per-window argmin in row chunks, so the (nw, w) view's argmin copies
    # stay bounded at large w
    chunk = max(1, (1 << 25) // max(w, 1))
    lpos = np.empty(nw, dtype=np.int64)
    rpos = np.empty(nw, dtype=np.int64)
    for s in range(0, nw, chunk):
        e = min(s + chunk, nw)
        wins = _window_view(hv[s : e + w - 1], w)  # (e - s, w)
        lpos[s:e] = wins.argmin(axis=1)  # first occurrence = leftmost
        rpos[s:e] = w - 1 - wins[:, ::-1].argmin(axis=1)  # last = rightmost
    base = np.arange(nw, dtype=np.uint32)
    return (base + lpos.astype(np.uint32)), (base + rpos.astype(np.uint32))


def canonical_window_flags(codes: np.ndarray, l: int) -> np.ndarray:
    """True where the l-char window has a strict majority of T/G chars."""
    assert l % 2 == 1, f"window length l={l} must be odd to determine strand"
    tg = ((codes >> 1) & 1).astype(np.int64)
    cnt = np.cumsum(np.concatenate([[0], tg]))
    win = cnt[l:] - cnt[:-l]
    return (2 * win) > l


def ambiguous_window_mask(ambiguous: np.ndarray, l: int) -> np.ndarray:
    """True where the l-char window contains any ambiguous base."""
    amb = ambiguous.astype(np.int64)
    cnt = np.cumsum(np.concatenate([[0], amb]))
    return (cnt[l:] - cnt[:-l]) > 0


def selected_stream(
    codes: np.ndarray,
    k: int,
    w: int,
    hasher: KmerHasher,
    ambiguous: np.ndarray | None = None,
) -> np.ndarray:
    """The per-window minimizer-position stream (before collection).

    One uint32 per window: the absolute position of that window's minimizer
    (strand-selected for canonical hashers), or SKIPPED for ambiguous
    windows.
    """
    hashes = hasher.hash_kmers_np(codes)
    lpos, rpos = window_lr_min(hashes, w)
    if hasher.canonical:
        flags = canonical_window_flags(codes, k + w - 1)
        sel = np.where(flags, lpos, rpos).astype(np.uint32)
    else:
        sel = lpos
    if ambiguous is not None and sel.size:
        ambi = ambiguous_window_mask(ambiguous, k + w - 1)
        sel = np.where(ambi, SKIPPED, sel).astype(np.uint32)
    return sel


def collect_and_dedup(sel: np.ndarray, skip_sentinel: bool = False) -> np.ndarray:
    """Dedup adjacent equal positions; optionally drop SKIPPED afterwards."""
    if sel.size == 0:
        return sel.astype(np.uint32)
    keep = np.ones(sel.size, dtype=bool)
    keep[1:] = sel[1:] != sel[:-1]
    if skip_sentinel:
        keep &= sel != SKIPPED
    return sel[keep].astype(np.uint32)


def collect_and_dedup_with_index(sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dedup'd positions plus the window index of each super-k-mer start."""
    if sel.size == 0:
        return sel.astype(np.uint32), sel.astype(np.uint32)
    keep = np.ones(sel.size, dtype=bool)
    keep[1:] = sel[1:] != sel[:-1]
    idx = np.flatnonzero(keep).astype(np.uint32)
    return sel[keep].astype(np.uint32), idx


def collect_syncmers(sel: np.ndarray, w: int, open_: bool) -> np.ndarray:
    """Window indices that are (closed|open) syncmers."""
    if open_:
        assert w % 2 == 1, "open syncmers require odd w"
    j = np.arange(sel.size, dtype=np.uint32)
    if open_:
        is_sync = sel == j + np.uint32(w // 2)
    else:
        is_sync = (sel == j) | (sel == j + np.uint32(w - 1))
    is_sync &= sel != SKIPPED
    return j[is_sync]


def one_minimizer(window_codes: np.ndarray, hasher: KmerHasher) -> int:
    """Leftmost position of the minimal top-16 hash in one window
    (the crate's src/minimizers.rs:22-28)."""
    h = hasher.hash_kmers_np(window_codes) & VAL_MASK
    return int(h.argmin())
