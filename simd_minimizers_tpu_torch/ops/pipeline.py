"""The plain PyTorch version of the minimizer kernel.

Counterpart of `simd_minimizers_tpu/ops/pipeline.py` for the port's slice
(2-bit DNA, packed or one code per byte, or text bytes; the nt, mul and
antilex hashers; minimizers, super-k-mers, closed and open syncmers, each
with or without an ambiguity mask): the same lane matrix with l - 1 char halos, doubling folds for the
k-mer hash (nt and mul as one fold over per-char value tables,
convert.char_tables), the T/G count and the ambiguous count, packed
(top16 | column) sliding minima, strand blend, SKIPPED windows, and the
keep rule of each mode. It compacts with a mask select
instead of the TPU butterfly. It runs on any device; the CPU tests use it,
and on the card it is what the CUDA kernel (`ops/fused.py`) is held
against.

u32 values ride in int64 tensors (see ops/layout.py); positions and window
indices (n < 2^31 per call) plus a u32 `offset` come out as int32 tensors
holding u32 bits.
"""

from __future__ import annotations

import torch

from ..utils.bits import INVALID as _INVALID_NP
from ..utils.bits import SKIPPED as _SKIPPED_NP
from .layout import build_lane_matrix, window_min_cols_packed, windowed_sum, windowed_xor

INVALID = int(_INVALID_NP)
SKIPPED = int(_SKIPPED_NP)  # the sel of a window that holds an ambiguous base
TOP16 = 0xFFFF_0000
MASK32 = 0xFFFF_FFFF

MODE_MINIMIZERS = "minimizers"
MODE_SUPERKMERS = "superkmers"
MODE_CLOSED_SYNCMERS = "closed_syncmers"
MODE_OPEN_SYNCMERS = "open_syncmers"
MODES = (MODE_MINIMIZERS, MODE_SUPERKMERS, MODE_CLOSED_SYNCMERS, MODE_OPEN_SYNCMERS)
SYNCMER_MODES = (MODE_CLOSED_SYNCMERS, MODE_OPEN_SYNCMERS)
HASHER_KINDS = ("nt", "mul", "antilex")  # nt and mul: one fold over per-char tables


def assert_no_superkmer_ambiguity(mode: str, has_ambiguity: bool) -> None:
    """Super-k-mers with an ambiguity mask cannot be expressed in the
    reference's public API; the port's entry points that the JAX package
    guards with it (Builder.run, Builder.run_batch, sketch_records) reject
    the combination as it does (copy of
    `simd_minimizers_tpu.ops.pipeline.assert_no_superkmer_ambiguity`,
    raising its AssertionError even under `python -O`). Below them the
    combination runs: SKIPPED is dropped after the dedup, as for
    minimizers, and the batch engine depends on it for its padding."""
    if mode == MODE_SUPERKMERS and has_ambiguity:
        raise AssertionError("super-k-mers cannot be combined with an ambiguity mask "
                             "(unrepresentable in the reference, src/lib.rs:498-503)")


def syncmer_offsets(mode: str, w: int) -> tuple[int, int]:
    """(lo, hi): a syncmer window gw is kept where its sel is gw + lo or
    gw + hi (closed: the first or last k-mer; open: the middle one)."""
    return (0, w - 1) if mode == MODE_CLOSED_SYNCMERS else (w // 2, w // 2)

# Lane geometry: C owned windows per row (halo overhead (l - 1) / C).
DEFAULT_C = 4096


def _rotl(x: torch.Tensor, r) -> torch.Tensor:
    """Rotate-left of u32 values held in int64, by r in 0..31 (int or
    tensor). x >> 32 is 0 for x < 2^32, so r = 0 needs no special case."""
    return ((x << r) | (x >> (32 - r))) & MASK32


def _local_pos(R: int, S: int, C: int, device) -> torch.Tensor:
    """(R, S) int64 grid of chunk-local positions r * C + j."""
    r = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(S, dtype=torch.int64, device=device)[None, :]
    return r * C + j


def unpack_2bit(words: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 codes of the first n bases of a 2-bit byte stream."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=words.device)
    return ((words[:, None] >> shifts) & 3).reshape(-1)[:n]


def unpack_chars(chars: torch.Tensor, n: int, text: bool, byte_codes: bool = False
                 ) -> torch.Tensor:
    """uint8 codes of the first n chars: the raw bytes of text, the low two
    bits of code bytes, or the 2-bit codes of a 2-bit byte stream."""
    if text:
        return chars[:n]
    return chars[:n] & 3 if byte_codes else unpack_2bit(chars, n)


def u32_bits(values: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(values + offset) mod 2^32 as int32 holding the u32 bits."""
    v = (values.to(torch.int64) + offset) & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 0/1 flags of the first n bases of a 1-bit plane (base i at bit
    i % 8 of byte i // 8; convert.ambiguity_plane)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).reshape(-1)[:n]


def nt_like_kmer_hashes_2d(vals, comp_vals, k: int, rot_offset: int, canonical: bool, C: int):
    """XOR-rolling k-mer hashes on the lane matrix.

    vals / comp_vals: (R, S) int64 per-position table values of the code
    and of its complement. Returns (R, S - k + 1) int64 u32 hashes of the
    k-mers starting at each local position (XOR the reverse-complement
    k-mer's hash when canonical).
    """
    R, S = vals.shape
    p = _local_pos(R, S, C, vals.device)
    u = _rotl(vals, (p + rot_offset) % 32)
    X = windowed_xor(u, k)
    i = _local_pos(R, S - k + 1, C, vals.device) % 32
    h = _rotl(X, (32 - i) % 32)
    if canonical:
        # char at local pos p contributes rotl(T[comp(s[p])], (i + k - 1 - p) + off)
        ur = _rotl(comp_vals, (k - 1 + rot_offset - p) % 32)
        h = h ^ _rotl(windowed_xor(ur, k), i)
    return h


def antilex_kmer_hashes_2d(M: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """~ of the first J = min(k, 16) chars & 3 packed MSB-first, (R, S - k + 1)
    int64; canonical XORs in the same of the reverse complement, whose first
    J chars are the complemented last J chars of the k-mer, reversed."""
    nk = M.shape[1] - k + 1
    c = M.to(torch.int64) & 3
    la = torch.zeros(M.shape[0], nk, dtype=torch.int64, device=M.device)
    for j in range(min(k, 16)):
        la |= c[:, j : j + nk] << (30 - 2 * j)
    if not canonical:
        return ~la & MASK32
    cc = c ^ 2
    ra = torch.zeros_like(la)
    for j in range(min(k, 16)):
        ra |= cc[:, k - 1 - j : k - 1 - j + nk] << (30 - 2 * j)
    return la ^ ra  # == ~la ^ ~ra


def kmer_hashes_2d(M: torch.Tensor, tables: torch.Tensor | None, k: int, rot_offset: int,
                   canonical: bool, C: int, kind: str = "nt") -> torch.Tensor:
    """k-mer hashes of the (R, S) char matrix M (2-bit codes or text bytes):
    antilex, or the nt / mul fold over the int64 (2, nchars) per-char values
    `tables` (forward, complement; convert.hasher_tensors)."""
    if kind == "antilex":
        return antilex_kmer_hashes_2d(M, k, canonical)
    c = M.to(torch.int64)
    vals = tables[0][c]
    comp_vals = tables[1][c] if canonical else None
    return nt_like_kmer_hashes_2d(vals, comp_vals, k, rot_offset, canonical, C)


def window_lr_min_2d(hv: torch.Tensor, w: int, C: int, want_right: bool):
    """Per-row leftmost (and rightmost) sliding-window minimum positions
    r * C + column of the TOP16-masked hashes hv (R, C + w - 1)."""
    R = hv.shape[0]
    rowbase = torch.arange(R, dtype=torch.int64, device=hv.device)[:, None] * C
    lpos = rowbase + window_min_cols_packed(hv, w, right_tie=False)
    rpos = rowbase + window_min_cols_packed(hv, w, right_tie=True) if want_right else None
    return lpos, rpos


def windowed_counts_2d(bits: torch.Tensor, l: int) -> torch.Tensor:
    """Windowed sums of 0/1 over length-l windows per row: (R, S - l + 1)."""
    return windowed_sum(bits, l)


def lane_geometry(n: int, l: int, C: int = DEFAULT_C) -> tuple[int, int]:
    """(C, R): C owned windows per row, R rows."""
    nw = max(n - l + 1, 1)
    if nw < C:
        return max(16, 1 << (nw - 1).bit_length()), 1
    return C, -(-nw // C)


def flat_length(C: int, R: int, l: int) -> int:
    """Padded char count the lane matrix build requires."""
    halo = l - 1
    return (R + (-(-halo // C) if halo else 0)) * C


def selected_window_stream_2d(codes, n, k, w, tables, rot_offset, canonical, C, R,
                              ambiguous=None, kind="nt"):
    """Per-window selected minimizer positions for one chunk.

    codes (2-bit codes or text bytes; and ambiguous, 0/1 flags per char, if
    given): uint8 tensors padded to flat_length(C, R, l). Returns (sel
    (R * C,) int64 positions | SKIPPED | INVALID, valid (R * C,) bool).
    SKIPPED marks a window that holds an ambiguous char; a window past the
    end is INVALID even then. The strand count reads bit 1 of each code
    (of the raw byte for text).
    """
    l = k + w - 1
    S = C + l - 1
    M = build_lane_matrix(codes, R, C, S)
    h = kmer_hashes_2d(M, tables, k, rot_offset, canonical, C, kind)  # (R, C + w - 1)
    hv = h & TOP16
    kpos = _local_pos(R, C + w - 1, C, codes.device)
    hv = torch.where(kpos <= n - k, hv, INVALID)  # k-mers past the end never win
    lpos, rpos = window_lr_min_2d(hv, w, C, want_right=canonical)
    if canonical:
        cnt = windowed_counts_2d((M >> 1) & 1, l)  # (R, C)
        sel = torch.where(2 * cnt > l, lpos, rpos)
    else:
        sel = lpos
    if ambiguous is not None:
        acnt = windowed_counts_2d(build_lane_matrix(ambiguous, R, C, S), l)
        sel = torch.where(acnt > 0, SKIPPED, sel)
    valid = (_local_pos(R, C, C, codes.device) <= n - l).reshape(R * C)
    sel = torch.where(valid, sel.reshape(R * C), INVALID)
    return sel, valid


def kept_windows(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                 rot_offset: int, canonical: bool, mode: str = MODE_MINIMIZERS,
                 ambiguous: torch.Tensor | None = None, *, text: bool = False,
                 kind: str = "nt", byte_codes: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sel, keep) of the n - l + 1 windows of the first n chars of `chars`
    (a 2-bit byte stream, 2-bit codes one per byte with `byte_codes`, or
    text bytes with `text`) hashed by `kind` with
    the per-char `tables`: the raw selected stream (int64 positions,
    SKIPPED where the window holds a char flagged in the 1-bit plane
    `ambiguous`) and the keep mask of `mode` (counterpart of the
    reference's `_pipeline_chunk_rows` before compaction). Minimizers and
    super-k-mers dedup adjacent windows on the raw stream and drop SKIPPED
    after it; syncmers keep the windows whose sel is a syncmer k-mer."""
    l = k + w - 1
    if canonical and l % 2 == 0:
        raise ValueError(f"window length l={l} must be odd to determine strand")
    nw = max(n - l + 1, 0)
    C, R = lane_geometry(n, l)
    flat = flat_length(C, R, l)
    dev = chars.device
    codes = torch.zeros(flat, dtype=torch.uint8, device=dev)
    codes[:n] = unpack_chars(chars, n, text, byte_codes)
    amb = None
    if ambiguous is not None:
        amb = torch.zeros(flat, dtype=torch.uint8, device=dev)
        amb[:n] = unpack_bits(ambiguous, n)
    sel, valid = selected_window_stream_2d(codes, n, k, w, None if tables is None
                                           else tables.to(dev), rot_offset, canonical, C, R,
                                           amb, kind)
    if mode in SYNCMER_MODES:
        gw = torch.arange(sel.numel(), dtype=torch.int64, device=sel.device)
        lo, hi = syncmer_offsets(mode, w)
        keep = valid & ((sel == gw + lo) | (sel == gw + hi)) & (sel != SKIPPED)
    else:
        prev = torch.cat([sel.new_full((1,), INVALID), sel[:-1]])
        keep = valid & (sel != prev)
        if ambiguous is not None:
            keep &= sel != SKIPPED
    return sel[:nw], keep[:nw]


def _planes(sel: torch.Tensor, mode: str) -> list[torch.Tensor]:
    """The values each window contributes, one tensor per output plane:
    its sel (minimizers), sel and window index (super-k-mers), or its
    window index (syncmers)."""
    if mode in SYNCMER_MODES:
        return [torch.arange(sel.numel(), dtype=torch.int64, device=sel.device)]
    if mode == MODE_SUPERKMERS:
        return [sel, torch.arange(sel.numel(), dtype=torch.int64, device=sel.device)]
    return [sel]


def run_pipeline(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                 rot_offset: int, canonical: bool, mode: str = MODE_MINIMIZERS,
                 ambiguous: torch.Tensor | None = None, *, text: bool = False,
                 kind: str = "nt", offset: int = 0, byte_codes: bool = False):
    """int32 positions (window indices for syncmers), each plus `offset`
    as u32 bits, on chars.device, of the first n chars of `chars` (as in
    `kept_windows`); for super-k-mers (positions, first-window indices)."""
    sel, keep = kept_windows(chars, n, k, w, tables, rot_offset, canonical, mode, ambiguous,
                             text=text, kind=kind, byte_codes=byte_codes)
    out = [u32_bits(p[keep], offset) for p in _planes(sel, mode)]
    return tuple(out) if mode == MODE_SUPERKMERS else out[0]


# Plain versions of the three CUDA kernels (csrc/minimizers.cu), one each,
# with the kernels' inputs and outputs. Chained, they give run_pipeline.

def minimizer_tiles_plain(chars: torch.Tensor, n: int, k: int, w: int,
                          tables: torch.Tensor | None, rot_offset: int, canonical: bool, tile: int,
                          mode: str = MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None, *,
                          text: bool = False, kind: str = "nt", offset: int = 0,
                          byte_codes: bool = False):
    """(scratch, counts): tile t's kept values plus `offset` (u32 bits), in
    window order, in scratch[..., t * tile : t * tile + counts[t]] (int32;
    the rest of scratch is 0 here and undefined in the kernel), and counts
    (int32, one per tile of `tile` windows). scratch is (ntiles * tile,), or
    (2, ntiles * tile) for super-k-mers: positions, then window indices."""
    sel, keep = kept_windows(chars, n, k, w, tables, rot_offset, canonical, mode, ambiguous,
                             text=text, kind=kind, byte_codes=byte_codes)
    ntiles = -(-sel.numel() // tile)
    keep2 = torch.zeros(ntiles * tile, dtype=torch.bool, device=chars.device)
    keep2[:keep.numel()] = keep
    keep2 = keep2.view(ntiles, tile)
    rows, cols = keep2.nonzero(as_tuple=True)
    slots = (keep2.cumsum(1) - 1)[rows, cols]
    planes = _planes(sel, mode)
    scratch = torch.zeros(len(planes), ntiles, tile, dtype=torch.int32, device=chars.device)
    for p, values in enumerate(planes):
        scratch[p, rows, slots] = u32_bits(values[keep], offset)
    scratch = scratch.view(len(planes), ntiles * tile)
    return (scratch if mode == MODE_SUPERKMERS else scratch[0]), keep2.sum(1, dtype=torch.int32)


def tile_offsets_plain(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of counts with the total behind it: (ntiles + 1,) int32."""
    return torch.cat([counts.new_zeros(1), counts.cumsum(0, dtype=torch.int32)])


def tile_append_plain(scratch: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor,
                      total: int, tile: int) -> torch.Tensor:
    """out[..., offsets[t] + i] = scratch[..., t * tile + i] for i < counts[t]:
    (total,) int32, or (2, total) for a two-plane scratch."""
    live = torch.arange(tile, device=scratch.device) < counts[:, None]
    rows, cols = live.nonzero(as_tuple=True)
    planes = scratch.view(scratch.shape[0] if scratch.dim() == 2 else 1, counts.numel(), tile)
    out = torch.zeros(planes.shape[0], total, dtype=torch.int32, device=scratch.device)
    out[:, offsets[rows].long() + cols] = planes[:, rows, cols]
    return out.view(*scratch.shape[:-1], total)
