"""What the port carries across: the hasher's state, the sequence and its
ambiguity mask, as tensors on one `torch.device`, and the results back to
the host; and the two functions that rebuild the port's hasher and
sequence from any object of the same shape (the JAX package's, for one).

`hasher_tensors` is the counterpart of the JAX package's
`ops/pipeline.hasher_jit_args`: where that hands the kernel the nt table
and the mul constant, this hands it the per-char values the rolling fold
reads, so nt and mul, on 2-bit DNA and on text, are one fold.

A read matrix crosses through pinned memory (`staged_rows`): cut into
pieces of whole rows, copied on every CPU the process may use into a ring
of reused pinned buffers, each piece sent to the card as soon as it is in
its buffer (`Stager`). Every other upload is one blocking copy from
pageable memory (`upload`).
"""

from __future__ import annotations

import collections
import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .hashers import AntiLexHasher, KmerHasher, MulHasher, NtHasher
from .seq.packed import AsciiSeq, GenericSeq, PackedNSeqVec, PackedSeq, PackedSeqVec, pack_2bit
from .utils.device import require_cuda
from .utils import profiling
from .utils.profiling import count_bytes, count_staged, count_sync, stage

_HASHERS = {cls.kind: cls for cls in (NtHasher, MulHasher, AntiLexHasher)}
TABLE_ENTRIES = {False: 4, True: 256}  # per-char table entries: 2-bit codes, text bytes
# bytes of a staged piece of a read matrix, in whole rows. While the copies
# fill the host's memory bandwidth, each piece costs the thread that sends
# it a wait for a CPU: on an H100's 8-CPU host 1,000,000 x 150 B took
# 10-11 ms in pieces of 16 MiB, 14-25 ms in pieces of 4 MiB
PIECE = 16 << 20
IN_FLIGHT = 2  # pinned buffers a worker: pieces being copied, or copied and not yet sent


def hasher_from(h) -> KmerHasher:
    """The port's hasher equal to `h`: any object with `kind`, `k`,
    `canonical` and `seed` (the port's own hashers come back as they are)."""
    if isinstance(h, KmerHasher):
        return h
    cls = _HASHERS.get(getattr(h, "kind", None))
    if cls is None:
        raise TypeError(f"no hasher of the port for {type(h).__name__} "
                        f"(kind {getattr(h, 'kind', None)!r})")
    return cls(int(h.k), canonical=bool(h.canonical), seed=h.seed)


def seq_from(s):
    """The port's sequence equal to `s`: a `PackedSeq`-like object (packed
    `data`, `offset`, `length`, 2 bits per char) is wrapped without a copy;
    an `nseq`-like one (`seq`, `ambiguous`) becomes a `PackedNSeqVec`; any
    other object with `codes()` and `char_bits` becomes a `PackedSeqVec`
    (2 bits) or a `GenericSeq` (8 bits)."""
    if isinstance(s, (PackedSeq, AsciiSeq, GenericSeq, PackedNSeqVec)):
        return s
    if hasattr(s, "seq") and hasattr(s, "ambiguous"):
        return PackedNSeqVec(seq_from(s.seq), np.asarray(s.ambiguous))
    bits = getattr(s, "char_bits", None)
    if bits == 2 and all(hasattr(s, a) for a in ("data", "offset", "length")):
        return PackedSeq(np.asarray(s.data, dtype=np.uint8), s.offset, s.length)
    if bits == 2 and hasattr(s, "codes"):
        return PackedSeqVec.from_codes(s.codes())
    if bits == 8 and hasattr(s, "codes"):
        return GenericSeq(s.codes())
    raise TypeError(f"no sequence of the port for {type(s).__name__}")


def char_tables(hasher: KmerHasher, text: bool) -> np.ndarray | None:
    """(2, nchars) uint32: the forward value F[c] and the complement value
    R[c] of each char c the fold reads, for 2-bit codes (4) or text bytes
    (256); None for antilex, which folds no table.

    nt: F[c] = T[c & 3], R[c] = T[(c & 3) ^ 2] (text folds with & 3).
    mul: F[c] = (c + 1) M, R[c] = ((c ^ 2) + 1) M, mod 2^32: the complement
    of a text char is c ^ 2 on the raw byte, so R is no permutation of F.
    """
    if hasher.kind == "antilex":
        return None
    c = np.arange(TABLE_ENTRIES[text], dtype=np.uint32)
    if hasher.kind == "nt":
        table = np.asarray(hasher.table, dtype=np.uint32)
        return np.stack([table[c & 3], table[(c & 3) ^ 2]])
    if hasher.kind == "mul":
        m = np.uint32(hasher.mul_const)
        return np.stack([(c + 1) * m, ((c ^ 2) + 1) * m]).astype(np.uint32)
    raise ValueError(f"unknown hasher kind {hasher.kind!r}")


def hasher_tensors(hasher: KmerHasher, device: torch.device | str, text: bool = False):
    """(key, tables): key = (kind, canonical, rot_offset); tables =
    `char_tables` as an int64 (2, nchars) tensor on `device`, or None."""
    key = (hasher.kind, hasher.canonical, getattr(hasher, "rot_offset", 0))
    with profiling.span("hasher tables"):
        tables = char_tables(hasher, text)
        if tables is None:
            return key, None
        return key, upload(tables.astype(np.int64), require_cuda(device), "tables upload")


def upload(data: np.ndarray, device: torch.device, site: str) -> torch.Tensor:
    """`data` as a tensor on `device`, counted at `site`: on a card a blocking
    copy from pageable memory, which PyTorch ends by waiting for the stream;
    on the CPU the array itself."""
    count_bytes("h2d pageable", data.nbytes)
    count_sync(site)
    return torch.from_numpy(data).to(device)


def packed_words(seq, device: torch.device | str) -> torch.Tensor:
    """The sequence as a 2-bit byte stream (4 bases per byte, base i at bits
    2 * (i % 4)) in a uint8 tensor on `device`.

    A `PackedSeq` whose first base is byte-aligned is used as it is (no
    host copy); any other 2-bit sequence is repacked once on the host.
    """
    device = require_cuda(device)
    if isinstance(seq, PackedSeq) and seq.offset % 4 == 0:
        data, _ = seq.packed_with_offset()
    else:
        data = pack_2bit(seq.codes())
    with profiling.span("upload"):
        return upload(np.ascontiguousarray(data), device, "upload")


def text_bytes(seq: GenericSeq, device: torch.device | str) -> torch.Tensor:
    """The raw bytes of a `GenericSeq` (1 B per char) in a uint8 tensor on
    `device`; a contiguous array crosses without a host copy."""
    return code_bytes(seq.seq, device)


def code_bytes(codes, device: torch.device | str) -> torch.Tensor:
    """A uint8 array of one char per byte (2-bit codes, as the FASTA reader
    and the batch engine make them, or text) in a uint8 tensor of its shape
    on `device`: 1 B per char over the bus and no host packing; a
    contiguous array crosses without a host copy, in the stage and at the
    sync site `upload`."""
    device = require_cuda(device)
    data = np.ascontiguousarray(codes, dtype=np.uint8)
    with stage("upload"), warnings.catch_warnings():
        # bytes input is read-only; no path of the port writes to it
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return upload(data, device, "upload")


def piece_rows(rows: int, width: int) -> list[tuple[int, int]]:
    """The pieces `staged_rows` cuts a (rows, width) matrix into, in order:
    ranges [r0, r1) of whole rows, as many as fit in PIECE bytes (one where
    a row passes it); none for a matrix of no bytes."""
    if not rows or not width:
        return []
    per = max(PIECE // width, 1)
    return [(r, min(r + per, rows)) for r in range(0, rows, per)]


def staged_rows(matrix: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A (B, L) uint8 matrix of any strides (a read matrix or its flags, as
    the caller holds it) as a contiguous (B, L) uint8 tensor on `device`,
    in the stage `ascii upload`.

    On a card the device's `Stager` copies the `piece_rows` into pinned
    buffers on a pool of one thread per CPU the process may use (a matrix
    of one piece on the calling thread) and sends each piece to its rows
    with a non-blocking copy on the current stream as soon as it is in its
    buffer. It returns once every byte has left `matrix`, which the caller
    may then overwrite, without waiting for the card: work queued after it
    on the current stream sees the whole tensor. Each call copies its bytes
    anew; nothing is kept for a caller's array. On the CPU, the array
    itself. Counted as a card's on both: "h2d pinned" bytes, and STAGED's
    pieces, workers and bytes."""
    device = require_cuda(device)
    if matrix.dtype != np.uint8 or matrix.ndim != 2:
        raise ValueError(f"staged_rows takes a (B, L) uint8 matrix, not {matrix.dtype} "
                         f"{matrix.ndim}-D")
    plan = piece_rows(*matrix.shape)
    workers = min(len(os.sched_getaffinity(0)), len(plan))  # the calling thread for one piece
    with stage("ascii upload"):
        count_bytes("h2d pinned", matrix.nbytes)
        count_staged({"pieces": len(plan), "workers": workers, "bytes": matrix.nbytes})
        if device.type != "cuda":
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
                return torch.from_numpy(np.ascontiguousarray(matrix))
        return stager(device).upload(matrix, plan)


class _Slot:
    """A host buffer of a `Stager`'s ring and the event of its last copy to
    the card (None before its first)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor):
        self.host, self.event = host, None


def _fill(slot: _Slot, rows: np.ndarray) -> torch.Tensor:
    """Waits for the buffer's last copy to the card, then copies `rows` into
    it (NumPy lets go of the interpreter lock): the filled bytes as a tensor
    of rows' shape."""
    if slot.event is not None:
        slot.event.synchronize()
    host = slot.host[:rows.nbytes].view(rows.shape)
    np.copyto(host.numpy(), rows)
    return host


class Stager:
    """`staged_rows` on one device: a ring of up to IN_FLIGHT buffers a
    worker (pinned on a card), of PIECE bytes or one row where a row passes
    it, made as a call first needs them and kept; piece j of a call takes
    buffer j of the ring, round it. A pool of one thread per CPU the process
    may use, made at the first matrix of more than one piece and kept. A
    buffer is written again only after the event of its last copy to the
    card has fired: the thread that fills it waits for it, and each such
    wait counts at the sync site `staging wait`. One upload at a time (a
    lock). On the CPU the buffers are plain memory and the copies
    synchronous: the same plan, pool and ring, which the CPU tests reach."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cpus = len(os.sched_getaffinity(0))
        self.ring: list[_Slot] = []
        self.pool: ThreadPoolExecutor | None = None
        self.lock = threading.Lock()

    def upload(self, matrix: np.ndarray, plan: list) -> torch.Tensor:
        """`matrix` as a new (B, L) uint8 tensor on the device, piece by
        piece of `plan` (its `piece_rows`)."""
        out = torch.empty(matrix.shape, dtype=torch.uint8, device=self.device)
        with self.lock:
            if len(plan) == 1:
                slot = self._take(0, matrix.nbytes)
                self._send(slot, _fill(slot, matrix), out)
                return out
            if plan and self.pool is None:
                self.pool = ThreadPoolExecutor(self.cpus, thread_name_prefix="smt-staging")
            ring = IN_FLIGHT * self.cpus
            ahead = collections.deque()  # (slot, future of its filled rows, their rows on the card)
            try:
                for j, (r0, r1) in enumerate(plan):
                    if len(ahead) == ring:  # piece j - ring sent before its buffer is taken
                        slot, filled, dst = ahead.popleft()
                        self._send(slot, filled.result(), dst)
                    slot = self._take(j % ring, (r1 - r0) * matrix.shape[1])
                    ahead.append((slot, self.pool.submit(_fill, slot, matrix[r0:r1]),
                                  out[r0:r1]))
                while ahead:
                    slot, filled, dst = ahead.popleft()
                    self._send(slot, filled.result(), dst)
            finally:  # no thread still writes a buffer once the lock is let go
                wait([filled for _, filled, _ in ahead])
        return out

    def _take(self, i: int, nbytes: int) -> _Slot:
        """Buffer i of the ring, made or grown (after its last copy) to hold
        `nbytes`; a wait to come on its last copy is counted."""
        if i == len(self.ring):
            self.ring.append(_Slot(self._buffer(nbytes)))
        slot = self.ring[i]
        if slot.host.numel() < nbytes:
            if slot.event is not None:
                count_sync("staging wait")
                slot.event.synchronize()
            self.ring[i] = slot = _Slot(self._buffer(nbytes))
        if slot.event is not None:
            count_sync("staging wait")
        return slot

    def _buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(max(PIECE, nbytes), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _send(self, slot: _Slot, host: torch.Tensor, dst: torch.Tensor) -> None:
        """The filled buffer's copy to its rows on the card, on the current
        stream, and the event that frees the buffer after it."""
        dst.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            if slot.event is None:
                slot.event = torch.cuda.Event()
            slot.event.record(torch.cuda.current_stream(self.device))


_STAGERS: dict[torch.device, Stager] = {}


def stager(device: torch.device) -> Stager:
    """The device's `Stager`, made at its first staged upload and kept."""
    s = _STAGERS.get(device)
    if s is None:
        s = _STAGERS[device] = Stager(device)
    return s


def is_dna(codes: np.ndarray) -> bool:
    """Whether a uint8 array holds 2-bit codes (every value <= 3): the JAX
    package's `probe_is_dna`, an O(n) host scan for inputs without a type."""
    return codes.size == 0 or int(codes.max()) <= 3


def span(buf: torch.Tensor, start: int, end: int, chars_per_byte: int) -> torch.Tensor:
    """The bytes of `buf` that hold chars [start, end), as a view (no copy):
    a 2-bit stream (4 chars per byte), a 1-bit plane (8) or bytes (1);
    `start` must fall on a byte."""
    if start % chars_per_byte:
        raise ValueError(f"char {start} does not start a byte of {chars_per_byte} chars")
    return buf[start // chars_per_byte:-(-end // chars_per_byte)]


def ambiguity_plane(ambiguous, n: int, device: torch.device | str) -> torch.Tensor:
    """A per-base ambiguity mask (`PackedNSeqVec.ambiguous`, or a caller's
    bool or uint8 array of n flags, nonzero = ambiguous) as a 1-bit plane
    in a uint8 tensor on `device`: base i at bit i % 8 of byte i // 8, the
    bits past n zero. The counterpart of the JAX package's packing of the
    ambiguity plane (simd_minimizers_tpu/ops/fused.py `_fused_launch`); an
    eighth of the mask's bytes cross the bus."""
    device = require_cuda(device)
    mask = np.asarray(ambiguous)
    if mask.dtype not in (np.bool_, np.uint8):
        raise TypeError(f"the ambiguity mask must be bool or uint8, got {mask.dtype}")
    if mask.shape != (n,):
        raise ValueError(f"the ambiguity mask has shape {mask.shape}, the sequence {n} bases")
    with stage("mask packing"):
        plane = np.packbits(mask, bitorder="little")
    with stage("upload"):
        return upload(plane, device, "upload")


def padding_plane(lens, stride: int, device: torch.device | str,
                  ambiguous: torch.Tensor | None = None) -> torch.Tensor:
    """The 1-bit plane of a batch whose read i holds chars [i * stride,
    i * stride + lens[i]): every padding char flagged (so no window spans
    two reads), built on `device` from the lengths alone, or'ed with the
    reads' own flags `ambiguous` (uint8, one per char of the batch, on
    `device`) if given. The plane covers len(lens) * stride chars, rounded
    up to whole bytes with flagged chars."""
    device = require_cuda(device)
    lens_t = upload(np.asarray(lens, np.int64), device, "padding plane")
    flags = torch.arange(stride, device=device) >= lens_t[:, None]
    flags = flags.reshape(-1)
    if ambiguous is not None:
        flags |= ambiguous.to(torch.bool)
    pad = -flags.numel() % 8
    if pad:
        flags = torch.cat([flags, flags.new_ones(pad)])
    weights = upload(np.array([1 << b for b in range(8)], np.uint8), device, "padding plane")
    return (flags.view(-1, 8).to(torch.uint8) * weights).sum(1, dtype=torch.uint8)


class Download:
    """A result on its way to the host: `Download(result, stream)` starts
    the copy of a tensor (or a tuple of tensors) holding u32 bits, and
    `.result()` returns it as np.uint32 arrays of the same structure.

    From a CUDA tensor the copy goes into pinned host memory with
    non_blocking=True, on `stream` (default: the current stream) after the
    work that produced the tensor, so it overlaps later kernels on other
    streams. `.result()` waits for the copy's event and returns views of the
    pinned buffers, with no host copy; PyTorch's pinned-memory allocator
    takes a buffer back when its last array is dropped and hands it out
    again only after the copy's event has fired. A CPU tensor needs no
    copy; its bytes and its wait are counted as a card's would be."""

    def __init__(self, result, stream: torch.cuda.Stream | None = None):
        self.tuple = isinstance(result, tuple)
        tensors = result if self.tuple else (result,)
        count_bytes("d2h pinned", sum(t.numel() * t.element_size() for t in tensors))
        self.event = None
        if tensors[0].device.type != "cuda":
            self.host = tensors
            return
        stream = stream or torch.cuda.current_stream(tensors[0].device)
        stream.wait_stream(torch.cuda.current_stream(tensors[0].device))
        with stage("download"), torch.cuda.stream(stream):
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                              for t in tensors)
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def result(self):
        with profiling.span("download wait"):
            count_sync("download wait")
            if self.event is not None:
                self.event.synchronize()
        out = tuple(h.numpy().view(np.uint32) for h in self.host)
        self.host = None
        return out if self.tuple else out[0]
