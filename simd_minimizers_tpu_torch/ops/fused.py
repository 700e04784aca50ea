"""The Hopper minimizer kernels' wrappers, their launch counts and their
geometry gate, and the drivers that split long sequences and many records
into launches.

Counterpart of `simd_minimizers_tpu/ops/fused.py` (`fused_supported`,
`_invoke_pallas`, `_fused_launch`, `_fused_harvest`, `fused_sketch`,
`_LaunchWave`, `sketch_long`, `sketch_records`). The kernels are
`csrc/minimizers.cu` and `csrc/top16.cu`; see their headers for the
design. They read the plain 2-bit byte stream, 2-bit codes one per byte,
or the raw text bytes, so the TPU's row- and byte-striped repacks have no
counterpart here.

`fused_sketch` is `_fused_launch` (`minimizer_tiles`, `tile_offsets`; no
host sync) then `_fused_harvest` (the total, `tile_append`): three
wrappers, one per kernel. `minimizer_tiles` takes its stored route (every
key of the tile, `min_passes(w)` doubling passes, O(log w) per window)
below w = LARGE_W_MIN and its large-w route (O(1) mins per window) from
there on, so that every w with TILE + w <= 2^16 fits a block's shared
memory (`sub_tile`; a k too large for the large-w route's bound keeps the
stored route where that fits). On the large-w route it first launches a fourth
kernel, `kmer_top16`, which writes the top 16 hash bits of every k-mer
once, and the route reads them instead of hashing w + T k-mers per T
windows. `minimizer_tiles`, `kmer_top16` and `tile_append` can also read
the length and the total on the card, for a CUDA-graph capture
(ops/device_sketcher.py). On a CUDA tensor each launches its kernel or
raises; on a CPU tensor each runs its plain version (`ops/pipeline.py`).
`minimizer_tiles` has one kernel instance per strand, mode family
(minimizers, super-k-mers, syncmers) and ambiguity plane, each with its own
count in `LAUNCHES`. The input kind (2-bit DNA, packed or one code per
byte, or text), the hasher (the nt / mul fold over per-char tables, or
antilex) and the u32 offset of the launch's first char are block-uniform
arguments of every instance.

The drivers keep the JAX package's contracts (spans overlap by l - 1 chars
and merge at their seams exactly, syncmer spans concatenate, positions are
u32) but not its TPU design: the input is uploaded once and every span is
a view of it that starts at a multiple of TILE windows (so on a byte of the
2-bit stream and of the 1-bit plane), launches need no grid buckets, and a
record's results come down through pinned host memory on a side stream
while the next launches run.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import convert
from ..parallel.multihost import concat, merge_adjacent_shards
from ..utils.device import require_cuda
from ..utils.profiling import count_bytes, count_sync, span, stage
from . import _build, pipeline

TILE = 4096  # windows per thread block; csrc/minimizers.cu TILE
THREADS = 256  # threads per block of minimizer_tiles; csrc/minimizers.cu THREADS
SCAN_BLOCK = 1024  # counts per block of tile_offsets; csrc/minimizers.cu SCAN_BLOCK
SPAN_CHARS = 1 << 29  # chars per span of a long sequence or record (the JAX package's)
# dynamic shared memory one block may use on Hopper: 227 KiB less the
# kernel's static shared memory (the scan's warp sums, 32 B, and the 2-bit
# fold's rolling values, 128 B)
_SMEM_MAX = 232448 - 160
_KEY_COLUMNS = 1 << 16  # the packed (top16 | column) key keeps 16 column bits
# w from which minimizer_tiles takes its large-w route (csrc/minimizers.cu:
# O(1) mins per window, keys of two blocks of columns in shared memory)
# instead of storing every key of the tile and reducing them in doubling
# passes (O(log w) per window)
LARGE_W_MIN = 1536  # the H100's crossover (PERF.md, chip_smoke.py's route comparison)
# the stored route's window takes 2^PASS_SLACK to 2^(PASS_SLACK + 1) loads
# per arm: its doubling passes stop PASS_SLACK short of 2^passes <= w; at
# w = 11 two passes, which the hash runs take in registers, beat one and
# three (PERF.md, kernel_ab.py --passes)
PASS_SLACK = 1

# csrc/minimizers.cu MINIMIZERS, SUPERKMERS, SYNCMERS: the kernel's mode
_KERNEL_MODE = {pipeline.MODE_MINIMIZERS: 0, pipeline.MODE_SUPERKMERS: 1,
                pipeline.MODE_CLOSED_SYNCMERS: 2, pipeline.MODE_OPEN_SYNCMERS: 2}
_MODE_TAG = {0: "", 1: ",superkmers", 2: ",syncmers"}


def instance_name(canonical: bool, mode: str, ambiguous: bool) -> str:
    """The minimizer_tiles instance that runs (canonical, mode, ambiguity
    plane), as it is named in LAUNCHES."""
    tag = _MODE_TAG[_KERNEL_MODE[mode]] + (",ambiguous" if ambiguous else "")
    return f"minimizer_tiles<{'canonical' if canonical else 'forward'}{tag}>"


# Launches per kernel instance, counted where each is launched (CUDA tensors
# only). Every instance csrc/minimizers.cu builds (tiles_instance) has an
# entry: 2 strands x 3 mode families x with and without an ambiguity plane.
LAUNCHES = {instance_name(c, m, a): 0
            for m in (pipeline.MODE_MINIMIZERS, pipeline.MODE_SUPERKMERS,
                      pipeline.MODE_CLOSED_SYNCMERS)
            for a in (False, True) for c in (True, False)}
LAUNCHES.update({"kmer_top16": 0, "tile_offsets": 0, "tile_append": 0})
MAX_LAUNCH_CHARS = 1 << 31  # chars of one launch: in-kernel values are below 2^31
MAX_SEQUENCE_CHARS = 1 << 32  # chars of one sequence: positions are u32

_ready_devices: set[int] = set()
# per card: tile_offsets' ticket and finished-block counters and one
# look-back word per block of the largest scan, zero between launches
_scan_status: dict[int, torch.Tensor] = {}
# per card: tile_append's persistent grid, (blocks, warps per block)
_append_grids: dict[int, tuple[int, int]] = {}


def min_passes(w: int) -> int:
    """The stored route's doubling passes at w (csrc/minimizers.cu
    `passes`): after them each key is the least of p = 2^passes columns,
    and a window takes ceil(w / p) loads per arm."""
    return max(0, w.bit_length() - 1 - PASS_SLACK)


def _smem_bytes(k: int, w: int, canonical: bool, mode: str, ambiguous: bool, text: bool,
                kind: str, t: int) -> int:
    """Mirror of csrc/minimizers.cu tile_smem_bytes for sub_tile t: on the
    stored route (t = 0) the tile's chars; the keys (whose space also stages
    one TILE-word plane per output plane): on the stored route every
    column's in whole 32-word rows, on the large-w route per arm a least key
    per window and two blocks of t keys, each with one pad word per thread's
    run of the scan (where t > THREADS) and the scan's THREADS / 32 warp
    totals; with an ambiguity plane the tile's ambiguity bits in 32-bit
    words; canonical the chars' T/G bits in 32-bit words; and on the stored
    route the fold's forward and complement tables (none for antilex)."""
    l = k + w - 1
    chars = (TILE + l + 6) // 4 * 4
    scan = t + (THREADS if t > THREADS else 0) + THREADS // 32
    per_arm = TILE + 1 + 2 * scan if t else (TILE + w + 31) // 32 * 32
    keys = max((2 if canonical else 1) * per_arm,
               (2 if mode == pipeline.MODE_SUPERKMERS else 1) * TILE)
    amb = (TILE + l + 62) // 32 * 4 if ambiguous else 0
    tg = (chars + 31) // 32 * 4 if canonical else 0
    tables = 0 if t or kind == "antilex" else 2 * 4 * convert.TABLE_ENTRIES[text]
    return (0 if t else (chars + 15) // 16 * 16) + 4 * keys + amb + tg + tables


def _halo_bytes(k: int, w: int, canonical: bool, mode: str, ambiguous: bool, text: bool,
                kind: str, t: int) -> int:
    """The geometry term that bounds `fused_supported` on the large-w route
    (sub_tile t): the tile's chars with their l + 3 char halo, one a byte in
    whole 16-byte rows, beside the route's keys (two blocks of t keys per
    arm, no padding), its ambiguity words and the fold's tables. The route
    holds no chars and no tables (canonical, a T/G bit plane of an eighth
    of the chars), so every geometry this admits fits its layout. The gate
    keeps this bound of the halo (the JAX package's gate bounds its halo
    too) rather than the smaller layout's, which would admit k far past it
    (at w = 11 this bound stops near k = 190,000)."""
    l = k + w - 1
    keys = max((2 if canonical else 1) * (TILE + 1 + 2 * t),
               (2 if mode == pipeline.MODE_SUPERKMERS else 1) * TILE)
    amb = (TILE + l + 62) // 32 * 4 if ambiguous else 0
    tables = 0 if kind == "antilex" else 2 * 4 * convert.TABLE_ENTRIES[text]
    return ((TILE + l + 6) // 4 * 4 + 15) // 16 * 16 + 4 * keys + amb + tables


def sub_tile(k: int, w: int, canonical: bool = True, mode: str = pipeline.MODE_MINIMIZERS,
             ambiguous: bool = False, text: bool = False, kind: str = "nt") -> int:
    """The route of minimizer_tiles at this geometry (csrc/minimizers.cu
    `sub_tile`): 0, the stored route, where its layout fits one block's
    shared memory and w < LARGE_W_MIN, or where the large-w route's gate
    bound (`_halo_bytes`) does not fit (a huge k: the gate never narrows as
    LARGE_W_MIN falls); else the large-w route's block of columns, the
    largest power of two <= min(w, TILE)."""
    t = min(TILE, 1 << (w.bit_length() - 1))
    if _smem_bytes(k, w, canonical, mode, ambiguous, text, kind, 0) <= _SMEM_MAX and (
            w < LARGE_W_MIN
            or _halo_bytes(k, w, canonical, mode, ambiguous, text, kind, t) > _SMEM_MAX):
        return 0
    return t


def _tile_smem_bytes(k: int, w: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                     ambiguous: bool = False, text: bool = False, kind: str = "nt") -> int:
    """The dynamic shared memory of minimizer_tiles at this geometry, on the
    route that `sub_tile` picks (`_smem_bytes`)."""
    return _smem_bytes(k, w, canonical, mode, ambiguous, text, kind,
                       sub_tile(k, w, canonical, mode, ambiguous, text, kind))


def fused_supported(k: int, w: int, canonical: bool = True, mode: str = pipeline.MODE_MINIMIZERS,
                    ambiguous: bool = False, text: bool = False, kind: str = "nt") -> bool:
    """Whether the kernel's geometry covers (k, w): every k-mer column of a
    tile (TILE + w of them) fits the key's 16 bits, and the tile's chars,
    keys, ambiguity bits and tables fit one block's shared memory (on the
    large-w route the bound of `_halo_bytes`: every such w at k up to about
    50,000)."""
    if not (k >= 1 and w >= 1 and TILE + w <= _KEY_COLUMNS):
        return False
    t = sub_tile(k, w, canonical, mode, ambiguous, text, kind)
    return (_halo_bytes if t else _smem_bytes)(k, w, canonical, mode, ambiguous, text, kind,
                                               t) <= _SMEM_MAX


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _library(device: torch.device):
    """The kernel library, set up once per card, before any CUDA-graph
    capture (TILE agreement, every minimizer_tiles and kmer_top16
    instance's shared-memory limit, tile_offsets' zeroed status words,
    tile_append's persistent grid)."""
    lib = _build.library()
    if device.index not in _ready_devices:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the kernels are set up on a card outside a CUDA-graph capture: "
                               "call ops.fused._library(device) first")
        if lib.smt_tile_windows() != TILE:
            raise RuntimeError("csrc/minimizers.cu TILE disagrees with ops/fused.py")
        _check(lib.smt_init(device.index), "smt_init")
        _check(lib.smt_top16_init(device.index), "smt_top16_init")
        _scan_status[device.index] = torch.zeros(2 + MAX_LAUNCH_CHARS // TILE // SCAN_BLOCK,
                                                 dtype=torch.int64, device=device)
        per_sm, warps = ctypes.c_int(0), ctypes.c_int(0)
        _check(lib.smt_append_occupancy(device.index, ctypes.byref(per_sm), ctypes.byref(warps)),
               "smt_append_occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _append_grids[device.index] = (sms * max(per_sm.value, 1), warps.value)
        _ready_devices.add(device.index)
    return lib


def tiles_occupancy(k: int, w: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                    ambiguous: bool = False, text: bool = False, kind: str = "nt",
                    device: torch.device | str = "cuda") -> tuple[int, int]:
    """(blocks per SM, dynamic shared memory per block in bytes) of the
    minimizer_tiles launch at this geometry on the card, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor with the bytes the kernel
    computes for itself (csrc/minimizers.cu tile_smem_bytes, which
    `_smem_bytes` mirrors)."""
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the occupancy of a kernel is a property of a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    lib = _library(dev)
    smem = lib.smt_tile_smem_bytes(k, w, int(canonical), _KERNEL_MODE[mode], int(ambiguous),
                                   int(text), int(kind == "antilex"),
                                   sub_tile(k, w, canonical, mode, ambiguous, text, kind))
    blocks = ctypes.c_int(0)
    _check(lib.smt_tiles_blocks_per_sm(dev.index, int(canonical), _KERNEL_MODE[mode],
                                       int(ambiguous), smem, ctypes.byref(blocks)),
           "smt_tiles_blocks_per_sm")
    return blocks.value, smem


def top16_grid(k: int, canonical: bool, *, text: bool = False, kind: str = "nt",
               byte_codes: bool = False, device: torch.device | str = "cuda") -> tuple[int, int]:
    """(blocks, dynamic shared memory per block in bytes) of a kmer_top16
    launch at this k and input kind on the card: its persistent grid (SMs x
    the blocks that fit an SM, from the occupancy query), which a launch of
    at least that many chunks of 8,192 k-mers starts, each block walking its
    share of the chunks (csrc/top16.cu)."""
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the grid of a kernel is a property of a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    lib = _library(dev)
    grid, smem = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib.smt_top16_grid(dev.index, k, int(canonical), int(text or byte_codes),
                              int(kind == "antilex"), ctypes.byref(grid), ctypes.byref(smem)),
           "smt_top16_grid")
    return grid.value, smem.value


def append_grid(device: torch.device | str = "cuda") -> tuple[int, int]:
    """(blocks, warps per block) of tile_append's persistent grid on the
    card: its SMs x the blocks that fit an SM (the occupancy query). Each
    warp copies one tile at a time, so a launch of at least blocks x warps
    tiles starts the whole grid (`append_blocks`)."""
    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("the grid of a kernel is a property of a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
    _library(dev)
    return _append_grids[dev.index]


def append_blocks(ntiles: int, blocks: int, warps: int) -> int:
    """The blocks a tile_append launch over `ntiles` tiles starts on a card
    whose persistent grid is `blocks` of `warps` warps: no more than one
    warp a tile, and at least one block."""
    if ntiles < 1 or blocks < 1 or warps < 1:
        raise ValueError(f"a launch needs tiles, blocks and warps: {ntiles}, {blocks}, {warps}")
    return min(blocks, -(-ntiles // warps))


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def _require_int32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"expected a contiguous int32 tensor, got {t.dtype}")


def _check_tables(tables: torch.Tensor | None, kind: str, text: bool) -> None:
    """The fold's per-char tables: int64 (2, 4) for 2-bit codes, (2, 256)
    for text bytes; antilex reads none."""
    if kind not in pipeline.HASHER_KINDS:
        raise ValueError(f"unknown hasher kind {kind!r}")
    if kind == "antilex":
        return
    want = (2, convert.TABLE_ENTRIES[text])
    if tables is None or tables.dtype != torch.int64 or tuple(tables.shape) != want:
        got = None if tables is None else (tables.dtype, tuple(tables.shape))
        raise ValueError(f"the {kind} hasher needs int64 tables of shape {want} for "
                         f"{'text' if text else '2-bit'} input, got {got}")


def _check_meta(meta: torch.Tensor | None, chars: torch.Tensor) -> None:
    if meta is not None and (meta.dtype != torch.int32 or meta.shape != (2,)
                             or meta.device.type != "cuda" or meta.device != chars.device):
        raise ValueError("meta must be an int32 (2,) tensor on the card of chars")


def _check_card_chars(chars: torch.Tensor, n: int, tables: torch.Tensor | None,
                      bytes_in: bool) -> None:
    """A card launch's chars and tables: contiguous, on one device, n chars."""
    if not chars.is_contiguous() or (tables is not None and not tables.is_contiguous()):
        raise ValueError("chars and tables must be contiguous")
    if chars.numel() * (1 if bytes_in else 4) < n:
        raise ValueError(f"chars must hold n={n} chars")
    if tables is not None and tables.device != chars.device:
        raise ValueError("tables and chars must be on one device")


def kmer_top16(chars: torch.Tensor, n: int, k: int, tables: torch.Tensor | None,
               rot_offset: int, canonical: bool, *, text: bool = False, kind: str = "nt",
               byte_codes: bool = False, meta: torch.Tensor | None = None) -> torch.Tensor:
    """The large-w route's pre-pass: the top 16 bits of the hash of each
    k-mer 0 .. n - k of the first n chars of `chars` (as in
    `minimizer_tiles`), (max(n - k + 1, 0),) int16 holding the u16 bits.
    With `meta` (on the card only) the kernel reads the length from meta[0]
    and writes the tops of that many chars' k-mers; n sizes the array and
    bounds the length. On the card a persistent grid (`top16_grid`) hashes
    each top in O(1) whatever k (csrc/top16.cu).

    Inside a CUDA-graph capture the launch is not counted in LAUNCHES."""
    if chars.dtype != torch.uint8:
        raise TypeError(f"chars must be uint8, got {chars.dtype}")
    if text and byte_codes:
        raise ValueError("chars are text bytes or 2-bit code bytes, not both")
    if n >= MAX_LAUNCH_CHARS:
        raise AssertionError("fused kernel handles < 2^31 chars per call (see sketch_long)")
    _check_tables(tables, kind, text)
    _check_meta(meta, chars)
    if _device_kind(chars) == "cpu":
        return pipeline.kmer_top16_plain(chars, n, k, tables, rot_offset, canonical, text=text,
                                         kind=kind, byte_codes=byte_codes)
    bytes_in = text or byte_codes
    _check_card_chars(chars, n, tables, bytes_in)
    dev = chars.device
    out = torch.empty(max(n - k + 1, 0), dtype=torch.int16, device=dev)
    if out.numel() == 0:  # no k-mer: nothing to launch
        return out
    lib = _library(dev)
    _check(lib.smt_kmer_top16(
        dev.index, chars.data_ptr(), chars.numel(), n, k, int(canonical), int(bytes_in),
        int(text), int(kind == "antilex"), None if tables is None else tables.data_ptr(),
        rot_offset, None if meta is None else meta.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "kmer_top16")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["kmer_top16"] += 1
    return out


def minimizer_tiles(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                    rot_offset: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                    ambiguous: torch.Tensor | None = None, *, text: bool = False,
                    kind: str = "nt", offset: int = 0, byte_codes: bool = False,
                    meta: torch.Tensor | None = None, passes: int | None = None,
                    top16: torch.Tensor | None = None):
    """Kernel 1: (scratch, counts) for the first n chars of `chars` (uint8:
    the 2-bit byte stream of convert.packed_words, with `byte_codes` 2-bit
    codes one per byte, of which the low two bits count, or with `text` the
    bytes of convert.text_bytes), hashed by `kind` (the nt or mul fold over
    the per-char `tables` of convert.hasher_tensors, or antilex, which takes
    None) in `mode`, skipping the windows that hold a char flagged in the
    1-bit plane `ambiguous` (uint8, convert.ambiguity_plane) if one is
    given. Tile t of TILE windows leaves its kept values plus `offset` (u32
    bits) in scratch[..., t * TILE:][:counts[t]] (int32): positions
    (minimizers), window indices (syncmers), or both as the two rows of a
    (2, ntiles * TILE) scratch (super-k-mers). `meta`, an int32 (2,) tensor
    on the device of chars, holds the length and the offset's bits that the
    kernel reads in place of n and offset, as a CUDA-graph capture needs
    (ops/device_sketcher.py; on the card only); n then sizes the launch and
    bounds the length. `passes` sets the stored route's doubling passes
    (default `min_passes(w)`; 2^passes <= w), which change its time, not
    its result. On the large-w route (`sub_tile`) a CUDA launch first runs
    `kmer_top16` on the same chars (with `meta`) on the current stream and
    the route reads its tops; `top16` passes that array instead (int16,
    n - k + 1 values; to time the route apart), and is refused on the
    stored route. The CPU's plain version hashes on both routes.

    Inside a CUDA-graph capture the launch is not counted in LAUNCHES: each
    replay of the graph counts it."""
    if chars.dtype != torch.uint8:
        raise TypeError(f"chars must be uint8, got {chars.dtype}")
    if mode not in _KERNEL_MODE:
        raise ValueError(f"unknown mode {mode!r}")
    if ambiguous is not None and (ambiguous.dtype != torch.uint8
                                  or ambiguous.device != chars.device):
        raise ValueError("ambiguous must be a uint8 tensor on the device of chars")
    if text and byte_codes:
        raise ValueError("chars are text bytes or 2-bit code bytes, not both")
    if not 0 <= offset < 1 << 32:
        raise ValueError(f"offset {offset} is not a u32")
    if n >= MAX_LAUNCH_CHARS:  # the JAX package's check (_fused_launch)
        raise AssertionError("fused kernel handles < 2^31 chars per call (see sketch_long)")
    l = k + w - 1
    if canonical and l % 2 == 0:
        raise ValueError(f"window length l={l} must be odd to determine strand")
    if not fused_supported(k, w, canonical, mode, ambiguous is not None, text, kind):
        raise NotImplementedError(
            f"k={k}, w={w} is beyond the kernel's geometry (fused_supported: TILE + w <= 2^16 "
            "for the 16-bit column keys, and the tile in shared memory); wider geometry is "
            "ROADMAP A12")
    _check_tables(tables, kind, text)
    _check_meta(meta, chars)
    t = sub_tile(k, w, canonical, mode, ambiguous is not None, text, kind)
    if passes is None:
        passes = 0 if t else min_passes(w)
    elif t or not 0 <= passes or 1 << passes > w:
        raise ValueError(f"passes={passes}: the stored route takes 2^passes <= w = {w}")
    if top16 is not None and (not t or top16.dtype != torch.int16 or not top16.is_contiguous()
                              or top16.device != chars.device or top16.numel() < n - k + 1):
        raise ValueError("top16 is read on the large-w route only: a contiguous int16 tensor "
                         f"of n - k + 1 = {n - k + 1} tops on the device of chars")
    if _device_kind(chars) == "cpu":
        return pipeline.minimizer_tiles_plain(chars, n, k, w, tables, rot_offset, canonical, TILE,
                                              mode, ambiguous, text=text, kind=kind,
                                              offset=offset, byte_codes=byte_codes)
    bytes_in = text or byte_codes
    _check_card_chars(chars, n, tables, bytes_in)
    if ambiguous is not None and (not ambiguous.is_contiguous() or ambiguous.numel() * 8 < n):
        raise ValueError("ambiguous must be contiguous and hold a bit for each of the n chars")
    dev = chars.device
    ntiles = -(-max(n - l + 1, 0) // TILE)
    planes = 2 if mode == pipeline.MODE_SUPERKMERS else 1
    scratch = torch.empty(planes, ntiles * TILE, dtype=torch.int32, device=dev)
    scratch = scratch if planes == 2 else scratch[0]
    counts = torch.empty(ntiles, dtype=torch.int32, device=dev)
    if ntiles == 0:  # no window: nothing to launch
        return scratch, counts
    lib = _library(dev)
    if t and top16 is None:
        top16 = kmer_top16(chars, n, k, tables, rot_offset, canonical, text=text, kind=kind,
                           byte_codes=byte_codes, meta=meta)
    lo, hi = pipeline.syncmer_offsets(mode, w)
    _check(lib.smt_minimizer_tiles(
        dev.index, chars.data_ptr(), chars.numel(), n, k, w, int(canonical), _KERNEL_MODE[mode],
        int(bytes_in), int(text), int(kind == "antilex"),
        None if tables is None else tables.data_ptr(), rot_offset,
        None if ambiguous is None else ambiguous.data_ptr(),
        0 if ambiguous is None else ambiguous.numel(), lo, hi, offset,
        None if meta is None else meta.data_ptr(), t, passes,
        None if top16 is None else top16.data_ptr(), scratch.data_ptr(), counts.data_ptr(), ntiles,
        torch.cuda.current_stream(dev).cuda_stream),
        "minimizer_tiles")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[instance_name(canonical, mode, ambiguous is not None)] += 1
    return scratch, counts


def tile_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Kernel 2: the exclusive scan of `counts` with the total behind it,
    (ntiles + 1,) int32 (the running total the TPU kernel kept in SMEM).
    On the card a single-pass scan of one block per SCAN_BLOCK counts over
    the card's status words (`_library`), which each launch leaves zeroed:
    launches on one card run one after another, as the port's do on the
    current stream (a CUDA graph replays its launch there too)."""
    _require_int32(counts)
    if _device_kind(counts) == "cpu":
        return pipeline.tile_offsets_plain(counts)
    ntiles = counts.numel()
    if ntiles == 0:
        return torch.zeros(1, dtype=torch.int32, device=counts.device)
    if ntiles > MAX_LAUNCH_CHARS // TILE:  # the card's status words cover the largest launch
        raise ValueError(f"{ntiles} counts: a launch has at most {MAX_LAUNCH_CHARS // TILE} tiles")
    dev = counts.device
    offsets = torch.empty(ntiles + 1, dtype=torch.int32, device=dev)
    lib = _library(dev)
    status = _scan_status[dev.index]
    _check(lib.smt_tile_offsets(dev.index, counts.data_ptr(), ntiles, offsets.data_ptr(),
                                status.data_ptr(), status.numel(),
                                torch.cuda.current_stream(dev).cuda_stream), "tile_offsets")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["tile_offsets"] += 1
    return offsets


def _check_append(scratch: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor) -> int:
    """tile_append's arguments, on any device; returns the planes."""
    _require_int32(scratch, counts, offsets)
    if (scratch.dim() not in (1, 2) or scratch.shape[-1] != counts.numel() * TILE
            or offsets.numel() != counts.numel() + 1 or counts.dim() != 1 or offsets.dim() != 1):
        raise ValueError("scratch, counts and offsets disagree on the tile count")
    planes = scratch.shape[0] if scratch.dim() == 2 else 1
    if planes not in (1, 2):
        raise ValueError(f"scratch holds one plane or two, not {planes}")
    if not (scratch.device == counts.device == offsets.device):
        raise ValueError("scratch, counts and offsets must be on one device")
    return planes


def tile_append(scratch: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor,
                total: int | None) -> torch.Tensor:
    """Kernel 3: each tile's run of scratch at its offset: (total,) int32,
    or (2, total) for the two-plane scratch of super-k-mers, both planes
    with the one set of offsets. With total None (on the card only) the
    kernel reads the total from offsets, as a CUDA-graph capture needs: the
    result is a flat buffer of planes * ntiles * TILE int32 whose first
    planes * offsets[-1] values are the planes one after the other, the
    rest undefined. On the card a persistent grid of warps (`append_grid`)
    copies the runs, reading 16 bytes at a time (csrc/minimizers.cu);
    scratch must start on 16 bytes there, as minimizer_tiles leaves it."""
    planes = _check_append(scratch, counts, offsets)
    if _device_kind(scratch) == "cpu":
        if total is None:
            raise ValueError("the total is read on the card only: pass it on the CPU")
        return pipeline.tile_append_plain(scratch, counts, offsets, total, TILE)
    if scratch.data_ptr() % 16:
        raise ValueError("scratch must start on 16 bytes (a tile's run is read 16 bytes at a time)")
    if total is None:
        out = torch.empty(planes * counts.numel() * TILE, dtype=torch.int32,
                          device=scratch.device)
    else:
        out = torch.empty(*scratch.shape[:-1], total, dtype=torch.int32, device=scratch.device)
    if total == 0 or counts.numel() == 0:
        return out
    dev = scratch.device
    lib = _library(dev)
    blocks = append_blocks(counts.numel(), *_append_grids[dev.index])
    _check(lib.smt_tile_append(dev.index, scratch.data_ptr(), counts.data_ptr(),
                               offsets.data_ptr(), counts.numel(), planes, blocks, out.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream), "tile_append")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["tile_append"] += 1
    return out


def _fused_launch(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                  rot_offset: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                  ambiguous: torch.Tensor | None = None, **kw):
    """One launch without a host sync: `minimizer_tiles` (arguments as
    there, `kw` its keywords) and `tile_offsets`; returns the handles
    (scratch, counts, offsets) that `_fused_harvest` takes."""
    scratch, counts = minimizer_tiles(chars, n, k, w, tables, rot_offset, canonical, mode,
                                      ambiguous, **kw)
    return scratch, counts, tile_offsets(counts)


def _fused_harvest(handles, mode: str, cnt: int | None = None):
    """One launch's values on its device: `tile_append` at the total, which
    is fetched from the card (the one 4-byte copy to the host) unless the
    caller already holds it as `cnt` (a wave fetches all its totals in one
    copy). int32 tensor, or (positions, indices) for super-k-mers."""
    scratch, counts, offsets = handles
    if cnt is None:
        with span("totals readback"):
            count_sync("totals readback")
            count_bytes("d2h pageable", offsets.element_size())
            cnt = int(offsets[-1])
    out = tile_append(scratch, counts, offsets, cnt)
    return (out[0], out[1]) if mode == pipeline.MODE_SUPERKMERS else out


def fused_sketch(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                 rot_offset: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                 ambiguous: torch.Tensor | None = None, *, text: bool = False,
                 kind: str = "nt", offset: int = 0, byte_codes: bool = False):
    """int32 positions (window indices for syncmers) plus `offset` (u32
    bits), on chars.device, of the first n chars of `chars` (as in
    `minimizer_tiles`), skipping the windows that hold a char flagged in the
    1-bit plane `ambiguous`; for super-k-mers (positions, first-window
    indices): `_fused_launch`, then `_fused_harvest`.

    A CUDA tensor goes through the three kernels (four on the large-w
    route, `kmer_top16` first), a CPU tensor through their plain versions;
    any other device raises. Fewer than l = k + w - 1 chars give an empty
    result without a launch.
    """
    return _fused_harvest(_fused_launch(chars, n, k, w, tables, rot_offset, canonical, mode,
                                        ambiguous, text=text, kind=kind, offset=offset,
                                        byte_codes=byte_codes), mode)


class _LaunchWave:
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

    @staticmethod
    def launch_footprint(n: int, l: int, mode: str) -> int:
        """Device bytes a launch over n chars holds until its harvest: its
        scratch and, at most as large, its output, per plane."""
        windows = -(-max(n - l + 1, 0) // TILE) * TILE
        return 2 * 4 * windows * (2 if mode == pipeline.MODE_SUPERKMERS else 1)

    def submit(self, key, footprint: int, launch) -> None:
        """Flush first if needed, then enqueue `launch()` (its handles)."""
        if self.wave and (self.bytes + footprint > self.budget
                          or len(self.wave) >= self.MAX_LAUNCHES):
            self.flush()
        with stage("kernels"):
            self.wave.append((key, launch()))
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
                res = _fused_harvest(handles, self.mode, cnt)
            self.sink(key, res)
        self.wave.clear()
        self.bytes = 0


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
    step = max((span_chars - (l - 1)) // TILE, 1) * TILE
    return [(s, min(s + step, nw) - 1 + l - s) for s in range(0, nw, step)]


def check_sequence_length(n: int) -> None:
    if n >= MAX_SEQUENCE_CHARS:  # the JAX package's check (sketch_long)
        raise AssertionError("positions are u32: 2^32 chars max per sequence")


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


def _merge_spans(parts, starts, mode, k, w, hasher, codes, ambiguous):
    """The JAX package's span merge: syncmer spans concatenate; the others
    drop a span's first value where the seam dedups it, with the index plane
    of super-k-mers in lockstep. parts are device tensors or numpy arrays."""
    if len(parts) == 1:
        return parts[0]
    if mode in pipeline.SYNCMER_MODES:
        return concat(parts)
    if mode == pipeline.MODE_SUPERKMERS:
        return merge_adjacent_shards([p[0] for p in parts], starts, codes, k, w, hasher,
                                     ambiguous, aux=[p[1] for p in parts])
    return merge_adjacent_shards(parts, starts, codes, k, w, hasher, ambiguous)


def _submit_spans(wave: _LaunchWave, key, chars: torch.Tensor, n: int,
                  plane: torch.Tensor | None, per: int, span_chars: int, k: int, w: int,
                  tables, rot: int, canonical: bool, **kw) -> list[int]:
    """Queue on `wave`, under `key`, one launch per span of a sequence of n
    chars (`span_bounds`): a view of `chars` (`per` chars per byte) and of
    the 1-bit `plane`, launched with its first char as the offset (`kw`:
    minimizer_tiles' keywords). Returns the spans' first windows."""
    l = k + w - 1
    bounds = span_bounds(n, l, span_chars)
    for s, m in bounds:
        sub = convert.span(chars, s, s + m, per)
        amb = None if plane is None else convert.span(plane, s, s + m, 8)
        wave.submit(key, _LaunchWave.launch_footprint(m, l, wave.mode),
                    lambda: _fused_launch(sub, m, k, w, tables, rot, canonical, wave.mode, amb,
                                          offset=s, **kw))
    return [s for s, _ in bounds]


def sketch_long(chars: torch.Tensor, n: int, k: int, w: int, hasher,
                mode: str = pipeline.MODE_MINIMIZERS, ambiguous: torch.Tensor | None = None, *,
                text: bool = False, byte_codes: bool = False, span_chars: int = SPAN_CHARS,
                wave_bytes: int = 0):
    """`fused_sketch` of a sequence of up to 2^32 chars, in spans of at most
    span_chars chars (`span_bounds`) that are views of `chars` and of the
    plane `ambiguous`, each launched with its first char as the offset, then
    merged at the seams (`merge_adjacent_shards`). Results stay on
    chars.device as int32 tensors holding u32 bits. `wave_bytes` is the
    launch wave's budget (0: eager, each span harvested before the next is
    launched)."""
    check_sequence_length(n)
    l = k + w - 1
    (kind, canonical, rot), tables = convert.hasher_tensors(hasher, chars.device, text)
    kw = {"text": text, "kind": kind, "byte_codes": byte_codes}
    if n <= span_chars or n < l:
        return fused_sketch(chars, n, k, w, tables, rot, canonical, mode, ambiguous, **kw)
    per = 1 if text or byte_codes else 4
    parts = []
    wave = _LaunchWave(mode, lambda _key, res: parts.append(res), wave_bytes)
    starts = _submit_spans(wave, None, chars, n, ambiguous, per, span_chars, k, w, tables, rot,
                           canonical, **kw)
    wave.flush()
    return _merge_spans(parts, starts, mode, k, w, hasher, _SeamChars(chars, per, text),
                        None if ambiguous is None else _SeamChars(ambiguous, 8))


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
                   device: torch.device | str = "cuda", span_chars: int = SPAN_CHARS,
                   wave_bytes: int = 4 << 30):
    """Per-record results (positions, or (positions, super-k-mer indices);
    record-local np.uint32; empty below one window) of many sequences of
    uint8 codes (2-bit codes if `dna`, text bytes if not; None probes each
    record), with the per-record masks `ambiguous` (None entries allowed).

    Each record is uploaded once as bytes and cut into spans like
    `sketch_long` (on the CPU spans of at most
    chunked.PIPELINE_CHUNK_WINDOWS windows, which bound the plain version's
    memory: ops/chunked.py); the launches of all records go through one
    `_LaunchWave` of `wave_bytes` (default 4 GiB, the JAX package's
    SMTPU_RECORDS_WAVE_BYTES), and each harvested span comes down through
    pinned host memory on a side stream while the next launches run.
    Bit-identical to sketching each record alone.
    """
    return sketch_records_checked(records, k, w, hasher, mode,
                                  record_masks(records, ambiguous, mode), dna=dna,
                                  device=device, span_chars=span_chars, wave_bytes=wave_bytes)


def sketch_records_checked(records, k: int, w: int, hasher, mode: str, masks: list, *,
                           dna: bool | None, device: torch.device | str, span_chars: int,
                           wave_bytes: int):
    """`sketch_records` with `masks` as `record_masks` returns them."""
    l = k + w - 1
    nrec = len(records)
    device = require_cuda(device)
    if device.type == "cpu":
        from . import chunked  # chunked imports this module

        span_chars = min(span_chars, chunked.span_chars(l))
    copies = torch.cuda.Stream(device) if device.type == "cuda" else None
    rec_parts = [[] for _ in range(nrec)]
    wave = _LaunchWave(mode, lambda ri, res: rec_parts[ri].append(convert.Download(res, copies)),
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
        starts[ri] = _submit_spans(wave, ri, chars, n, plane, 1, span_chars, k, w, tables, rot,
                                   canonical, text=text, kind=kind, byte_codes=not text)
    wave.flush()
    empty = np.zeros(0, np.uint32)
    out = []
    with stage("seam merge"):
        for ri, rec in enumerate(records):
            if not rec_parts[ri]:
                out.append((empty, empty) if mode == pipeline.MODE_SUPERKMERS else empty)
                continue
            out.append(_merge_spans([d.result() for d in rec_parts[ri]], starts[ri], mode, k, w,
                                    hasher, _SeamChars(rec, 1, texts[ri]), masks[ri]))
    return out
