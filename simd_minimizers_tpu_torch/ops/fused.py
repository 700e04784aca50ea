"""The Hopper minimizer kernels' wrappers, their launch counts and their
geometry gate.

Counterpart of `simd_minimizers_tpu/ops/fused.py` (`fused_supported`,
`_invoke_pallas`, `_fused_launch`, `_fused_harvest`, `fused_sketch`). The
kernels are `csrc/minimizers.cu`; see its header for the design. They read
the plain 2-bit byte stream or the raw text bytes, so the TPU's row- and
byte-striped repacks have no counterpart here.

`fused_sketch` chains three wrappers, one per kernel: `minimizer_tiles`,
`tile_offsets` and `tile_append`. On a CUDA tensor each launches its kernel
or raises; on a CPU tensor each runs its plain version (`ops/pipeline.py`).
`minimizer_tiles` has one kernel instance per strand, mode family
(minimizers, super-k-mers, syncmers) and ambiguity plane (none for
super-k-mers), each with its own count in `LAUNCHES`. The input kind (2-bit
DNA or text) and the hasher (the nt / mul fold over per-char tables, or
antilex) are block-uniform arguments of every instance.
"""

from __future__ import annotations

import torch

from .. import convert
from . import _build, pipeline

TILE = 4096  # windows per thread block; csrc/minimizers.cu TILE
# dynamic shared memory one block may use on Hopper: 227 KiB less the
# kernel's static shared memory (the scan's warp sums, 32 B)
_SMEM_MAX = 232448 - 32
_KEY_COLUMNS = 1 << 16  # the packed (top16 | column) key keeps 16 column bits

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
# entry: super-k-mers have none with an ambiguity plane.
LAUNCHES = {instance_name(c, m, a): 0
            for m, a in [(pipeline.MODE_MINIMIZERS, False), (pipeline.MODE_MINIMIZERS, True),
                         (pipeline.MODE_SUPERKMERS, False),
                         (pipeline.MODE_CLOSED_SYNCMERS, False),
                         (pipeline.MODE_CLOSED_SYNCMERS, True)]
            for c in (True, False)}
LAUNCHES.update({"tile_offsets": 0, "tile_append": 0})

_ready_devices: set[int] = set()


def _tile_smem_bytes(k: int, w: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                     ambiguous: bool = False, text: bool = False, kind: str = "nt") -> int:
    """Mirror of csrc/minimizers.cu tile_smem_bytes: the tile's chars, its
    keys (whose space also stages one TILE-word plane per output plane),
    with an ambiguity plane the tile's ambiguity bits in 32-bit words, and
    the fold's forward and complement tables (none for antilex)."""
    l = k + w - 1
    chars = (TILE + l + 6) // 4 * 4
    keys = max((2 if canonical else 1) * (TILE + w),
               (2 if mode == pipeline.MODE_SUPERKMERS else 1) * TILE)
    amb = (TILE + l + 62) // 32 * 4 if ambiguous else 0
    tables = 0 if kind == "antilex" else 2 * 4 * convert.TABLE_ENTRIES[text]
    return (chars + 15) // 16 * 16 + 4 * keys + amb + tables


def fused_supported(k: int, w: int, canonical: bool = True, mode: str = pipeline.MODE_MINIMIZERS,
                    ambiguous: bool = False, text: bool = False, kind: str = "nt") -> bool:
    """Whether the kernel's geometry covers (k, w): every k-mer column of a
    tile (TILE + w of them) fits the key's 16 bits, and the tile's chars,
    keys, ambiguity bits and tables fit one block's shared memory."""
    return (k >= 1 and w >= 1 and TILE + w <= _KEY_COLUMNS
            and _tile_smem_bytes(k, w, canonical, mode, ambiguous, text, kind) <= _SMEM_MAX)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _library(device: torch.device):
    """The kernel library, set up once per card (TILE agreement, every
    minimizer_tiles instance's shared-memory limit)."""
    lib = _build.library()
    if device.index not in _ready_devices:
        if lib.smt_tile_windows() != TILE:
            raise RuntimeError("csrc/minimizers.cu TILE disagrees with ops/fused.py TILE")
        _check(lib.smt_init(device.index), "smt_init")
        _ready_devices.add(device.index)
    return lib


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


def minimizer_tiles(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                    rot_offset: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                    ambiguous: torch.Tensor | None = None, *, text: bool = False,
                    kind: str = "nt"):
    """Kernel 1: (scratch, counts) for the first n chars of `chars` (uint8:
    the 2-bit byte stream of convert.packed_words, or with `text` the bytes
    of convert.text_bytes), hashed by `kind` (the nt or mul fold over the
    per-char `tables` of convert.hasher_tensors, or antilex, which takes
    None) in `mode`, skipping the windows that hold a char flagged in the
    1-bit plane `ambiguous` (uint8, convert.ambiguity_plane) if one is
    given. Tile t of TILE windows leaves its kept values in
    scratch[..., t * TILE:][:counts[t]] (int32): positions (minimizers),
    window indices (syncmers), or both as the two rows of a
    (2, ntiles * TILE) scratch (super-k-mers)."""
    if chars.dtype != torch.uint8:
        raise TypeError(f"chars must be uint8, got {chars.dtype}")
    if mode not in _KERNEL_MODE:
        raise ValueError(f"unknown mode {mode!r}")
    pipeline.assert_no_superkmer_ambiguity(mode, ambiguous is not None)
    if ambiguous is not None and (ambiguous.dtype != torch.uint8
                                  or ambiguous.device != chars.device):
        raise ValueError("ambiguous must be a uint8 tensor on the device of chars")
    if n >= 1 << 31:
        raise NotImplementedError("inputs of 2^31 chars or more (sketch_long) are ROADMAP A4")
    l = k + w - 1
    if canonical and l % 2 == 0:
        raise ValueError(f"window length l={l} must be odd to determine strand")
    if not fused_supported(k, w, canonical, mode, ambiguous is not None, text, kind):
        raise NotImplementedError(
            f"k={k}, w={w} is beyond the kernel's geometry (fused_supported); "
            "wider geometry is ROADMAP A3")
    _check_tables(tables, kind, text)
    if _device_kind(chars) == "cpu":
        return pipeline.minimizer_tiles_plain(chars, n, k, w, tables, rot_offset, canonical, TILE,
                                              mode, ambiguous, text=text, kind=kind)
    if not chars.is_contiguous() or (tables is not None and not tables.is_contiguous()):
        raise ValueError("chars and tables must be contiguous")
    if chars.numel() * (1 if text else 4) < n:
        raise ValueError(f"chars must hold n={n} chars")
    if tables is not None and tables.device != chars.device:
        raise ValueError("tables and chars must be on one device")
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
    lo, hi = pipeline.syncmer_offsets(mode, w)
    _check(lib.smt_minimizer_tiles(
        dev.index, chars.data_ptr(), chars.numel(), n, k, w, int(canonical), _KERNEL_MODE[mode],
        int(text), int(kind == "antilex"), None if tables is None else tables.data_ptr(),
        rot_offset, None if ambiguous is None else ambiguous.data_ptr(),
        0 if ambiguous is None else ambiguous.numel(), lo, hi, scratch.data_ptr(),
        counts.data_ptr(), ntiles, torch.cuda.current_stream(dev).cuda_stream),
        "minimizer_tiles")
    LAUNCHES[instance_name(canonical, mode, ambiguous is not None)] += 1
    return scratch, counts


def tile_offsets(counts: torch.Tensor) -> torch.Tensor:
    """Kernel 2: the exclusive scan of `counts` with the total behind it,
    (ntiles + 1,) int32 (the running total the TPU kernel kept in SMEM)."""
    _require_int32(counts)
    if _device_kind(counts) == "cpu":
        return pipeline.tile_offsets_plain(counts)
    ntiles = counts.numel()
    if ntiles == 0:
        return torch.zeros(1, dtype=torch.int32, device=counts.device)
    offsets = torch.empty(ntiles + 1, dtype=torch.int32, device=counts.device)
    lib = _library(counts.device)
    _check(lib.smt_tile_offsets(counts.device.index, counts.data_ptr(), ntiles,
                                offsets.data_ptr(),
                                torch.cuda.current_stream(counts.device).cuda_stream),
           "tile_offsets")
    LAUNCHES["tile_offsets"] += 1
    return offsets


def tile_append(scratch: torch.Tensor, counts: torch.Tensor, offsets: torch.Tensor,
                total: int) -> torch.Tensor:
    """Kernel 3: each tile's run of scratch at its offset: (total,) int32,
    or (2, total) for the two-plane scratch of super-k-mers, both planes
    with the one set of offsets."""
    _require_int32(scratch, counts, offsets)
    if _device_kind(scratch) == "cpu":
        return pipeline.tile_append_plain(scratch, counts, offsets, total, TILE)
    if (scratch.dim() not in (1, 2) or scratch.shape[-1] != counts.numel() * TILE
            or offsets.numel() != counts.numel() + 1):
        raise ValueError("scratch, counts and offsets disagree on the tile count")
    planes = scratch.shape[0] if scratch.dim() == 2 else 1
    out = torch.empty(*scratch.shape[:-1], total, dtype=torch.int32, device=scratch.device)
    if total == 0:
        return out
    lib = _library(scratch.device)
    _check(lib.smt_tile_append(scratch.device.index, scratch.data_ptr(), counts.data_ptr(),
                               offsets.data_ptr(), counts.numel(), planes, out.data_ptr(),
                               torch.cuda.current_stream(scratch.device).cuda_stream),
           "tile_append")
    LAUNCHES["tile_append"] += 1
    return out


def fused_sketch(chars: torch.Tensor, n: int, k: int, w: int, tables: torch.Tensor | None,
                 rot_offset: int, canonical: bool, mode: str = pipeline.MODE_MINIMIZERS,
                 ambiguous: torch.Tensor | None = None, *, text: bool = False,
                 kind: str = "nt"):
    """int32 positions (window indices for syncmers), on chars.device, of
    the first n chars of `chars` (as in `minimizer_tiles`), skipping the
    windows that hold a char flagged in the 1-bit plane `ambiguous`; for
    super-k-mers (positions, first-window indices) (counterpart of
    `_fused_harvest`).

    A CUDA tensor goes through the three kernels, a CPU tensor through their
    plain versions; any other device raises. Fewer than l = k + w - 1 chars
    give an empty result without a launch.
    """
    scratch, counts = minimizer_tiles(chars, n, k, w, tables, rot_offset, canonical, mode,
                                      ambiguous, text=text, kind=kind)
    offsets = tile_offsets(counts)
    total = int(offsets[-1])  # the one 4-byte device-to-host copy
    out = tile_append(scratch, counts, offsets, total)
    return (out[0], out[1]) if mode == pipeline.MODE_SUPERKMERS else out
