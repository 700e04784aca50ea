"""The Hopper minimizer kernels' wrappers, their launch counts and their
geometry gate.

Counterpart of `simd_minimizers_tpu/ops/fused.py` (`fused_supported`,
`_invoke_pallas`, `_fused_launch`, `_fused_harvest`, `fused_sketch`). The
kernels are `csrc/minimizers.cu`; see its header for the design. They read
the plain 2-bit byte stream, so the TPU's row-striped repack has no
counterpart here.

`fused_sketch` chains three wrappers, one per kernel: `minimizer_tiles`,
`tile_offsets` and `tile_append`. On a CUDA tensor each launches its kernel
or raises; on a CPU tensor each runs its plain version (`ops/pipeline.py`).
"""

from __future__ import annotations

import torch

from . import _build, pipeline

TILE = 4096  # windows per thread block; csrc/minimizers.cu TILE
# dynamic shared memory one block may use on Hopper: 227 KiB less the
# kernel's static shared memory (48 B, rounded up)
_SMEM_MAX = 232448 - 64
_KEY_COLUMNS = 1 << 16  # the packed (top16 | column) key keeps 16 column bits

# Launches per kernel, counted where each is launched (CUDA tensors only).
LAUNCHES = {"minimizer_tiles<canonical>": 0, "minimizer_tiles<forward>": 0,
            "tile_offsets": 0, "tile_append": 0}

_ready_devices: set[int] = set()


def _tile_smem_bytes(k: int, w: int, canonical: bool) -> int:
    """Mirror of csrc/minimizers.cu tile_smem_bytes."""
    l = k + w - 1
    chars = (TILE + l + 6) // 4 * 4
    return (chars + 15) // 16 * 16 + (2 if canonical else 1) * (TILE + w) * 4


def fused_supported(k: int, w: int, canonical: bool = True) -> bool:
    """Whether the kernel's geometry covers (k, w): every k-mer column of a
    tile (TILE + w of them) fits the key's 16 bits, and the tile's chars and
    keys fit one block's shared memory."""
    return (k >= 1 and w >= 1 and TILE + w <= _KEY_COLUMNS
            and _tile_smem_bytes(k, w, canonical) <= _SMEM_MAX)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _library(device: torch.device):
    """The kernel library, set up once per card (TILE agreement, the
    kernels' shared-memory limit)."""
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


def minimizer_tiles(words: torch.Tensor, n: int, k: int, w: int, table: torch.Tensor,
                    rot_offset: int, canonical: bool):
    """Kernel 1: (scratch, counts) for the first n bases of the 2-bit byte
    stream `words` (uint8) with the nt table tensor `table` (int64,
    convert.hasher_tensors). Tile t of TILE windows leaves its kept
    positions in scratch[t * TILE:][:counts[t]] (int32)."""
    if words.dtype != torch.uint8:
        raise TypeError(f"words must be uint8, got {words.dtype}")
    if n >= 1 << 31:
        raise NotImplementedError("inputs of 2^31 bases or more (sketch_long) are ROADMAP A4")
    l = k + w - 1
    if canonical and l % 2 == 0:
        raise ValueError(f"window length l={l} must be odd to determine strand")
    if not fused_supported(k, w, canonical):
        raise NotImplementedError(
            f"k={k}, w={w} is beyond the kernel's geometry (fused_supported); "
            "wider geometry is ROADMAP A3")
    if _device_kind(words) == "cpu":
        return pipeline.minimizer_tiles_plain(words, n, k, w, table, rot_offset, canonical, TILE)
    if not (words.is_contiguous() and table.is_contiguous()):
        raise ValueError("words and table must be contiguous")
    if words.numel() * 4 < n or table.numel() != 4 or table.dtype != torch.int64:
        raise ValueError("words must hold n bases and table four int64 entries")
    if table.device != words.device:
        raise ValueError("table and words must be on one device")
    dev = words.device
    ntiles = -(-max(n - l + 1, 0) // TILE)
    scratch = torch.empty(ntiles * TILE, dtype=torch.int32, device=dev)
    counts = torch.empty(ntiles, dtype=torch.int32, device=dev)
    if ntiles == 0:  # no window: nothing to launch
        return scratch, counts
    lib = _library(dev)
    _check(lib.smt_minimizer_tiles(dev.index, words.data_ptr(), words.numel(), n, k, w,
                                   int(canonical), table.data_ptr(), rot_offset,
                                   scratch.data_ptr(), counts.data_ptr(), ntiles,
                                   torch.cuda.current_stream(dev).cuda_stream),
           "minimizer_tiles")
    LAUNCHES["minimizer_tiles<canonical>" if canonical else "minimizer_tiles<forward>"] += 1
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
    """Kernel 3: each tile's run of scratch at its offset; (total,) int32."""
    _require_int32(scratch, counts, offsets)
    if _device_kind(scratch) == "cpu":
        return pipeline.tile_append_plain(scratch, counts, offsets, total, TILE)
    if scratch.numel() != counts.numel() * TILE or offsets.numel() != counts.numel() + 1:
        raise ValueError("scratch, counts and offsets disagree on the tile count")
    out = torch.empty(total, dtype=torch.int32, device=scratch.device)
    if total == 0:
        return out
    lib = _library(scratch.device)
    _check(lib.smt_tile_append(scratch.device.index, scratch.data_ptr(), counts.data_ptr(),
                               offsets.data_ptr(), counts.numel(), out.data_ptr(),
                               torch.cuda.current_stream(scratch.device).cuda_stream),
           "tile_append")
    LAUNCHES["tile_append"] += 1
    return out


def fused_sketch(words: torch.Tensor, n: int, k: int, w: int, table: torch.Tensor,
                 rot_offset: int, canonical: bool) -> torch.Tensor:
    """Minimizer positions (int32, on words.device) of the first n bases of
    the 2-bit byte stream `words` (uint8) with the nt table tensor `table`
    (int64, convert.hasher_tensors).

    A CUDA tensor goes through the three kernels, a CPU tensor through their
    plain versions; any other device raises. Fewer than l = k + w - 1 bases
    give an empty result without a launch.
    """
    scratch, counts = minimizer_tiles(words, n, k, w, table, rot_offset, canonical)
    offsets = tile_offsets(counts)
    total = int(offsets[-1])  # the one 4-byte device-to-host copy
    return tile_append(scratch, counts, offsets, total)
