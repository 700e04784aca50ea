"""k-mer values on the card: the `kmer_values` kernel's wrapper, its plain
PyTorch version, and the drivers that return NumPy arrays.

Counterpart of `simd_minimizers_tpu/ops/device_values.py`
(`values_limbs_jnp`, `kmer_values_u64`, `kmer_values_u128_limbs`), which
the JAX package runs as plain XLA. The kernel is `csrc/values.cu` (see its
header): two positions a thread (one at L = 4), each row stored whole, the
value assembled from words of the sequence as the sketch read it on the
card (positions in any order), the 2-bit byte stream of
`convert.packed_words` or, with `byte_codes`, one 2-bit code a byte
(`convert.code_bytes`). The JAX package's word stream is the little-endian
u32 view of the same byte stream, so no repack is needed.

Value convention pinned by the reference doc-test (the crate's
src/lib.rs:117-129): first base in the lowest bits, 2 bits a char; the
complement of a code is c ^ 2; canonical values are the least of the
forward value and the reverse complement's (src/lib.rs:598-612).
Bit-identical to `ops/values.py` and to the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import _build
from .fused import LAUNCHES  # the kernel's launches under "kmer_values" (CUDA tensors only)

MASK32 = 0xFFFF_FFFF


def limb_count(k: int) -> int:
    """u32 limbs of a 2-bit k-mer value: ceil(2k / 32)."""
    return -(-2 * k // 32)


def _check(chars: torch.Tensor, positions: torch.Tensor, k: int) -> None:
    if not 1 <= k <= 64:  # the JAX package's assertion (values_limbs_jnp)
        raise AssertionError("2-bit values support k <= 64 (u128 limbs)")
    if chars.dtype != torch.uint8:
        raise TypeError(f"chars must be uint8, got {chars.dtype}")
    if positions.dtype != torch.int32 or positions.dim() != 1:
        raise ValueError(f"positions must be a 1-d int32 tensor, got {positions.dtype} "
                         f"of shape {tuple(positions.shape)}")
    if positions.device != chars.device:
        raise ValueError("positions and chars must be on one device")
    if chars.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {chars.device}")


def kmer_values_limbs(chars: torch.Tensor, positions: torch.Tensor, k: int,
                      canonical: bool = False, byte_codes: bool = False) -> torch.Tensor:
    """(m, L) int32 limbs (u32 bits; L = ceil(2k / 32)) of the values of the
    k-mers (1 <= k <= 64) at `positions` (int32 holding u32 bits) of the
    sequence in `chars` (uint8: the 2-bit byte stream, or with `byte_codes`
    one 2-bit code a byte); limb j holds value bits [32j, 32j + 32). Chars
    past the buffer read as 0.

    A CUDA tensor goes to the kernel (counted in LAUNCHES outside a CUDA-graph
    capture); a failed build or launch raises. A CPU tensor goes to
    `kmer_values_limbs_plain`."""
    _check(chars, positions, k)
    if chars.device.type == "cpu":
        return kmer_values_limbs_plain(chars, positions, k, canonical, byte_codes)
    m = positions.numel()
    out = torch.empty(m, limb_count(k), dtype=torch.int32, device=chars.device)
    if m == 0:
        return out
    if not (chars.is_contiguous() and positions.is_contiguous()) or chars.numel() == 0:
        raise ValueError("chars and positions must be contiguous, and chars not empty")
    err = _build.library().smt_kmer_values(
        chars.device.index, chars.data_ptr(), chars.numel(), positions.data_ptr(), m, k,
        int(canonical), int(byte_codes), out.data_ptr(),
        torch.cuda.current_stream(chars.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmer_values failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["kmer_values"] += 1
    return out


def _words(chars: torch.Tensor, byte_codes: bool) -> torch.Tensor:
    """The sequence as little-endian u32 words (int64), base i at bit
    2 * (i % 16) of word i // 16, with one zero word behind them."""
    per, shift, vals = (16, 2, chars & 3) if byte_codes else (4, 8, chars)
    cols = torch.cat([vals, vals.new_zeros(-vals.numel() % per + per)]).view(-1, per)
    words = torch.zeros(cols.shape[0], dtype=torch.int64, device=chars.device)
    for i in range(per):  # a column at a time: 8 bytes a word of int64 at the peak
        words |= cols[:, i].to(torch.int64) << (shift * i)
    return words


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """The sixteen 2-bit groups of each u32 (in int64) in reverse order."""
    x = ((x >> 16) | (x << 16)) & MASK32
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    return ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)


def kmer_values_limbs_plain(chars: torch.Tensor, positions: torch.Tensor, k: int,
                            canonical: bool = False, byte_codes: bool = False) -> torch.Tensor:
    """The plain PyTorch version of `kmer_values_limbs`, on any device: the
    JAX package's `values_limbs_jnp` with u32 values in int64 (torch's
    uint32 lacks shifts and compares on the CPU), gathers clipped to a zero
    word past the sequence."""
    _check(chars, positions, k)
    L = limb_count(k)
    words = _words(chars, byte_codes)
    pos = positions.to(torch.int64) & MASK32
    wi = pos >> 4
    sh = 2 * (pos & 15)
    g = [words[(wi + j).clamp(max=words.numel() - 1)] for j in range(L + 1)]
    # (a >> sh) | (b << (32 - sh)); the second term is 0 at sh = 0
    limbs = [((g[j] >> sh) | torch.where(sh == 0, 0, g[j + 1] << (32 - sh))) & MASK32
             for j in range(L)]
    top_mask = (1 << (2 * k - 32 * (L - 1))) - 1
    limbs[-1] = limbs[-1] & top_mask
    if canonical:
        comp = [x ^ 0xAAAAAAAA for x in limbs]
        comp[-1] = comp[-1] & top_mask
        r = [_rev2(comp[L - 1 - j]) for j in range(L)] + [torch.zeros_like(limbs[0])]
        S = 32 * L - 2 * k
        rc = r[:L] if S == 0 else [((r[j] >> S) | (r[j + 1] << (32 - S))) & MASK32
                                   for j in range(L)]
        take = torch.zeros_like(limbs[0], dtype=torch.bool)
        eq = torch.ones_like(take)
        for j in reversed(range(L)):
            take |= eq & (rc[j] < limbs[j])
            eq &= rc[j] == limbs[j]
        limbs = [torch.where(take, rc[j], limbs[j]) for j in range(L)]
    out = torch.stack(limbs, dim=-1)
    return (out - ((out >> 31) << 32)).to(torch.int32)


def _host_words(chars: torch.Tensor, positions, k: int, canonical: bool,
                byte_codes: bool) -> np.ndarray:
    """(m, ceil(L / 2)) np.uint64 words of the values (lo, then hi for
    k > 32), computed on chars.device and brought back through pinned host
    memory (`convert.Download`) with no host copy: an odd limb count is
    padded with a zero limb on the device, and a row of two u32 limbs is
    lo | hi << 32. `positions` is a tensor on chars.device or a NumPy array
    of u32 positions, uploaded."""
    if not isinstance(positions, torch.Tensor):
        pos = np.ascontiguousarray(positions, dtype=np.uint32).view(np.int32)
        positions = convert.upload(pos, chars.device, "positions upload")
    limbs = kmer_values_limbs(chars, positions, k, canonical, byte_codes)
    if limbs.shape[1] % 2:
        limbs = torch.nn.functional.pad(limbs, (0, 1))
    return convert.Download(limbs).result().view("<u8")


def kmer_values_u64(chars: torch.Tensor, positions, k: int, canonical: bool = False,
                    byte_codes: bool = False) -> np.ndarray:
    """np.uint64 values of the k-mers (k <= 32) at `positions`, computed on
    chars.device (`kmer_values_limbs`'s arguments)."""
    if k > 32:  # the JAX package's assertion (device_values.kmer_values_u64)
        raise AssertionError("values_u64 requires 2*k <= 64")
    return _host_words(chars, positions, k, canonical, byte_codes).reshape(-1)


def kmer_values_u128_limbs(chars: torch.Tensor, positions, k: int, canonical: bool = False,
                           byte_codes: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) np.uint64 limb arrays of the values of the k-mers (k <= 64)
    at `positions`, computed on chars.device."""
    words = _host_words(chars, positions, k, canonical, byte_codes)
    if words.shape[1] == 1:
        return words[:, 0], np.zeros(words.shape[0], np.uint64)
    return words[:, 0], words[:, 1]
