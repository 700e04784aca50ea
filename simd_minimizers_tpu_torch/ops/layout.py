"""Lane-matrix layout and windowed reductions, in PyTorch.

Counterpart of `simd_minimizers_tpu/ops/layout.py`. Only the plain version
of the kernel (`ops/pipeline.py`) uses these. u32 values are carried in
int64 tensors: PyTorch's uint32 lacks shifts, adds and minima on the CPU.
"""

from __future__ import annotations

import torch


def build_lane_matrix(flat: torch.Tensor, R: int, C: int, span: int) -> torch.Tensor:
    """(R, span) matrix with M[r, j] = flat[r * C + j].

    Requires len(flat) >= (R + ceil((span - C) / C)) * C.
    """
    body = flat[: R * C].reshape(R, C)
    if span <= C:
        return body[:, :span]
    h = span - C
    nblocks = -(-h // C)
    assert flat.shape[0] >= (nblocks + R) * C, "flat under-padded for halo build"
    parts = [body]
    for b in range(nblocks):
        width = min(C, h - b * C)
        parts.append(flat[(b + 1) * C : (b + 1 + R) * C].reshape(R, C)[:, :width])
    return torch.cat(parts, dim=1)


def _windowed_fold(x: torch.Tensor, width: int, op) -> torch.Tensor:
    """out[r, i] = op(x[r, i], ..., x[r, i + width - 1]) by binary doubling;
    shape (R, S - width + 1)."""
    S = x.shape[1]
    out_len = S - width + 1
    assert out_len >= 1
    acc = None
    done = 0
    part = x
    d = 1
    while True:
        if width & d:
            seg = part[:, done : done + out_len]
            acc = seg if acc is None else op(acc, seg)
            done += d
        if d * 2 > width:
            break
        L = S - 2 * d + 1
        part = op(part[:, :L], part[:, d : d + L])
        d *= 2
    return acc


def windowed_xor(u: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row XOR over sliding windows of k: (R, S - k + 1)."""
    return _windowed_fold(u, k, torch.bitwise_xor)


def windowed_sum(bits: torch.Tensor, l: int) -> torch.Tensor:
    """Per-row sums over sliding windows of l: (R, S - l + 1) int32."""
    return _windowed_fold(bits.to(torch.int32), l, torch.add)


def window_min_cols_packed(hv: torch.Tensor, w: int, right_tie: bool) -> torch.Tensor:
    """Per-row sliding-window minimum columns of (top16 hash | column) keys.

    hv: (R, S) int64 holding TOP16-masked hashes, 0xFFFFFFFF for k-mers
    that must never win. For the rightmost arm the column is complemented.
    Returns (R, S - w + 1) int64 columns.
    """
    R, S = hv.shape
    assert S < (1 << 16), "packed-position min needs columns < 2^16"
    col = torch.arange(S, dtype=torch.int64, device=hv.device).expand(R, S)
    f = hv | (0xFFFF - col if right_tie else col)
    p = 1
    while p * 2 <= w:
        L = f.shape[1] - p
        f = torch.minimum(f[:, :L], f[:, p : p + L])
        p *= 2
    C = S - w + 1
    f = torch.minimum(f[:, :C], f[:, w - p : w - p + C])
    c16 = f & 0xFFFF
    return 0xFFFF - c16 if right_tie else c16
