"""The CUDA device check and the card's identity."""

from __future__ import annotations

import subprocess

import torch


def require_cuda(device: torch.device | str) -> torch.device:
    """`device` as a `torch.device`; raises RuntimeError for a CUDA device
    when this PyTorch sees no CUDA card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but torch.cuda.is_available() is False")
    return device


def card_info() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()
