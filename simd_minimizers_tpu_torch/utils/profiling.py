"""Device timing with CUDA events."""

from __future__ import annotations

import torch


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds of device time per `fn()` call: CUDA events around
    `reps` back-to-back calls on the current stream, after `warmup` calls.
    `fn` must do its work on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA card")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
