"""Device timing with CUDA events, and the wall time of an entry point
split into its host and device stages."""

from __future__ import annotations

import contextlib
import time

import torch

_stages: dict[str, float] | None = None  # the open split_wall's totals, or None
_in_stage = False  # a stage is being timed


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


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def split_wall():
    """Collects the seconds of every `stage` run inside the block into the
    dict it yields (stage name -> total). While it is open each stage waits
    for the card before and after itself, so device work is charged to the
    stage that queued it and the overlap of copies with kernels is lost:
    the stages add up to the wall time of a serialised run."""
    global _stages
    if _stages is not None:
        raise RuntimeError("split_wall does not nest")
    _stages = totals = {}
    try:
        yield totals
    finally:
        _stages = None


@contextlib.contextmanager
def stage(name: str):
    """One stage of an entry point (a host step, an upload, the kernels, a
    download): timed into the open `split_wall`, else nothing. A stage
    inside another is charged to the outer one."""
    global _in_stage
    if _stages is None or _in_stage:
        yield
        return
    _sync()
    _in_stage = True
    t = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _in_stage = False
        _stages[name] = _stages.get(name, 0.0) + time.perf_counter() - t
