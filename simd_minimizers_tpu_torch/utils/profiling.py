"""Device timing with CUDA events, profiler traces, the steady-state time
of an enqueued call, the wall time of an entry point split into its host
and device stages, and the port's spans and counters.

`trace` and `timed_amortized` are the counterparts of the JAX package's
`utils/profiling.py`: a torch.profiler trace in place of a jax.profiler
one, and a synchronize of the card in place of a fetch of a scalar.

Spans: `span(name)` marks a step of the port as `smt.<name>` in the
timeline of any torch.profiler session that is recording (`trace`, say),
beside the card's kernels and copies and on the same clock; `stage(name)`
is a span that an open `split_wall` also times. With no profiler recording
and no `split_wall` open a span checks one flag and records nothing, and
no span waits for the card. The recording profiler is the only switch.

Counters, always on: `SYNCS[site]` counts the times the port blocks the
host on the card at `site`, `BUS_BYTES[kind]` the bytes it moves between
host and card, by direction and host memory ("h2d pageable", "h2d pinned",
"d2h pinned", "d2h pageable"). A site counts whether it runs on a card or
on the CPU, where nothing crosses a bus, so the CPU tests hold the counts of
each route; where the CPU takes another route, it counts that route's (the
short path's plain kernels count `totals readback` and pageable bytes, its
graph on a card `short wait` and pinned ones). `DEFLATE` counts the
blocks, workers and bytes of the compressed .npz writes (`utils/npz.py`,
`count_deflate`); `STAGED` the pieces, workers and bytes of the read
matrices staged through pinned buffers (`convert.staged_rows`,
`count_staged`), whose waits on a buffer's last copy count at the site
`staging wait`. `PROFILED` holds what the calls made while a profiler
recorded counted inside the port's spans, and the seconds in each span:
only the benchmark's readers read it (ROADMAP A2c takes it out). Like
`ops.fused.LAUNCHES` they take no lock: calls from several threads at once
may lose a count."""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

try:
    from torch._C._profiler import _RecordFunctionFast as _Record  # ~1 us a span
except ImportError:  # an older PyTorch: the public annotation, ~13 us a span
    from torch.autograd.profiler import record_function as _Record

SPAN_PREFIX = "smt."
SYNCS: collections.Counter = collections.Counter()  # site -> host waits on the card
BUS_BYTES: collections.Counter = collections.Counter()  # kind -> bytes moved
# the compressed .npz writes (utils/npz.py): "blocks" deflated, "workers"
# (the pool of each write, summed), "bytes in" and "bytes out" of deflate
DEFLATE: collections.Counter = collections.Counter()
# the staged uploads of read matrices (convert.staged_rows): "pieces" copied
# into pinned buffers, "workers" (the threads of each upload, summed), "bytes"
STAGED: collections.Counter = collections.Counter()
# while a profiler recorded: "syncs", "bus_bytes", "deflate" and "staged" as
# above, "span_s" seconds by span name (without the prefix)
PROFILED = {"syncs": collections.Counter(), "bus_bytes": collections.Counter(),
            "deflate": collections.Counter(), "staged": collections.Counter(),
            "span_s": collections.Counter()}
recording = torch._C._autograd._profiler_enabled  # a torch.profiler session records
_OFF = contextlib.nullcontext()
_open_spans = 0  # spans open in a recording profiler
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


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block, CPU and (with a card) CUDA
    activity, exported on exit as a Chrome trace into `logdir` (made if
    missing). Yields the trace file's path, which exists once the block has
    ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        _sync()
    prof.export_chrome_trace(path)


def timed_amortized(fn, reps: int = 5, probes: int = 3) -> float:
    """Steady-state seconds per `fn()` call with the fixed cost of one
    synchronisation cancelled: batches of 1 and of reps + 1 calls are
    enqueued back to back and end in one synchronize of the card (none on
    the CPU), and a call takes (t_many - t_one) / reps, each the least of
    `probes` batches (`probes - 1` of the long ones)."""
    fn()  # build and warm
    _sync()

    def batch(m: int) -> float:
        t0 = time.perf_counter()
        for _ in range(m):
            fn()
        _sync()
        return time.perf_counter() - t0

    t_one = min(batch(1) for _ in range(probes))
    t_many = min(batch(reps + 1) for _ in range(max(probes - 1, 1)))
    return max((t_many - t_one) / reps, 1e-9)


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


def count_sync(site: str, times: int = 1) -> None:
    """`times` host waits on the card at `site`."""
    SYNCS[site] += times
    if _open_spans:
        PROFILED["syncs"][site] += times


def count_bytes(kind: str, nbytes: int) -> None:
    """`nbytes` moved between host and card, of `kind` (BUS_BYTES)."""
    BUS_BYTES[kind] += nbytes
    if _open_spans:
        PROFILED["bus_bytes"][kind] += nbytes


def count_deflate(counts: dict) -> None:
    """One compressed write's blocks, workers and bytes in and out
    (DEFLATE); no bus traffic, so never in BUS_BYTES."""
    DEFLATE.update(counts)
    if _open_spans:
        PROFILED["deflate"].update(counts)


def count_staged(counts: dict) -> None:
    """One staged upload's pieces, workers and bytes (STAGED); the bytes
    are counted in BUS_BYTES too, as "h2d pinned", by the caller."""
    STAGED.update(counts)
    if _open_spans:
        PROFILED["staged"].update(counts)


class _Span:
    """A span in the recording profiler's timeline, its seconds into
    PROFILED["span_s"]; while one is open the counts go to PROFILED too."""

    __slots__ = ("name", "record", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _open_spans
        _open_spans += 1
        self.record = _Record(SPAN_PREFIX + self.name)
        self.record.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        global _open_spans
        PROFILED["span_s"][self.name] += time.perf_counter() - self.t0
        _open_spans -= 1
        return self.record.__exit__(*exc)


def span(name: str):
    """A step of the port, `smt.<name>` in a recording profiler's timeline;
    nothing without one. It never waits for the card, and `split_wall`
    does not see it."""
    return _Span(name) if recording() else _OFF


def stage(name: str):
    """One stage of an entry point (a host step, an upload, the kernels, a
    download): a `span`, and timed into the open `split_wall` if there is
    one. A stage inside another is charged to the outer one."""
    return span(name) if _stages is None else _timed_stage(name)


@contextlib.contextmanager
def _timed_stage(name: str):
    global _in_stage
    if _in_stage:
        with span(name):
            yield
        return
    _sync()
    _in_stage = True
    t = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _sync()
        _in_stage = False
        _stages[name] = _stages.get(name, 0.0) + time.perf_counter() - t
