"""The traced window: a torch.profiler session around the timed loop, and
what the per-layer metrics read from its timeline.

The window is one user annotation, `WINDOW`; each call of the entry is
another, named after the entry. The device's busy time is the union of its
kernels, copies and sets inside the window; idle time is named after the
innermost host event open on the loop's thread meanwhile (a torch
operator, a CUDA runtime call, or the entry's own annotation where the
host runs code outside torch, such as NumPy).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "benchmark window"
PORT_KERNELS = ("minimizer_tiles", "tile_offsets", "tile_append", "kmer_top16", "kmer_values")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120  # of a name in the breakdown


@dataclasses.dataclass
class Timeline:
    window_s: float  # the annotated window, on the profiler's clock
    busy_s: float  # seconds of the window with a device operation running
    device_ops: dict  # device seconds by operation name
    idle_by_host: dict  # idle device seconds by what the host was doing
    port_kernel_s: float  # device seconds of the program's own kernels

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle_by_host)}


def short_name(name: str) -> str:
    """A device operation's name without a kernel's return type, namespace
    tag and arguments (a copy's or set's name is kept whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:NAME_CHARS]


def _union(intervals, lo: int, hi: int):
    """The merged intervals of (start, end) pairs, clipped to [lo, hi]."""
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host event (start, end, name) open
    while the device was idle: host events nest, so a stack swept in start
    order gives the innermost one at every moment; each gap (start, end)
    is split where it changes."""
    changes, stack = [], []  # (time, innermost name from then on)
    for a, b, name in sorted(host):
        while stack and stack[-1][1] <= a:
            end = stack.pop()[1]
            changes.append((end, stack[-1][2] if stack else None))
        stack.append((a, b, name))
        changes.append((a, name))
    while stack:
        end = stack.pop()[1]
        changes.append((end, stack[-1][2] if stack else None))
    times = [t for t, _ in changes]
    out = collections.defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, g0) - 1
        t = g0
        while t < g1:
            name = changes[i][1] if i >= 0 else None
            nxt = min(times[i + 1], g1) if i + 1 < len(times) else g1
            if nxt > t:
                out[name or "no host event"] += (nxt - t) / 1e9
                t = nxt
            i += 1
    return dict(out)


def read(prof) -> Timeline | None:
    """The timeline of a finished profile, or None without its window. The
    profile is read from its Chrome trace, written to a temporary file of
    TMPDIR and removed: its categories name every event's kind on every
    version of PyTorch."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    window = [e for e in events if e["name"] == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        return None
    def ns(us) -> int:  # the trace's clock counts microseconds
        return int(round(float(us) * 1e3))

    lo, hi = ns(window[0]["ts"]), ns(window[0]["ts"]) + ns(window[0]["dur"])
    thread = (window[0]["pid"], window[0]["tid"])
    dev, host = [], []
    ops = collections.defaultdict(float)
    port = 0.0
    for e in events:
        a = ns(e["ts"])
        b = a + ns(e.get("dur", 0))
        cat = e.get("cat")
        if cat in DEVICE_ACTIVITIES:
            if b <= lo or a >= hi:
                continue
            dev.append((a, b))
            ops[short_name(e["name"])] += (b - a) / 1e9
            if cat == "kernel" and any(k in e["name"] for k in PORT_KERNELS):
                port += (b - a) / 1e9
        elif (e["pid"], e["tid"]) == thread and e is not window[0]:
            host.append((a, b, e["name"]))
    busy = _union(dev, lo, hi)
    gaps, reach = [], lo
    for a, b in busy:
        if a > reach:
            gaps.append((reach, a))
        reach = b
    if hi > reach:
        gaps.append((reach, hi))
    return Timeline((hi - lo) / 1e9, sum(b - a for a, b in busy) / 1e9, dict(ops),
                    _label_gaps(gaps, host), port)
