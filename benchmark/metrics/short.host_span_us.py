"""Seconds in the program's `smt.short` span less those in its `smt.short
wait`, over the profiled window's calls, in microseconds: a call's own host
time, measured inside the program. It carries the profiler's cost of every
span and torch call it records (about 12 us a span on an H100's host, some
twice an unprofiled call's host time), so adding or dropping a span moves
it; `short.host_us` reads unprofiled calls."""

import program_counts


def read(obs):
    spans = program_counts.counts("span_s")
    if not spans.get("short") or not obs.window.calls:
        return None
    return (spans["short"] - spans.get("short wait", 0.0)) / obs.window.calls * 1e6
