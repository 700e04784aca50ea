"""Seconds in the program's `smt.short wait` span (the host waiting for the
call's copies out) over the profiled window's calls, in microseconds; 0
where the calls ran (`smt.short`) and none waited. Read in the traced
window: the profiler's cost of the spans opened before the wait (about 12
us a span on an H100's host) delays it, so the copies have mostly ended by
then and the wait reads short of an unprofiled call's."""

import program_counts


def read(obs):
    spans = program_counts.counts("span_s")
    if not spans.get("short") or not obs.window.calls:
        return None
    return spans.get("short wait", 0.0) / obs.window.calls * 1e6
