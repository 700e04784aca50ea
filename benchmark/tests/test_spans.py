"""Tests of the readers of the program's spans and counters: each reads
nothing without its input, reads what the program counted while the
profiler recorded (the profiled window's differences, no warm or staged
call), and a traced CPU run of each cell reports the metrics named for
it. On a hand-made trace, the idle breakdown names the innermost `smt.`
span of the program, or a torch event inside one.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import collections
import json
import sys
import time
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import plugins  # noqa: E402
import program_counts  # noqa: E402
import run  # noqa: E402
import tracing  # noqa: E402

from simd_minimizers_tpu_torch.utils import profiling  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
SEED = 2**31 + 978
NEW = {"genome.bus_bytes_per_base": "k21w11.genome-host",
       "resident.syncs_per_gbp": "k19w19.genome-resident",
       "genome.syncs_per_gbp": "k21w11.genome-host",
       "short.wait_us": "k21w11.short",
       "short.host_span_us": "k21w11.short"}
_FILE_TRAFFIC = run.load_traffic


def small_traffic(name: str) -> dict:
    spec = _FILE_TRAFFIC(name)
    return {**spec, **plugins.load("inputs", spec["inputs"]).small(spec),
            "sample": {**spec["sample"], "calls": 2}}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run, "load_traffic", small_traffic)
    clear()


def clear():
    for c in profiling.PROFILED.values():
        c.clear()


def obs(bases=2_000_000_000, calls=4):
    return types.SimpleNamespace(window=types.SimpleNamespace(bases=bases, calls=calls))


def test_new_metrics_are_declared_for_their_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name, cell in NEW.items():
        assert per_layer[name]["workloads"] == [cell]
    assert list(per_layer)[-len(NEW):] == list(NEW)  # appended, nothing before them moved


@pytest.mark.parametrize("name", list(NEW))
def test_reader_reads_nothing_without_its_input(name, monkeypatch):
    read = run.metric_reader(name)
    assert read(obs()) is None  # nothing counted under a profiler
    profiling.PROFILED["syncs"]["x"] = 3
    profiling.PROFILED["bus_bytes"]["h2d pinned"] = 3
    profiling.PROFILED["span_s"]["short"] = 1.0
    assert read(obs(bases=0, calls=0)) is None  # no call completed
    monkeypatch.delattr(profiling, "PROFILED")  # a program without the counts
    assert program_counts.counts("syncs") == {}
    assert read(obs()) is None


def test_readers_read_what_was_counted():
    profiling.PROFILED["syncs"].update({"totals readback": 30, "download wait": 10})
    profiling.PROFILED["bus_bytes"].update({"h2d pageable": 3_000_000_000, "d2h pinned": 600})
    profiling.PROFILED["span_s"].update({"short": 0.004, "short wait": 0.001})
    o = obs()
    assert run.metric_reader("resident.syncs_per_gbp")(o) == 20.0
    assert run.metric_reader("genome.syncs_per_gbp")(o) == 20.0
    assert run.metric_reader("genome.bus_bytes_per_base")(o) == 1.5000003
    assert run.metric_reader("short.wait_us")(o) == pytest.approx(250.0)
    assert run.metric_reader("short.host_span_us")(o) == pytest.approx(750.0)
    del profiling.PROFILED["span_s"]["short wait"]  # the CPU route waits nowhere
    assert run.metric_reader("short.wait_us")(o) == 0.0


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_traced_run_reports_the_new_metrics_of_its_cell(cell, monkeypatch):
    """The counts read are the differences of SYNCS and BUS_BYTES around
    the profiled window, and no warm or staged call adds to them."""
    around = []
    orig = run.profiled

    def profiled(*args, **kw):
        before = (collections.Counter(profiling.SYNCS), collections.Counter(profiling.BUS_BYTES))
        out = orig(*args, **kw)
        around.append((profiling.SYNCS - before[0], profiling.BUS_BYTES - before[1]))
        return out

    monkeypatch.setattr(run, "profiled", profiled)
    res = run.run_cell(cell, SEED, 0.3, True, bench=BENCH, t_start=time.perf_counter())
    assert res["correct"] is True
    mine = {name for name, c in NEW.items() if c == cell}
    assert mine <= set(res["metrics"])
    assert not set(NEW) - mine & set(res["metrics"])
    for name in mine:
        assert res["metrics"][name]["value"] >= 0
    (syncs, moved), = around
    assert profiling.PROFILED["syncs"] == syncs and profiling.PROFILED["bus_bytes"] == moved
    json.dumps(res)


class _Profile:
    """A finished profile that exports a hand-made Chrome trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, ts, dur, cat="cpu_op", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}


def test_idle_gaps_name_the_innermost_program_span():
    """Nested spans, a torch operator inside a span, and a gap with no span
    open inside the entry's annotation: each idle stretch goes to the
    innermost host event open over it, so the program's spans take the
    idle time the entry's annotation took before."""
    events = [
        _x(tracing.WINDOW, 0, 1000, "user_annotation"),
        _x("sketch_records", 0, 1000, "user_annotation"),  # the harness's per-call annotation
        _x("smt.sketch_records", 10, 980),
        _x("smt.mask packing", 20, 280),  # idle 20-300
        _x("smt.upload", 300, 200),
        _x("aten::copy_", 320, 100),  # idle 320-400 inside the operator; the copy 400-420
        _x("Memcpy HtoD (Pageable -> Device)", 400, 20, "gpu_memcpy", tid=7),
        _x("smt.kernels", 500, 300),
        _x("minimizer_tiles<true>", 520, 200, "kernel", tid=7),
        _x("smt.totals readback", 700, 90),  # busy to 720, then idle 720-790
    ]
    tl = tracing.read(_Profile(events))
    gaps = {k: round(v * 1e9) for k, v in tl.idle_by_host.items()}  # ns; the trace counts us
    assert gaps == {"sketch_records": 10_000 + 10_000, "smt.sketch_records": 10_000 + 190_000,
                    "smt.mask packing": 280_000, "smt.upload": 20_000 + 80_000,
                    "aten::copy_": 80_000, "smt.kernels": 20_000 + 10_000,
                    "smt.totals readback": 70_000}
    assert round(tl.busy_s * 1e9) == 220_000 and round(tl.window_s * 1e9) == 1_000_000
