"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json at the root of the
checkout. Its configuration is the file BENCHMARK.json names, its traffic
`benchmark/traffic/<traffic>.json`; the traffic's generator, entry, the
configuration's reference and each metric's reader are files found by
name (`plugins.py`). A run makes the inputs from the seed, warms the entry
with the calls that cover every shape it uses (set-up ends there:
`setup_s`), then calls the entry in a closed loop until `--seconds` have
passed. With `--trace 1` it runs two windows of at most the traffic's
`trace_seconds` and `stage_seconds` instead: one under torch.profiler
alone, one under the program's `split_wall` alone (whose stages wait for
the card, so it would change the first). Then, with the program's state
freed, it holds a seed-drawn sample of the answers and every answer of the
last call against the plain reference.

It exits nonzero and prints no result without a CUDA card, with fewer cards
than the cell asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "simd_minimizers_tpu")  # top-level module names
DEVICE = "cuda"  # where the run makes its inputs and calls the program

# every build and kernel cache at a fixed path inside the checkout (the
# program builds its own kernels into build/torch_kernels there)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
sys.path[:0] = [str(HERE), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import check  # noqa: E402
import gen  # noqa: E402
import plugins  # noqa: E402
import reference  # noqa: E402
import tracing  # noqa: E402
import yardstick  # noqa: E402


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def for_cell(metrics: list, workload: str) -> list:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def cell_spec(workload: str, bench: dict) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload, by the names
    BENCHMARK.json gives."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, load_json(ROOT / config["file"]), load_traffic(cell["traffic"])


def metric_reader(name: str):
    """The `read` of benchmark/metrics/<name>.py."""
    return plugins.load("metrics", name).read


def detached(value):
    """A part's answer in memory of its own: a host array that is a view (of
    the program's pinned buffers) is copied, so that keeping it does not
    keep the program's buffers from their reuse; a tuple item by item."""
    if isinstance(value, tuple):
        return tuple(detached(v) for v in value)
    if isinstance(value, np.ndarray) and value.base is not None:
        return value.copy()
    return value


class Sample:
    """The parts checked besides the last call's: `parts` draws, made from
    the seed before the window, each of a call among the first `calls` of
    the run and of a part of that call. A drawn part is kept (`detached`)
    when its call returns, so the window copies the kept parts and no
    other; a draw whose call the run never reaches is not checked."""

    def __init__(self, spec: dict, seed: int):
        rng = random.Random(gen.seed64(seed) ^ 0x5EED)
        self.draws = collections.defaultdict(list)  # call -> draws in [0, 1)
        for _ in range(spec["parts"]):
            self.draws[rng.randrange(spec["calls"])].append(rng.random())
        self.kept = []

    def offer(self, i: int, parts) -> None:
        draws = self.draws.pop(i, None)
        if draws:
            parts = parts()
            for j in sorted({int(u * len(parts)) for u in draws}):
                self.kept.append((parts[j][0], detached(parts[j][1])))


@dataclasses.dataclass
class Window:
    """A closed loop of calls: what it did and how long it took."""

    first: int  # the index of its first call
    calls: int = 0
    failed: int = 0
    walls: list = dataclasses.field(default_factory=list)  # seconds of each call
    bases: int = 0
    windows: int = 0
    positions: int = 0
    wall: float = 0.0
    last: object = None  # the last call's result
    error: Exception | None = None  # the first failure


def run_window(entry, seconds: float, first: int, sample: Sample, annotate: str | None = None,
               count: bool = False) -> Window:
    """Calls the entry from call `first` on until `seconds` have passed,
    each call under the profiler's annotation `annotate` if given; with
    `count`, counts the windows and answers of the calls too."""
    from torch.profiler import record_function

    win = Window(first)
    i = first
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            with record_function(annotate) if annotate else contextlib.nullcontext():
                res = entry.call(i)
        except Exception as exc:  # a failed call makes the run not correct; go on
            win.failed += 1
            win.error = win.error or exc
            res = None
        end = time.perf_counter()
        win.walls.append(end - t)
        if res is not None:
            win.bases += entry.bases(i)
            if count:
                win.windows += entry.windows(i)
                win.positions += entry.count(res)
            sample.offer(i, lambda: entry.parts(res))
            win.last = res
        i += 1
        win.calls += 1
        if end - t0 >= seconds:
            break
    win.wall = end - t0
    return win


def profiled(entry, name, seconds, first, sample, device):
    """A window under torch.profiler (the window a user annotation,
    `tracing.WINDOW`, each call another) with the program's launch counter
    read around it: (window, timeline, launches)."""
    from simd_minimizers_tpu_torch.ops import fused
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    before = dict(fused.LAUNCHES)
    with profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            win = run_window(entry, seconds, first, sample, annotate=name, count=True)
    launches = {k: v - before.get(k, 0) for k, v in fused.LAUNCHES.items()}
    return win, tracing.read(prof), launches


def staged(entry, seconds, first, sample):
    """A window under the program's `utils.profiling.split_wall`: (window,
    seconds by stage)."""
    from simd_minimizers_tpu_torch.utils.profiling import split_wall

    with split_wall() as stages:
        win = run_window(entry, seconds, first, sample)
    return win, dict(stages)


def power_limit() -> str:
    """`name, power.limit` of the card as nvidia-smi reads it."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read: {exc}"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             bench: dict | None = None, t_start: float = T_START) -> dict:
    """One run of a cell on `DEVICE`; its result line as a dict, the
    compared numbers under `checks`."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_spec(workload, bench)
    ref = reference.make(config)
    dev = torch.device(DEVICE)
    cuda = dev.type == "cuda"

    t = time.perf_counter()
    inputs = gen.make(traffic, seed, dev)
    inputs_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        # the card's peak while the harness made the inputs, apart from the
        # program's own from here on (`program_peak_gb`)
        inputs_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_inputs = time.perf_counter() - t
    t = time.perf_counter()
    entry = plugins.load("entries", traffic["entry"]).Entry(config, inputs, dev)
    held = None
    for i in range(entry.warm_calls()):
        held = entry.call(i)
    del held
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: inputs {t_inputs:.3f} s, program and "
          f"{entry.warm_calls()} warm calls {time.perf_counter() - t:.3f} s", file=sys.stderr)

    sample = Sample(traffic["sample"], seed)
    # what a metric's reader reads: the run's counts and clocks (`window`:
    # the measured window, traced the profiled one), the card's peak since
    # the inputs were made and, traced, the profiler's timeline, the
    # program's launch counts and its stage totals over a second window
    # (`staged`)
    obs = types.SimpleNamespace(config=config, traffic=traffic, setup_s=setup_s, timeline=None,
                                launches=None, staged=None, stages=None, least_s=None,
                                program_peak_bytes=0)
    if trace:
        obs.window, obs.timeline, obs.launches = profiled(
            entry, traffic["entry"], min(seconds, traffic["trace_seconds"]), 0, sample, dev)
        wins = [obs.window]
        if traffic["stage_seconds"]:
            obs.staged, obs.stages = staged(entry, min(seconds, traffic["stage_seconds"]),
                                            obs.window.first + obs.window.calls, sample)
            wins.append(obs.staged)
        ops, nbytes = ref.least_work(obs.window.windows, obs.window.bases, obs.window.positions,
                                     packed=entry.packed, masked=inputs.masks is not None)
        obs.least_s = yardstick.least_seconds(ops, nbytes)
    else:
        obs.window = run_window(entry, seconds, 0, sample)
        wins = [obs.window]
    obs.program_peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peak = max(inputs_peak, obs.program_peak_bytes)
    calls, failed = sum(w.calls for w in wins), sum(w.failed for w in wins)
    error = next((w.error for w in wins if w.error is not None), None)
    if error is not None:
        print(f"{failed} of {calls} calls failed; the first: {error!r}", file=sys.stderr)

    metrics = {}
    for m in for_cell(bench["per_layer"] if trace else bench["end_to_end"], workload):
        value = metric_reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        device_info["power_limit"] = power_limit()
    if obs.timeline is not None:
        device_info["busy_s"], device_info["window_s"] = obs.timeline.busy_s, obs.timeline.window_s

    last = wins[-1].last
    kept = sample.kept + (entry.parts(last) if last is not None else [])
    for w in wins:
        w.last = None
    del last, sample
    entry.free()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    differing, checked = check.differing(inputs, kept, ref, dev)
    for w in wins:
        q = np.percentile(w.walls, [0, 50, 100]) * 1e3
        print(f"{w.calls} calls in {w.wall:.3f} s (ms a call: least {q[0]:.3f}, median "
              f"{q[1]:.3f}, most {q[2]:.3f})", file=sys.stderr)
    print(f"{checked} parts checked against the reference in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    checks = {"differing_parts": {"value": differing, "at_most": 0},
              "failed_calls": {"value": failed, "at_most": 0},
              "checked_parts": {"value": checked, "at_least": 1}}
    correct = all(c["value"] <= c["at_most"] if "at_most" in c else c["value"] >= c["at_least"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": calls, "failed": failed, "metrics": metrics,
              "device": device_info}
    if obs.timeline is not None:
        result["breakdown"] = obs.timeline.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _, _ = cell_spec(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for key, c in result["checks"].items():
        limit = ", ".join(f"{k.replace('_', ' ')} {v}" for k, v in c.items() if k != "value")
        print(f"check {key}: {c['value']} ({limit})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
