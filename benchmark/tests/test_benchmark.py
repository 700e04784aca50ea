"""Tests of the benchmark harness: its files load by name, its generators
repeat from a seed, its reference agrees with the crate's golden vectors
and the program's CPU route, a run prints the contract's last line, a run
whose timed path is broken comes out not correct, the control fails, and
nothing it loads is JAX.

    python -m pytest benchmark/tests -q            # CPU, small sizes
    python -m pytest benchmark/tests -q -m cuda    # on a card: each cell, short

The cells run here on the CPU at the sizes each generator's `small` gives,
merged over the traffic file's parameters, so a cell added by data alone
is tested too; the tests marked `cuda` run the command as the benchmark's
checker does and skip without a card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import gen  # noqa: E402
import plugins  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402
import control  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2**31 + 977  # past 32 signed bits, as the checker's seeds are
TRAFFICS = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
PLUGINS = [(kind, p.stem) for kind in ("inputs", "entries", "references", "hashes", "metrics")
           for p in sorted((HERE / kind).glob("*.py"))]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
_FILE_TRAFFIC = run.load_traffic
CARD_ONLY = {"program_peak_gb"}  # end-to-end metrics read from the card alone


def small_traffic(name: str) -> dict:
    """A traffic file's parameters with its inputs shrunk to a size the CPU
    holds, by its generator's `small`, and its sample drawn from the first
    two calls (a short window on the CPU makes few)."""
    spec = _FILE_TRAFFIC(name)
    return {**spec, **plugins.load("inputs", spec["inputs"]).small(spec),
            "sample": {**spec["sample"], "calls": 2}}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """Every run here: on the CPU, at small sizes."""
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run, "load_traffic", small_traffic)


def config_of(cell: str) -> dict:
    return run.cell_spec(cell, BENCH)[1]


def cpu_run(cell: str, seed: int = SEED, trace: bool = False, seconds: float = 0.3) -> dict:
    return run.run_cell(cell, seed, seconds, trace, bench=BENCH, t_start=time.perf_counter())


# -- the files, by name ------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    spec, config, traffic = run.cell_spec(cell, BENCH)
    assert {"k", "w", "mode", "canonical", "hasher", "source", "assumed", "reduced"} <= set(config)
    assert {"inputs", "place", "entry", "shape_seed", "sample", "trace_seconds",
            "stage_seconds"} <= set(traffic)
    assert (HERE / "traffic" / f"{spec['traffic']}.json").is_file()
    assert callable(plugins.load("inputs", traffic["inputs"]).make)
    assert issubclass(plugins.load("entries", traffic["entry"]).Entry,
                      sys.modules["entry"].Entry)
    assert callable(plugins.load("references", config["mode"]).make)
    assert callable(plugins.load("hashes", config["hasher"]).kmer_hashes)


@pytest.mark.parametrize("kind,name", PLUGINS, ids=[f"{k}/{n}" for k, n in PLUGINS])
def test_every_part_loads_by_name(kind, name):
    mod = plugins.load(kind, name)
    assert mod is plugins.load(kind, name)  # loaded once
    want = {"inputs": ("make", "expected", "small"), "entries": ("Entry",),
            "references": ("make",), "hashes": ("kmer_hashes", "OPS_PER_KMER", "PROGRAM_HASHER"),
            "metrics": ("read",)}[kind]
    assert all(hasattr(mod, a) for a in want)


def test_an_unknown_part_is_named():
    with pytest.raises(ValueError, match="no entries named 'nope'"):
        plugins.load("entries", "nope")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(run.metric_reader(metric))


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(c) == {"name", "config", "traffic", "chips", "why"} for c in BENCH["workloads"])
    for k, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in BENCH[k]:
            assert keys <= set(m) <= keys | {"workloads"} and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert Path(ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert run.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    for cell in BENCH["workloads"]:
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        mine = [m["name"] for m in run.for_cell(BENCH["end_to_end"], cell["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = run.for_cell(BENCH["per_layer"], cell["name"])
        assert layer and all(m["moves"] in mine for m in layer)
    layers = {}
    for m in BENCH["per_layer"]:  # a layer's metrics name it letter for letter alike
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


# -- generators --------------------------------------------------------------

@pytest.mark.parametrize("traffic", TRAFFICS)
def test_generator_repeats_from_a_seed(traffic):
    spec = small_traffic(traffic)

    def flat(inp):
        parts = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p for p in inp.parts]
        return parts, inp.masks, inp.order, inp.lengths

    a, b, c = (flat(gen.make(spec, s, "cpu")) for s in (SEED, SEED, SEED + 1))
    for x, y in zip(a[0] + (a[1] or []), b[0] + (b[1] or [])):
        assert np.array_equal(x, y)
    assert a[3] == b[3] and sorted(a[3]) == sorted(c[3])  # the same sizes on every seed
    assert any(not np.array_equal(x, y) for x, y in zip(a[0], c[0]))


def test_masks_shape_n_runs():
    spec = small_traffic("genome-host")
    inp = gen.make(spec, SEED, "cpu")
    assert len(inp.masks) == len(inp.parts) and all(m.any() for m in inp.masks)
    assert all(m.shape == p.shape and m.dtype == bool for m, p in zip(inp.masks, inp.parts))


# -- the reference -----------------------------------------------------------

def nt_minimizers(k: int, w: int, canonical: bool, control: bool = False):
    return reference.make({"mode": "minimizers", "hasher": "nt", "k": k, "w": w,
                           "canonical": canonical}, control)


def test_reference_golden_vectors():
    def codes(s):
        return reference.ascii_codes(torch.frombuffer(bytearray(s), dtype=torch.uint8))

    seq = b"ACGTGCTCAGAGACTCAGAGGA"
    assert nt_minimizers(5, 7, True).sequence(codes(seq)).tolist() == [0, 7, 9, 15]
    fwd = nt_minimizers(5, 7, False).sequence(codes(b"ACGTGCTCAGAGACTCAG"))
    assert fwd.tolist() == [4, 5, 8, 13]
    rc = bytes(b"ACGT"[b"TGCA".index(c)] for c in reversed(seq))
    assert nt_minimizers(5, 7, True).sequence(codes(rc)).tolist() == [2, 8, 10, 17]


def test_least_work_is_the_frozen_count():
    """chip_smoke.py's `_tiles_ops_per_window` at k=21 w=11 of 2-bit input:
    29 canonical, 14 forward; 2 fewer for a char already in a byte, 3 more
    with a mask."""
    assert nt_minimizers(21, 11, True).least_work(1, 0, 0, packed=True, masked=False)[0] == 29
    assert nt_minimizers(21, 11, False).least_work(1, 0, 0, packed=True, masked=False)[0] == 14
    assert nt_minimizers(21, 11, True).least_work(1, 0, 0, packed=False, masked=True)[0] == 30
    assert nt_minimizers(19, 19, True).least_work(10, 8, 1, packed=True, masked=True) == (
        320, 8 / 4 + 8 / 8 + 4)


@pytest.mark.parametrize("k,w,canonical", [(21, 11, True), (19, 19, True), (21, 11, False)])
def test_reference_agrees_with_the_program_on_the_cpu(k, w, canonical):
    import simd_minimizers_tpu_torch as smt
    from simd_minimizers_tpu_torch.ops import backend

    rng = np.random.default_rng(k * w)
    recs = [rng.integers(0, 4, n, dtype=np.uint8) for n in (20_000, 3_001, 30, 5)]
    masks = [rng.random(r.size) < 0.001 for r in recs]
    h = smt.NtHasher(k, canonical=canonical)
    got = backend.sketch_records(recs, k, w, h, ambiguous=masks, dna=True, device="cpu")
    ref = nt_minimizers(k, w, canonical)
    for r, m, g in zip(recs, masks, got):
        want = ref.sequence(torch.from_numpy(r), torch.from_numpy(m), block_windows=997)
        assert reference.same(g, want)
    reads = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (300, 150))]
    b = (smt.canonical_minimizers if canonical else smt.minimizers)(k, w)
    assert reference.same(b.run_batch(reads, device="cpu"),
                          ref.rows(reference.ascii_codes(torch.from_numpy(reads))))
    # reads of many lengths, some shorter than a window, in a list
    lens = rng.integers(1, 400, 120)
    reads = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)] for n in lens]
    want = next(reference.plugins.load("inputs", "reads").expected(
        gen.Inputs("reads", "host_ascii", [int(lens.sum())], [reads]), [0], ref, "cpu"))[1]
    assert reference.same(b.run_batch(reads, device="cpu"), want)


def test_reads_of_many_lengths_repeat_from_the_shape_seed():
    spec = {"inputs": "reads", "place": "host_ascii", "shape_seed": 5,
            "reads": {"count": 50, "bp": [10, 900], "batches": 2, "alphabet": "ACGT"}}
    a, b = gen.make(spec, SEED, "cpu"), gen.make(spec, SEED + 1, "cpu")
    assert [[r.size for r in p] for p in a.parts] == [[r.size for r in p] for p in b.parts]
    assert a.lengths == b.lengths and len({r.size for r in a.parts[0]}) > 10


def test_unpack_2bit():
    packed = torch.tensor([0b11_10_01_00, 0b00_00_00_10], dtype=torch.uint8)
    assert reference.unpack_2bit(packed, 5).tolist() == [0, 1, 2, 3, 2]


# -- a run --------------------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_run_gives_the_contract_line(cell, trace):
    res = cpu_run(cell, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    want = {m["name"] for m in run.for_cell(BENCH["per_layer" if trace else "end_to_end"], cell)}
    assert set(res["metrics"]) <= want
    if not trace:  # every end-to-end metric but the card's memory, which the CPU has not
        assert set(res["metrics"]) == want - CARD_ONLY
    else:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    for m in res["metrics"].values():
        assert isinstance(m["value"], float | int) and m["unit"]
    json.dumps(res)


def test_traced_run_reads_stages_and_the_profile_in_windows_of_their_own(monkeypatch):
    """The stages come from a window without the profiler, whose own
    window holds no stage's waits: both read, each from its own calls."""
    from simd_minimizers_tpu_torch.utils import profiling

    seen = []
    orig = run.run_window

    def run_window(entry, seconds, first, sample, annotate=None, count=False):
        seen.append((first, annotate, profiling._stages is not None))
        return orig(entry, seconds, first, sample, annotate, count)

    monkeypatch.setattr(run, "run_window", run_window)
    res = cpu_run("k21w11.genome-host", trace=True)
    assert [(a, s) for _, a, s in seen] == [("sketch_records", False), (None, True)]
    assert seen[1][0] > seen[0][0] == 0 and res["correct"] is True
    assert "genome.stage_share" in res["metrics"]


def test_program_peak_is_the_cards_peak_after_the_inputs():
    read = run.metric_reader("program_peak_gb")
    assert read(run.types.SimpleNamespace(program_peak_bytes=0)) is None  # no card
    assert read(run.types.SimpleNamespace(program_peak_bytes=2_500_000_000)) == 2.5


def test_sample_is_drawn_from_the_seed_and_copies_only_what_it_keeps():
    spec = {"parts": 5, "calls": 4}
    a, b = run.Sample(spec, SEED), run.Sample(spec, SEED)
    assert a.draws == b.draws and sum(len(d) for d in a.draws.values()) == 5
    base = np.arange(100, dtype=np.uint32)
    asked = []

    def parts(i):
        def get():
            asked.append(i)
            return [(j, base[j * 10:j * 10 + 10]) for j in range(10)]
        return get

    for i in range(6):
        a.offer(i, parts(i))
    assert sorted(asked) == sorted(a_calls for a_calls in b.draws)  # only drawn calls
    assert 1 <= len(a.kept) <= 5 and all(v.base is None for _, v in a.kept)


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this PyTorch sees a CUDA card")
    cp = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    assert cp.returncode != 0 and "{" not in cp.stdout


# -- faults of the timed path: each must come out not correct ----------------

def _altered(monkeypatch, cell):
    """An answer altered where it is produced: the first position of every
    launch's output moves by one."""
    from simd_minimizers_tpu_torch.ops import fused

    orig = fused.tile_append

    def tile_append(*a, **kw):
        out = orig(*a, **kw)
        if out.numel():
            out = out.clone()
            out.view(-1)[0] += 1
        return out

    monkeypatch.setattr(fused, "tile_append", tile_append)


def _half(monkeypatch, cell):
    """Half of the batch left out: every other record, read, chromosome or
    call gets no answer."""
    from simd_minimizers_tpu_torch.ops import backend, device_sketcher

    traffic = run.cell_spec(cell, BENCH)[2]["entry"]
    if traffic == "sketch_records":
        orig = backend.sketch_records
        monkeypatch.setattr(backend, "sketch_records", lambda *a, **kw: [
            o if i % 2 else o[:0] for i, o in enumerate(orig(*a, **kw))])
    elif traffic == "sketch":
        orig, seen = backend.sketch, []

        def sketch(*a, **kw):
            seen.append(1)
            out = orig(*a, **kw)
            return out if len(seen) % 2 else out[:0]

        monkeypatch.setattr(backend, "sketch", sketch)
    elif traffic == "run_batch":
        orig = backend.sketch_batch

        def sketch_batch(*a, **kw):
            rid, pos = orig(*a, **kw)
            keep = rid % 2 == 0
            return rid[keep], pos[keep]

        monkeypatch.setattr(backend, "sketch_batch", sketch_batch)
    else:
        orig, seen = device_sketcher.ShortSeqSketcher.sketch, []

        def sketch(self, codes):
            seen.append(1)
            out = orig(self, codes)
            return out if len(seen) % 2 else out[:0]

        monkeypatch.setattr(device_sketcher.ShortSeqSketcher, "sketch", sketch)


@pytest.mark.parametrize("fault", [_altered, _half], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    res = cpu_run(cell)
    assert res["correct"] is False and res["checks"]["differing_parts"]["value"] >= 1


def test_failing_calls_are_not_correct(monkeypatch):
    from simd_minimizers_tpu_torch.ops import backend

    calls = []

    def sketch_records(*a, **kw):
        calls.append(1)
        if len(calls) > 2:  # the warm calls pass, the window's fail
            raise RuntimeError("a planted failure")
        return orig(*a, **kw)

    orig = backend.sketch_records
    monkeypatch.setattr(backend, "sketch_records", sketch_records)
    res = cpu_run("k21w11.genome-host")
    assert res["correct"] is False and res["failed"] == res["attempted"] >= 1


# -- the control --------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, monkeypatch):
    def traffic(name):
        t = small_traffic(name)
        if t["inputs"] == "pool":  # ties are rare: enough windows for a few
            t = {**t, "pool": {**t["pool"], "count": 600}}
        return t

    monkeypatch.setattr(run, "load_traffic", traffic)
    res = control.control_reading(cell, SEED, BENCH)
    assert res["differing_parts"] >= 1 and res["parts"] >= 1


# -- no JAX -------------------------------------------------------------------

def test_harness_imports_no_jax():
    """In a fresh process: import run.py, the control and every part found
    by name, run a cell traced on the CPU, and find no module whose top-level name
    is jax, jaxlib, flax or simd_minimizers_tpu (the port's name begins
    with the last, so the names are compared whole)."""
    cell = CELLS[0]
    code = f"""
import json, sys, time
sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]
import run, control, plugins
file_traffic = run.load_traffic
def small(name):
    t = file_traffic(name)
    return {{**t, **plugins.load("inputs", t["inputs"]).small(t)}}
run.load_traffic, run.DEVICE = small, "cpu"
for kind in ("inputs", "entries", "references", "hashes", "metrics"):
    for p in sorted((run.HERE / kind).glob("*.py")):
        plugins.load(kind, p.stem)
for m in run.load_json(run.ROOT / "BENCHMARK.json")["end_to_end"] + \\
        run.load_json(run.ROOT / "BENCHMARK.json")["per_layer"]:
    run.metric_reader(m["name"])
run.run_cell({cell!r}, 1, 0.1, True, t_start=time.perf_counter())
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN)))
print(json.dumps("simd_minimizers_tpu_torch" in sys.modules))
"""
    cp = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                        timeout=300)
    assert cp.returncode == 0, cp.stderr[-2000:]
    lines = cp.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == [] and json.loads(lines[-1]) is True


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in ("0", "1"):
        cp = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                             str(SEED), "--seconds", "2", "--trace", trace], cwd=ROOT,
                            capture_output=True, text=True, timeout=600)
        assert cp.returncode == 0, cp.stderr[-4000:]
        res = json.loads(cp.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and res["device"]["platform"] == "gpu"
