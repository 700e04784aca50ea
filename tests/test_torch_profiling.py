"""The wall-time split of the port's entry points (utils/profiling): stages
are timed only inside `split_wall`, a stage inside another is charged to
the outer one, and the split leaves every result as it was. `trace` writes
a Chrome trace of a block; `timed_amortized` gives a positive time per
call.

The spans and counters: under a recording torch.profiler each entry point
emits its `smt.` entry span and its steps nested inside it, with no wait
for the card; with no profiler and no split nothing is recorded; results
are the same either way; `SYNCS` and `BUS_BYTES` take each entry's
documented counts per call on the CPU, and `PROFILED` the same counts for
the calls made while a profiler recorded."""

from __future__ import annotations

import collections
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import backend, batch, pipeline
from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher
from simd_minimizers_tpu_torch.utils import profiling


def test_stages_are_free_outside_a_split():
    with profiling.stage("a"):
        pass
    with profiling.split_wall() as parts:
        pass
    assert parts == {}


def test_inner_stage_is_charged_to_the_outer():
    with profiling.split_wall() as parts:
        with profiling.stage("outer"):
            with profiling.stage("inner"):
                pass
        with profiling.stage("outer"):
            pass
        with profiling.stage("other"):
            pass
    assert sorted(parts) == ["other", "outer"]
    assert all(sec >= 0 for sec in parts.values())


def test_split_wall_does_not_nest():
    with profiling.split_wall():
        with pytest.raises(RuntimeError, match="nest"):
            with profiling.split_wall():
                pass
    with profiling.split_wall() as parts:  # the failed one left no state behind
        with profiling.stage("a"):
            pass
    assert list(parts) == ["a"]


def test_run_batch_split_keeps_the_result():
    """Builder.run_batch on the CPU: the stages of its host fold, slot
    fill, upload, kernels and read attribution (the download is a stage on
    a card only), and the same result as without the split."""
    rng = np.random.default_rng(0x5917)
    reads = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(n))].tobytes()
             for n in rng.integers(30, 400, 40)]
    b = smt.canonical_minimizers(7, 5)
    want = b.run_batch(reads, device="cpu")
    with profiling.split_wall() as parts:
        got = b.run_batch(reads, device="cpu")
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    assert {"fold reads to codes", "slot fill", "upload and padding plane", "kernels",
            "read attribution and order"} <= set(parts)


@pytest.mark.parametrize("batch_max_bp", [0, 1000])
def test_records_split_keeps_the_result(batch_max_bp):
    """backend.sketch_records with masks, on the span route and the batch
    route: the same records as without the split, and its stages."""
    k, w = 5, 7
    rng = np.random.default_rng(0x5918)
    recs = [rng.integers(0, 4, int(n), dtype=np.uint8) for n in rng.integers(40, 900, 10)]
    recs.append(rng.integers(0, 4, 5000, dtype=np.uint8))
    ambs = [(rng.random(r.size) < 0.02).astype(np.uint8) for r in recs]
    h = smt.NtHasher(k, canonical=True)
    want = backend.sketch_records(recs, k, w, h, pipeline.MODE_MINIMIZERS, ambs, device="cpu",
                                  batch_max_bp=batch_max_bp)
    with profiling.split_wall() as parts:
        got = backend.sketch_records(recs, k, w, h, pipeline.MODE_MINIMIZERS, ambs,
                                     device="cpu", batch_max_bp=batch_max_bp)
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    assert {"mask packing", "upload", "kernels", "seam merge"} <= set(parts)
    assert ("split by record" in parts) == bool(batch_max_bp)


def test_trace_writes_a_chrome_trace(tmp_path):
    """A torch.profiler trace of one Builder.run on the CPU, exported into
    the log directory, holds the run's CPU operations."""
    seq = smt.PackedSeqVec.random(3000, np.random.default_rng(1))
    logdir = tmp_path / "logs"
    with profiling.trace(str(logdir)) as path:
        out = smt.canonical_minimizers(5, 7).run(seq, device="cpu")
    assert os.path.dirname(path) == str(logdir) and os.path.isfile(path)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert out.positions.size


def test_trace_leaves_no_file_on_error(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            1 / 0
    assert not list(tmp_path.iterdir())


def test_timed_amortized():
    """Seconds per call of a CPU function: positive, and larger for more work."""
    calls = []

    def fn():
        calls.append(1)
        return sum(range(20_000))

    t = profiling.timed_amortized(fn, reps=4, probes=2)
    assert 0 < t < 1
    assert len(calls) == 1 + 2 * 1 + 1 * 5  # warm, probes of one, one batch of reps + 1


# -- spans and counters ---------------------------------------------------------

K, W = 7, 5
HASHER = smt.NtHasher(K, canonical=True)
_rng = np.random.default_rng(0x5919)
READS = np.frombuffer(b"ACGT", np.uint8)[_rng.integers(0, 4, (40, 150))]  # one stride bucket
READ_LIST = [r.tobytes() for r in READS]
RECORDS = [_rng.integers(0, 4, int(n), dtype=np.uint8) for n in _rng.integers(40, 900, 10)]
RECORDS.append(_rng.integers(0, 4, 5000, dtype=np.uint8))
MASKS = [(_rng.random(r.size) < 0.02).astype(np.uint8) for r in RECORDS]
PACKED = smt.PackedSeqVec.random(3000, _rng)
SHORT = _rng.integers(0, 4, 700, dtype=np.uint8)
_SKETCHER = {}


def _short():
    if "sk" not in _SKETCHER:
        _SKETCHER["sk"] = ShortSeqSketcher(K, W, HASHER, device="cpu")
    return _SKETCHER["sk"].sketch(SHORT)


# entry -> (call, entry span, the child spans it emits on the CPU)
ENTRIES = {
    "run_batch": (lambda: smt.canonical_minimizers(K, W).run_batch(READS, device="cpu"),
                  "run_batch",
                  {"record probe", "ascii upload", "fold on card", "dna probe", "hasher tables",
                   "kernels", "totals readback", "read attribution and order", "download wait"}),
    "run_batch, list": (
        lambda: smt.canonical_minimizers(K, W).run_batch(READ_LIST, device="cpu"),
        "run_batch",
        {"fold reads to codes", "record probe", "hasher tables", "stride buckets", "slot fill",
         "upload and padding plane", "upload", "kernels", "totals readback",
         "read attribution and order", "download wait"}),
    "sketch_records, span route": (
        lambda: backend.sketch_records(RECORDS, K, W, HASHER, pipeline.MODE_MINIMIZERS, MASKS,
                                       device="cpu", batch_max_bp=0),
        "sketch_records",
        {"record probe", "hasher tables", "upload", "mask packing", "kernels",
         "totals readback", "seam merge", "download wait"}),
    "sketch_records, batch route": (
        lambda: backend.sketch_records(RECORDS, K, W, HASHER, pipeline.MODE_MINIMIZERS, MASKS,
                                       device="cpu", batch_max_bp=1000),
        "sketch_records",
        {"record probe", "hasher tables", "upload", "mask packing", "kernels",
         "totals readback", "seam merge", "download wait", "stride buckets", "slot fill",
         "upload and padding plane", "read attribution and order", "split by record"}),
    "sketch": (lambda: backend.sketch(torch.from_numpy(PACKED.data.copy()), len(PACKED), K, W,
                                      HASHER),
               "sketch", {"hasher tables", "kernels", "totals readback"}),
    "short": (_short, "short", {"short stage in", "short launch", "totals readback",
                                "short unpack", "short release"}),
}


def _buckets(lengths) -> int:
    return len({batch._stride_bucket(int(n) + 1) for n in lengths if n >= K + W - 1})


def _positions(out) -> int:
    return sum(np.asarray(p).size for p in (out if isinstance(out, list) else [out]))


def _expected_counts(entry: str, out, warm: bool = False):
    """(SYNCS, BUS_BYTES, TABLES) of one call of `entry` on the CPU, from
    its inputs: every blocking upload waits for the card's stream and counts
    as a sync. The hasher's tables (2-bit nt: 2 x 4 int64, 64 B) cross once
    per device and table: a cold call, made with no table kept, uploads them
    at its first lookup (the span route looks them up once a record, the
    batch route once in each of its two routes), and a warm call, made after
    a call of the same entry, finds them kept. The short sketcher keeps its
    own from its construction."""
    syncs, moved = _cold_counts(entry, out)
    lookups = {"short": 0, "sketch_records, span route": len(RECORDS),
               "sketch_records, batch route": 2}.get(entry, 1)
    if not warm:
        tables = {"uploads": 1, "hits": lookups - 1} if lookups else {}
        return syncs, moved, {k: v for k, v in tables.items() if v}
    if syncs.pop("tables upload", 0):
        moved["h2d pageable"] -= 64
        moved = {k: v for k, v in moved.items() if v}
    return syncs, moved, {"hits": lookups} if lookups else {}


def _cold_counts(entry: str, out):
    """(SYNCS, BUS_BYTES) of a cold call of `entry` (`_expected_counts`)."""
    if entry == "run_batch":  # the matrix staged through pinned buffers, folded on the device
        return ({"dna probe": 1, "tables upload": 1, "totals readback": 1, "download wait": 1},
                {"h2d pinned": READS.size, "h2d pageable": 64, "d2h pageable": 4 + 4,
                 "d2h pinned": 4 * 2 * out[1].size})
    if entry == "run_batch, list":
        stride = batch._stride_bucket(READS.shape[1] + 1)
        n = READS.shape[0]
        syncs = {"tables upload": 1, "padding plane": 2, "upload": 1, "totals readback": 1,
                 "read ids": 1, "download wait": 1}
        moved = {"h2d pageable": 64 + 8 * n + 8 + n * stride + 8 * n, "d2h pageable": 4,
                 "d2h pinned": 4 * 2 * out[1].size}
        return syncs, moved
    if entry == "sketch":
        return {"tables upload": 1, "totals readback": 1}, {"h2d pageable": 64, "d2h pageable": 4}
    if entry == "short":
        return {"totals readback": 1}, {"d2h pageable": 4}
    if entry == "sketch_records, span route":
        r = len(RECORDS)
        h2d = 64 + sum(x.size + -(-x.size // 8) for x in RECORDS)
        return ({"tables upload": 1, "upload": 2 * r, "wave totals": 1, "download wait": r},
                {"h2d pageable": h2d, "d2h pageable": 4 * r, "d2h pinned": 4 * _positions(out)})
    # batch route: the long record by the span route, the others in stride buckets
    small = [x for x in RECORDS if x.size <= 1000]
    big = [x for x in RECORDS if x.size > 1000]
    b = _buckets([x.size for x in small])
    rows = sum(x.size for x in big)
    slots = sum(batch._stride_bucket(x.size + 1) for x in small)
    syncs = {"tables upload": 1, "upload": 2 * len(big) + 2 * b, "wave totals": 1,
             "download wait": len(big) + 1, "padding plane": 2 * b, "totals readback": b,
             "read ids": b}
    h2d = (64 + rows + sum(-(-x.size // 8) for x in big)  # span route
           + 2 * slots + 8 * len(small) + 8 * b + 8 * len(small))  # codes, flags, lens, ids
    d2h_pinned = 4 * sum(_positions(o) for x, o in zip(RECORDS, out) if x.size > 1000) \
        + 4 * 2 * sum(_positions(o) for x, o in zip(RECORDS, out) if x.size <= 1000)
    return syncs, {"h2d pageable": h2d, "d2h pageable": 4 * len(big) + 4 * b,
                   "d2h pinned": d2h_pinned}


def _spans(path) -> list:
    """(name without the prefix, start, end) of every span in a Chrome trace."""
    events = json.load(open(path))["traceEvents"]
    return [(e["name"][len(profiling.SPAN_PREFIX):], float(e["ts"]), float(e["ts"]) + e["dur"])
            for e in events if e.get("ph") == "X" and e["name"].startswith(profiling.SPAN_PREFIX)]


def _clear_profiled():
    for c in profiling.PROFILED.values():
        c.clear()


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_emits_its_spans_nested_in_the_trace(entry, tmp_path):
    """The entry span, once, and every documented step inside its interval,
    in the Chrome trace of the operator's `profiling.trace`."""
    call, root, children = ENTRIES[entry]
    call()  # build once outside the trace
    with profiling.trace(str(tmp_path)) as path:
        call()
    spans = _spans(path)
    roots = [(a, b) for name, a, b in spans if name == root]
    assert len(roots) == 1
    lo, hi = roots[0]
    inside = {name for name, a, b in spans if name != root and lo <= a and b <= hi}
    assert inside == children
    assert {name for name, _, _ in spans} == children | {root}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_spans_never_wait_for_the_card_outside_a_split(entry, monkeypatch):
    """With the profiler recording and no split_wall open, no span or stage
    calls the card's synchronize."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    monkeypatch.setattr(profiling, "_sync", lambda: calls.append(1))
    with profile(activities=[ProfilerActivity.CPU]):
        ENTRIES[entry][0]()
    assert calls == []


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_nothing_is_recorded_without_a_profiler_or_a_split(entry):
    _clear_profiled()
    before = sum(profiling.SYNCS.values())
    assert profiling.span("x") is profiling.span("y")  # one shared no-op
    ENTRIES[entry][0]()
    assert all(not c for c in profiling.PROFILED.values())
    assert sum(profiling.SYNCS.values()) > before  # the counters are always on


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_results_are_the_same_with_the_profiler_on(entry):
    from torch.profiler import ProfilerActivity, profile

    call = ENTRIES[entry][0]
    off = call()
    with profile(activities=[ProfilerActivity.CPU]):
        on = call()
    _same(on, off)


def _counted(call):
    """(result, SYNCS, BUS_BYTES and TABLES added) of one `call()`."""
    before = [collections.Counter(c) for c in (profiling.SYNCS, profiling.BUS_BYTES,
                                                profiling.TABLES)]
    out = call()
    return (out, *(dict(c - b) for c, b in zip((profiling.SYNCS, profiling.BUS_BYTES,
                                                 profiling.TABLES), before)))


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_counters_per_call(entry):
    """SYNCS, BUS_BYTES and TABLES of one cold call on the CPU (no hasher
    table kept), site by site and kind by kind; PROFILED holds the same for
    a cold call made under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    call = ENTRIES[entry][0]
    call()
    convert._tables.clear()
    out, *counted = _counted(call)
    want = _expected_counts(entry, out)
    assert counted == list(want)
    _clear_profiled()
    convert._tables.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert [dict(profiling.PROFILED[k]) for k in ("syncs", "bus_bytes", "tables")] == list(want)
    assert profiling.PROFILED["span_s"][ENTRIES[entry][1]] > 0


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_counters_per_warm_call(entry):
    """A second call of each entry finds the hasher's tables kept: no
    `tables upload`, 64 fewer `h2d pageable` bytes than the cold call, one
    TABLES hit a lookup and no upload, under the profiler too."""
    from torch.profiler import ProfilerActivity, profile

    call = ENTRIES[entry][0]
    convert._tables.clear()
    cold = _counted(call)
    out, *counted = _counted(call)
    want = _expected_counts(entry, out, warm=True)
    assert counted == list(want) and "tables upload" not in counted[0]
    assert (counted[1].get("h2d pageable", 0)
            == cold[2].get("h2d pageable", 0) - 64 * ("tables upload" in cold[1]))
    _clear_profiled()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert [dict(profiling.PROFILED[k]) for k in ("syncs", "bus_bytes", "tables")] == list(want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_run_batch_split_keys_are_unchanged(bucketed):
    """split_wall's stages of run_batch are those it always had: the spans
    added beside them stay out of it."""
    reads = (READ_LIST if bucketed
             else [r.tobytes() for r in READS[:, :100]] + [b"ACGTACGTACGTAC"])
    with profiling.split_wall() as parts:
        smt.canonical_minimizers(K, W).run_batch(reads, device="cpu")
    assert set(parts) == {"fold reads to codes", "slot fill", "upload and padding plane",
                          "kernels", "read attribution and order"}


def test_run_batch_matrix_split_keys():
    """A matrix's stages: its upload as the caller holds it and the fold on
    the device take the place of the host fold and slot fill."""
    with profiling.split_wall() as parts:
        smt.canonical_minimizers(K, W).run_batch(READS, device="cpu")
    assert set(parts) == {"ascii upload", "fold on card", "kernels",
                          "read attribution and order"}


def _matrix_call_counts(dev, monkeypatch, ranges):
    """One run_batch of READS on `dev` split into `ranges` launch ranges,
    under a recording profiler: (ascii_slots calls, LAUNCHES added, SYNCS
    added, the spans recorded)."""
    from torch.profiler import ProfilerActivity, profile

    from simd_minimizers_tpu_torch.ops import fused

    stride = batch._stride_bucket(READS.shape[1] + 1)
    monkeypatch.setattr(batch, "MAX_LAUNCH_CHARS", -(-READS.shape[0] // ranges) * stride)
    b = smt.canonical_minimizers(K, W)
    b.run_batch(READS, device=dev)  # built and warm
    calls = []
    slots = fused.ascii_slots
    monkeypatch.setattr(fused, "ascii_slots", lambda *a: calls.append(1) or slots(*a))
    launches, syncs = dict(fused.LAUNCHES), collections.Counter(profiling.SYNCS)
    _clear_profiled()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=acts):
        b.run_batch(READS, device=dev)
    added = {k: v - launches[k] for k, v in fused.LAUNCHES.items() if v != launches[k]}
    return len(calls), added, profiling.SYNCS - syncs, set(profiling.PROFILED["span_s"])


@pytest.mark.parametrize("ranges", [1, 3])
def test_matrix_run_batch_folds_once_a_range_and_probes_once(ranges, monkeypatch):
    """On the CPU: one ascii_slots call a launch range (its plain version,
    so no launch is counted), one dna probe a call, no blocking upload (each
    range staged in one piece), and the three spans of the matrix route
    recorded."""
    staged = collections.Counter(profiling.STAGED)
    calls, added, syncs, spans = _matrix_call_counts("cpu", monkeypatch, ranges)
    assert calls == ranges and added == {}
    assert syncs["dna probe"] == 1 and "ascii upload" not in syncs
    assert (profiling.STAGED - staged)["pieces"] == 2 * ranges  # the warm call's and the traced
    assert {"ascii upload", "fold on card", "dna probe"} <= spans
    assert not spans & {"fold reads to codes", "slot fill", "stride buckets"}


@pytest.mark.cuda
@pytest.mark.parametrize("ranges", [1, 3])
def test_matrix_run_batch_launches_on_the_card(ranges, monkeypatch):
    """On a card: exactly one ascii_slots launch a launch range beside the
    three minimizer kernels of each, one dna probe a call, and the three
    spans of the matrix route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from simd_minimizers_tpu_torch.ops import fused

    calls, added, syncs, spans = _matrix_call_counts("cuda", monkeypatch, ranges)
    tiles = fused.instance_name(True, pipeline.MODE_MINIMIZERS, True)
    assert calls == ranges
    assert added == {"ascii_slots": ranges, tiles: ranges, "tile_offsets": ranges,
                     "tile_append": ranges}
    assert syncs["dna probe"] == 1 and "ascii upload" not in syncs
    assert {"ascii upload", "fold on card", "dna probe"} <= spans


@pytest.mark.parametrize("batch_max_bp,masked", [(0, True), (0, False), (1000, True),
                                                 (1000, False)])
def test_records_split_keys_are_unchanged(batch_max_bp, masked):
    with profiling.split_wall() as parts:
        backend.sketch_records(RECORDS, K, W, HASHER, pipeline.MODE_MINIMIZERS,
                               MASKS if masked else None, device="cpu",
                               batch_max_bp=batch_max_bp)
    want = {"upload", "kernels", "seam merge"} | ({"mask packing"} if masked else set())
    if batch_max_bp:
        want |= {"slot fill", "upload and padding plane", "read attribution and order",
                 "split by record"}
    assert set(parts) == want


def test_stage_under_a_split_and_the_profiler_is_timed_and_traced(tmp_path):
    """A stage is timed into the split and traced as a span; a span is only
    traced; a stage inside a stage is a span of its own in the trace."""
    with profiling.trace(str(tmp_path)) as path:
        with profiling.split_wall() as parts:
            with profiling.stage("outer"):
                with profiling.stage("inner"):
                    with profiling.span("step"):
                        pass
    assert list(parts) == ["outer"]
    spans = {name: (a, b) for name, a, b in _spans(path)}
    assert set(spans) == {"outer", "inner", "step"}
    assert spans["outer"][0] <= spans["inner"][0] <= spans["step"][0]
    assert spans["step"][1] <= spans["inner"][1] <= spans["outer"][1]


def test_counts_go_to_profiled_only_under_the_profiler():
    """PROFILED takes the counts made inside the port's spans while a
    profiler records, once however deep the spans nest; counts outside
    a span, or with no profiler, stay in SYNCS and BUS_BYTES alone."""
    from torch.profiler import ProfilerActivity, profile

    _clear_profiled()
    profiling.count_sync("here")
    profiling.count_bytes("h2d pinned", 10)
    with profiling.span("step"):
        profiling.count_sync("here")
    assert all(not c for c in profiling.PROFILED.values())
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_sync("outside")
        with profiling.span("step"):
            profiling.count_sync("here", 2)
            with profiling.span("inner"):
                profiling.count_sync("here")
                profiling.count_bytes("h2d pinned", 10)
    assert profiling.PROFILED["syncs"] == {"here": 3}
    assert profiling.PROFILED["bus_bytes"] == {"h2d pinned": 10}
    assert set(profiling.PROFILED["span_s"]) == {"step", "inner"}
    _clear_profiled()


@pytest.mark.parametrize("profiled", [False, True])
def test_short_call_opens_spans_only_under_a_profiler(profiled, monkeypatch):
    """Without a profiler the one-shot short call opens no span and asks
    whether one records once in each of launch, harvest and sketch; under
    one each step is a span."""
    from torch.profiler import ProfilerActivity, profile

    from simd_minimizers_tpu_torch.ops import device_sketcher

    _short()
    checks, opened = [], []
    monkeypatch.setattr(device_sketcher, "recording",
                        lambda: checks.append(1) or profiling.recording())
    monkeypatch.setattr(device_sketcher, "span",
                        lambda name: opened.append(name) or profiling.span(name))
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        _short()
    assert len(checks) == 3
    assert opened == (["short", "short stage in", "short launch", "short unpack", "short release"]
                      if profiled else [])


@pytest.mark.cuda
def test_short_path_spans_on_the_card(tmp_path):
    """On a card the short call's five steps are spans of its own, the wait
    among them, and its copies are pinned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sk = ShortSeqSketcher(K, W, HASHER, device="cuda")
    sk.sketch(SHORT)
    syncs, moved = collections.Counter(profiling.SYNCS), collections.Counter(profiling.BUS_BYTES)
    with profiling.trace(str(tmp_path)) as path:
        sk.sketch(SHORT)
    assert {name for name, _, _ in _spans(path)} == {"short", "short stage in", "short launch",
                                                     "short wait", "short unpack", "short release"}
    assert dict(profiling.SYNCS - syncs) == {"short wait": 1}
    assert set(profiling.BUS_BYTES - moved) == {"h2d pinned", "d2h pinned"}
