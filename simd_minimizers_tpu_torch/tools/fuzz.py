"""Randomized differential fuzz of the port's entry points against its oracle.

    python -m simd_minimizers_tpu_torch.tools.fuzz [--seed S] [--configs N]
        [--seconds T] [--device cuda|cpu] [--index I]

The counterpart of the JAX package's `tools/fuzz_extended.py` (random
geometries through the kernel) and `tools/fuzz_shards.py` (random shard
counts, low-entropy alphabets and Ns at the shard seams through the
multi-process seam merge). Config i of seed S is drawn from its own
generator, `default_rng([S, i])`, so `--index I` re-runs config I alone:

- k in 1..64 (antilex: 1..32), w in 1..2,600, and one config in six on the
  large-w route (w in LARGE_W_MIN..61,439, so TILE + w <= 2^16);
- n from l to about 60,000 chars (on the large-w route up to l + 6,000),
  a tenth of the configs exactly 4,095, 4,096 or 4,097 windows past a tile
  edge;
- every mode (minimizers, super-k-mers, closed and open syncmers; open
  syncmers at odd w), canonical only where l is odd;
- the nt, mul and antilex hashers, each with its default table or seeded
  (antilex has no seed);
- the input kinds packed 2-bit (a `PackedSeqVec`, sliced at a base offset
  of 0..3), 2-bit codes one per byte, text bytes, and text of ACGT bytes
  only (a `GenericSeq`, hashed as text);
- masks (not for super-k-mers, which the entry points refuse with one):
  none, sparse at 2%, one clustered run, or runs at the span or shard
  seams; alphabets of 1, 2 or 4 symbols (long tie runs across seams).

Each config goes through one entry point, in turn: `Builder.run` (with a
mask on canonical minimizers `run_skip_ambiguous_windows`; on a third of
the configs also `Output.values_u64` / `values_u128_limbs`, every other of
them asked for in the run, `values=True`, where the sketch call computes
them: 2-bit values of at most 32 chars, syncmers' too), the span
drivers `ops/spans.sketch_long` and `ops/spans.sketch_records` with small
spans, `Builder.run_batch` (a list of reads; on every other of its configs
but those of ACGT text, which a matrix would fold to codes, a (B, L) ASCII
matrix of equal-length rows with a (B, L) mask: the matrix route, staged
through pinned buffers and folded on the card),
`parallel/shard.fused_sharded_sketch` and the
multi-process seam merge (`multihost.local_shard_sketch` for each shard,
then `spans.merge`) over 1..9 shards of the one device,
and `ShortSeqSketcher` (inputs up to its capacity, no mask). Every result
is compared bit for bit with the port's oracle (`ops/oracle.py`:
`selected_stream`, then `collect_and_dedup`, `collect_and_dedup_with_index`
or `collect_syncmers`), values with the port's NumPy values
(`ops/values.py` limbs). The oracle runs on a pool of threads while the
device runs the next configs.

On the first mismatch (or exception) it prints one line, `FUZZ MISMATCH`
or `FUZZ ERROR`, with the config and exits nonzero. Otherwise it prints the
configs per entry, mode, route, hasher, input kind and mask, configs per
second and the slowest config, then one JSON line of the same. The device
is the card unless `--device cpu` is given; on the CPU the kernels' plain
versions run. It never falls back from the card to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import api, convert
from ..hashers import AntiLexHasher, MulHasher, NtHasher
from ..ops import fused, oracle, pipeline, spans, values
from ..ops.device_sketcher import ShortSeqSketcher
from ..parallel import multihost, shard
from ..seq.packed import AsciiSeq, GenericSeq, PackedNSeqVec, PackedSeqVec
from ..utils.device import require_cuda

ENTRIES = ("run", "sketch_long", "sketch_records", "run_batch", "shard", "multihost", "short")
HASHERS = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}
KINDS = ("packed", "codes", "text", "acgt_text")
# the kinds each entry takes: the sharded drivers and the short sketcher
# read 2-bit codes only
ENTRY_KINDS = {"run": KINDS, "sketch_long": KINDS, "sketch_records": ("codes", "text", "acgt_text"),
               "run_batch": KINDS, "shard": ("codes",), "multihost": ("codes",),
               "short": ("codes",)}
MASKS = ("none", "sparse", "run", "seams")
MAX_W = (1 << 16) - fused.TILE - 1  # the widest w with TILE + w <= 2^16 at odd w
LARGE_W_EVERY = 6  # config i takes the large-w route where i % 6 == 5
MAX_N = 60_000
ACGT = np.frombuffer(b"ACTG", np.uint8)  # code c as its ASCII letter ((c >> 1) & 3 == c)
# text symbols of a matrix's rows: no row may be all ACGTacgt, which the
# matrix route folds to 2-bit codes
NOT_ACGT = np.setdiff1d(np.arange(32, 127, dtype=np.uint8), np.frombuffer(b"ACGTacgt", np.uint8))


@dataclasses.dataclass
class Config:
    seed: int
    index: int
    entry: str
    k: int
    w: int
    mode: str
    hasher: str
    hasher_seed: int | None
    canonical: bool
    kind: str
    mask: str
    alphabet: int
    lengths: list  # chars of each piece (one for the single-sequence entries)
    shards: int = 1
    span_chars: int = 0
    offset: int = 0  # base offset of the packed slice
    values: bool = False
    values_in_call: bool = False  # Builder.run(..., values=True)
    matrix: bool = False  # run_batch of a (B, L) ASCII matrix, not a list

    @property
    def l(self) -> int:
        return self.k + self.w - 1

    def route(self) -> str:
        t = fused.sub_tile(self.k, self.w, self.canonical, self.mode, self.mask != "none",
                           self.kind in ("text", "acgt_text"), self.hasher)
        return "large-w" if t else "stored"

    def line(self) -> str:
        d = dataclasses.asdict(self)
        d["n"] = d.pop("lengths")
        d["route"] = self.route()
        return " ".join(f"{key}={val}".replace(" ", "") for key, val in d.items())


def _draw_w(rng, large: bool) -> int:
    if large:
        return int(rng.integers(fused.LARGE_W_MIN, MAX_W + 1))
    u = rng.random()
    if u < 0.6:
        return int(rng.integers(1, 64))
    if u < 0.85:
        return int(rng.integers(64, 600))
    return int(rng.integers(600, min(2601, fused.LARGE_W_MIN)))  # below the large-w route


def _draw_n(rng, l: int, large: bool, cap: int | None) -> int:
    """Chars of the main piece: a tenth exactly 4095 / 4096 / 4097 windows
    past a tile edge, the rest from l to MAX_N (large w: to l + 6,000)."""
    if rng.random() < 0.1:
        tiles = 1 if large else int(rng.integers(1, 4))
        n = tiles * fused.TILE + int(rng.integers(-1, 2)) + l - 1
    else:
        n = int(rng.integers(l, (l + 6_000 if large else max(MAX_N, l + 1)) + 1))
    return min(n, cap) if cap is not None else n


def draw(seed: int, index: int) -> Config:
    """Config `index` of `seed`, from its own generator."""
    rng = np.random.default_rng([seed, index])
    entry = ENTRIES[index % len(ENTRIES)]
    large = index % LARGE_W_EVERY == LARGE_W_EVERY - 1
    hasher = str(rng.choice(list(HASHERS)))
    k = int(rng.integers(1, 33 if hasher == "antilex" else 65))
    w = _draw_w(rng, large)
    mode = str(rng.choice(pipeline.MODES))
    if mode == pipeline.MODE_OPEN_SYNCMERS and w % 2 == 0:
        w = w + 1 if w < MAX_W else w - 1
    l = k + w - 1
    canonical = bool(rng.integers(0, 2)) and l % 2 == 1
    hasher_seed = None if hasher == "antilex" or rng.random() < 0.5 else int(
        rng.integers(0, 2**40))
    kind = str(rng.choice(ENTRY_KINDS[entry]))
    mask = "none" if mode == pipeline.MODE_SUPERKMERS or entry == "short" else str(
        rng.choice(MASKS))
    alphabet = int(rng.choice([1, 2, 4, 4]))
    cap = 8 * 1024 + l - 1 if entry == "short" else None  # ShortSeqSketcher's capacity
    lengths = [_draw_n(rng, l, large, cap)]
    if entry in ("sketch_records", "run_batch"):
        # more pieces: empty, below one window, at one window, and random
        extra = [0, l - 1, l, l + 1] if large else [0, max(l - 1, 0), l, l + 1, 3 * l + 500]
        lengths += [int(x) if i % 2 else int(rng.choice(extra))
                    for i, x in enumerate(rng.integers(l, l + (2_000 if large else 20_000),
                                                       int(rng.integers(0, 6))))]
    cfg = Config(seed, index, entry, k, w, mode, hasher, hasher_seed, canonical, kind, mask,
                 alphabet, lengths)
    if entry in ("shard", "multihost"):
        cfg.shards = int(rng.integers(1, 10))
    if entry in ("sketch_long", "sketch_records"):
        # small spans, as the JAX fuzz forces them: several seams per piece
        n = max(lengths)
        cfg.span_chars = max(int(rng.integers(l + 1, max(n, l + 2) + 1)), 2 * l)
    if kind == "packed" and entry == "run":
        cfg.offset = int(rng.integers(0, 4))
    if entry == "run_batch" and kind != "acgt_text" and index // len(ENTRIES) % 2:
        cfg.matrix = True
        cfg.lengths = [lengths[0]] * len(lengths)
    cfg.values = entry == "run" and index % 3 == 0
    cfg.values_in_call = (cfg.values and index // len(ENTRIES) % 2 == 0
                          and kind not in ("text", "acgt_text")
                          and spans.value_length(k, w, mode) <= 32)
    if not fused.fused_supported(k, w, canonical, mode, mask != "none",
                                 kind in ("text", "acgt_text"), hasher):
        raise AssertionError(f"config outside the kernel's geometry: {cfg.line()}")
    return cfg


def _piece_chars(cfg: Config, rng, n: int) -> np.ndarray:
    """A piece's uint8 chars: 2-bit codes, or text bytes."""
    if cfg.kind == "acgt_text":
        syms = rng.permutation(np.frombuffer(b"ACGT", np.uint8))[:cfg.alphabet]
    elif cfg.kind == "text":
        pool = NOT_ACGT if cfg.matrix else np.arange(32, 127, dtype=np.uint8)
        syms = rng.choice(pool, cfg.alphabet, replace=False)
    else:
        syms = rng.permutation(np.arange(4, dtype=np.uint8))[:cfg.alphabet]
    return syms[rng.integers(0, cfg.alphabet, n)]


def _seams(cfg: Config, n: int) -> list[int]:
    """Chars where the entry cuts a piece: span starts or shard starts."""
    if cfg.entry in ("shard", "multihost"):
        return [multihost.shard_bounds(n, cfg.l, cfg.shards, s)[0] for s in range(1, cfg.shards)]
    if cfg.entry in ("sketch_long", "sketch_records"):
        return [s for s, _ in spans.span_bounds(n, cfg.l, cfg.span_chars)[1:]]
    return []


def _piece_mask(cfg: Config, rng, n: int) -> np.ndarray | None:
    if cfg.mask == "none":
        return None
    amb = np.zeros(n, bool)
    if cfg.mask == "sparse":
        amb |= rng.random(n) < 0.02
    elif cfg.mask == "run":
        start = int(rng.integers(0, max(n, 1)))
        amb[start:start + int(rng.integers(1, 200))] = True
    else:
        # runs that end just before, straddle or start at each seam (the
        # seam re-evaluation must drop SKIPPED runs as the oracle does)
        for s in _seams(cfg, n) or [n // 2]:
            a = max(0, s - int(rng.integers(0, cfg.l + 2)))
            amb[a:min(n, a + int(rng.integers(1, 2 * cfg.l + 1)))] = True
        amb |= rng.random(n) < 0.002
    return amb


def make_inputs(cfg: Config):
    """The config's pieces: [(chars, mask or None)], from its own generator."""
    rng = np.random.default_rng([cfg.seed, cfg.index, 1])
    return [(_piece_chars(cfg, rng, n), _piece_mask(cfg, rng, n)) for n in cfg.lengths]


def hasher_of(cfg: Config):
    return HASHERS[cfg.hasher](cfg.k, canonical=cfg.canonical, seed=cfg.hasher_seed)


def builder_of(cfg: Config) -> api.Builder:
    syncmer = {pipeline.MODE_CLOSED_SYNCMERS: api._SYNCMER_CLOSED,
               pipeline.MODE_OPEN_SYNCMERS: api._SYNCMER_OPEN}.get(cfg.mode, api._SYNCMER_NONE)
    b = api.Builder(cfg.k, cfg.w, cfg.canonical, syncmer).hasher(hasher_of(cfg))
    return b.super_kmers() if cfg.mode == pipeline.MODE_SUPERKMERS else b


def expected(cfg: Config, pieces) -> list[tuple]:
    """The oracle's planes of each piece."""
    h = hasher_of(cfg)
    out = []
    for chars, amb in pieces:
        sel = oracle.selected_stream(chars, cfg.k, cfg.w, h, ambiguous=amb)
        if cfg.mode == pipeline.MODE_SUPERKMERS:
            out.append(oracle.collect_and_dedup_with_index(sel))
        elif cfg.mode in pipeline.SYNCMER_MODES:
            out.append((oracle.collect_syncmers(sel, cfg.w,
                                                cfg.mode == pipeline.MODE_OPEN_SYNCMERS),))
        else:
            out.append((oracle.collect_and_dedup(sel, skip_sentinel=amb is not None),))
    return out


def _planes(res) -> tuple:
    """An entry's result as a tuple of np.uint32 planes."""
    res = res if isinstance(res, tuple) else (res,)
    return tuple(r.cpu().numpy().view(np.uint32) if isinstance(r, torch.Tensor)
                 else np.asarray(r, np.uint32) for r in res)


def _seq_of(cfg: Config, chars: np.ndarray, packed_offset: int = 0):
    """The sequence object `Builder.run` and `run_batch` take for a piece."""
    if cfg.kind == "packed":
        pre = np.zeros(packed_offset, np.uint8)
        full = PackedSeqVec.from_codes(np.concatenate([pre, chars]))
        return full.slice(packed_offset, packed_offset + chars.size)
    if cfg.kind == "codes":
        return AsciiSeq(ACGT[chars])
    return GenericSeq(chars)


def _values_check(cfg: Config, out, chars: np.ndarray) -> None:
    """Output.values_* against the NumPy limbs of ops/values.py."""
    bits = 8 if cfg.kind in ("text", "acgt_text") else 2
    length = out.length
    fn = (values.canonical_kmer_values_u128_limbs if cfg.canonical
          else values.kmer_values_u128_limbs)
    if bits * length <= 64:
        got = out.values_u64()
        want = fn(chars, out.positions, length, bits)[0]
    elif bits * length <= 128:
        got = out.values_u128_limbs()
        want = fn(chars, out.positions, length, bits)
    else:
        return
    for g, p in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,), strict=True):
        if not np.array_equal(np.asarray(g, np.uint64), p):
            raise _Mismatch("values")


class _Mismatch(Exception):
    pass


def run_entry(cfg: Config, pieces, device: torch.device) -> list[tuple]:
    """The config through its entry point on `device`: planes per piece."""
    k, w, mode, l = cfg.k, cfg.w, cfg.mode, cfg.l
    h = hasher_of(cfg)
    text = cfg.kind in ("text", "acgt_text")
    chars, amb = pieces[0]
    if cfg.entry == "run":
        b = builder_of(cfg)
        seq = _seq_of(cfg, chars, cfg.offset)
        if (amb is not None and cfg.canonical and mode == pipeline.MODE_MINIMIZERS and not text
                and not cfg.values_in_call):
            out = b.run_skip_ambiguous_windows(PackedNSeqVec(seq, amb), device=device)
        else:
            out = b.run(seq, ambiguous=amb, device=device, values=cfg.values_in_call)
        if cfg.values_in_call and out._values_u64 is None:
            raise _Mismatch("values not computed in the run")
        if cfg.values:
            _values_check(cfg, out, chars)
        return [(out.positions,) if out.superkmer_indices is None
                else (out.positions, out.superkmer_indices)]
    if cfg.entry == "sketch_long":
        n = chars.size
        if cfg.kind == "packed":
            buf = convert.packed_words(PackedSeqVec.from_codes(chars), device)
        else:
            buf = convert.code_bytes(chars, device)
        plane = None if amb is None else convert.ambiguity_plane(amb, n, device)
        res = spans.sketch_long(buf, n, k, w, h, mode, plane, text=text,
                                byte_codes=cfg.kind == "codes", span_chars=cfg.span_chars)
        return [_planes(res)]
    if cfg.entry == "sketch_records":
        masks = [a for _, a in pieces] if cfg.mask != "none" else None
        res = spans.sketch_records([c for c, _ in pieces], k, w, h, mode, masks, dna=not text,
                                   device=device, span_chars=cfg.span_chars)
        return [_planes(r) for r in res]
    if cfg.entry == "run_batch":
        masks = [a for _, a in pieces] if cfg.mask != "none" else None
        if cfg.matrix:  # ASCII rows, as a FASTQ reader hands them over
            reads = np.stack([c if cfg.kind == "text" else ACGT[c] for c, _ in pieces])
            masks = None if masks is None else np.stack(masks).astype(np.uint8)
        else:
            reads = [_seq_of(cfg, c) for c, _ in pieces]
        rid, *planes = builder_of(cfg).run_batch(reads, ambiguous=masks, device=device)
        bounds = np.searchsorted(rid, np.arange(len(pieces) + 1))
        return [tuple(p[bounds[i]:bounds[i + 1]] for p in planes) for i in range(len(pieces))]
    if cfg.entry == "shard":
        res = shard.fused_sharded_sketch(chars, k, w, h, mode, amb, mesh=[device] * cfg.shards)
        return [_planes(res)]
    if cfg.entry == "multihost":
        n = chars.size
        parts = [multihost.local_shard_sketch(chars, k, w, h, cfg.shards, s, mode, amb,
                                              mesh=[device], device=device.type)
                 for s in range(cfg.shards)]
        starts = [multihost.shard_bounds(n, l, cfg.shards, s)[0] for s in range(cfg.shards)]
        res = spans.merge(parts, starts, mode, k, w, h, chars, amb)
        return [_planes(res)]
    if cfg.entry == "short":
        sk = ShortSeqSketcher(k, w, h, mode, device=device)
        return [_planes(sk.sketch(chars))]
    raise ValueError(f"unknown entry {cfg.entry!r}")


def _equal(got: list[tuple], want: list[tuple]) -> bool:
    return len(got) == len(want) and all(
        len(g) == len(p) and all(np.array_equal(a, b) for a, b in zip(g, p))
        for g, p in zip(got, want))


def _tally(configs: list[Config]) -> dict:
    by = {name: collections.Counter() for name in ("entry", "mode", "route", "hasher", "kind",
                                                   "mask", "values")}
    for c in configs:
        values = "in the call" if c.values_in_call else "asked later" if c.values else "none"
        for name, val in (("entry", c.entry), ("mode", c.mode), ("route", c.route()),
                          ("hasher", c.hasher + ("" if c.hasher_seed is None else ", seeded")),
                          ("kind", c.kind), ("mask", c.mask), ("values", values)):
            by[name][val] += 1
    return {f"by_{name}": dict(sorted(cnt.items())) for name, cnt in by.items()}


class FuzzFailure(Exception):
    """A config whose entry point disagreed with the oracle or raised."""

    def __init__(self, what: str, cfg: Config, detail: str):
        super().__init__(f"FUZZ {what} {cfg.line()} :: {detail}")
        self.cfg = cfg


def run(seed: int = 0, configs: int = 300, seconds: float | None = None,
        device: str = "cuda", index: int | None = None) -> dict:
    """Fuzz `configs` configs of `seed` (or the one config `index`) on
    `device`, stopping new configs after `seconds`. Returns the summary;
    raises FuzzFailure at the first mismatch or error."""
    dev = require_cuda(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    workers = min(8, os.cpu_count() or 1)
    indices = [index] if index is not None else range(configs)
    done, times = [], {}
    t0 = time.perf_counter()
    pending = collections.deque()

    def settle(cfg, got, fut, t_entry):
        try:
            want = fut.result()
        except Exception as e:
            raise FuzzFailure("ERROR", cfg, f"oracle: {e!r}") from e
        if not _equal(got, want):
            raise FuzzFailure("MISMATCH", cfg, "positions differ from the oracle")
        times[cfg.index] = t_entry
        done.append(cfg)

    with ThreadPoolExecutor(workers) as pool:
        for i in indices:
            if seconds is not None and time.perf_counter() - t0 > seconds:
                break
            cfg = draw(seed, i)
            pieces = make_inputs(cfg)
            fut = pool.submit(expected, cfg, pieces)
            t = time.perf_counter()
            try:
                got = run_entry(cfg, pieces, dev)
            except _Mismatch as e:
                raise FuzzFailure("MISMATCH", cfg, f"{e} differ from NumPy's") from None
            except Exception as e:
                raise FuzzFailure("ERROR", cfg, repr(e)) from e
            pending.append((cfg, got, fut, time.perf_counter() - t))
            while pending and (len(pending) > 2 * workers or pending[0][2].done()):
                settle(*pending.popleft())
        while pending:
            settle(*pending.popleft())
    wall = time.perf_counter() - t0
    slowest = max(done, key=lambda c: times[c.index]) if done else None
    return {"seed": seed, "configs": len(done), "mismatches": 0, "device": str(dev),
            "seconds": wall, "configs_per_s": len(done) / wall if wall else 0.0,
            **_tally(done),
            "slowest": None if slowest is None else {
                "entry_s": times[slowest.index], "config": slowest.line()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", type=int, default=300)
    ap.add_argument("--seconds", type=float, default=None,
                    help="start no new config after this many seconds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--index", type=int, default=None, help="run only this config")
    args = ap.parse_args(argv)
    try:
        summary = run(args.seed, args.configs, args.seconds, args.device, args.index)
    except FuzzFailure as e:
        print(e, flush=True)
        if e.__cause__ is not None:  # an exception of the entry or the oracle: its traceback
            raise
        return 1
    print(f"fuzz: {summary['configs']} configs of seed {summary['seed']} on "
          f"{summary['device']}, 0 mismatches, {summary['seconds']:.1f} s "
          f"({summary['configs_per_s']:.2f} configs/s)")
    for key in ("by_entry", "by_mode", "by_route", "by_hasher", "by_kind", "by_mask",
                "by_values"):
        print(f"  {key[3:]}: " + ", ".join(f"{k} {v}" for k, v in summary[key].items()))
    if summary["slowest"]:
        print(f"  slowest: {summary['slowest']['entry_s']:.3f} s through its entry: "
              f"{summary['slowest']['config']}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
