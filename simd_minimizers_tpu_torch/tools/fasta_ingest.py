"""FASTA ingestion walls and peak memory: `read_fasta` through the NumPy scan
against the native scan, on a genome-shaped file.

    python -m simd_minimizers_tpu_torch.tools.fasta_ingest [--records chr21,chr22]
        [--seed S] [--routes numpy,native,native,numpy] [--dir D]

Writes a FASTA of GRCh38's 24 primary chromosomes at their published
lengths and 200 contigs of 10-200 kbp (`--records` keeps only the named
ones): random bases from the seed, 200 runs of N per 1e8 bases and isolated
Ns at rate 1e-4, 100 lowercase stretches of 1,000-50,000 bases a record,
60-char lines. Then, for each route in turn, `read_fasta` of that file in a
process of its own: `numpy` swaps in `fasta_scan_plain` (the NumPy passes),
`native` is the default C++ scan. Each run prints its wall, its resident
memory before the read and its peak above that (getrusage, and
/proc/self/statm sampled every 5 ms), and whether every record came back as
written (a sha256 of names, codes and flags). Exits nonzero if one did not.
The file is written under `build/` at the root of the checkout (or `--dir`)
and removed. Runs on the host alone; the card is not used.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# GRCh38's primary chromosomes (the assembly's published sequence lengths):
# 3,088,269,832 bp in all.
GRCH38 = [("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
          ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
          ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
          ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
          ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
          ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
          ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
          ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415)]
N_CONTIGS, CONTIG_BP = 200, (10_000, 200_000)  # unplaced-scaffold-like contigs
ROUTES = ("numpy", "native")
ROOT = Path(__file__).resolve().parents[2]


def genome_records(seed: int) -> list[tuple[str, int]]:
    """(name, length) of the genome's records."""
    rng = np.random.default_rng(seed)
    return GRCH38 + [(f"contig{i}", int(n)) for i, n in
                     enumerate(rng.integers(CONTIG_BP[0], CONTIG_BP[1] + 1, N_CONTIGS))]


def _record(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes, N flags) of one record."""
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    amb = np.zeros(n, bool)
    runs = max(1, round(200 * n / 1e8))
    for start, length in zip(rng.integers(0, n, runs), rng.integers(1000, 20_001, runs)):
        amb[start:start + length] = True
    amb[rng.integers(0, n, rng.binomial(n, 1e-4))] = True
    return codes, amb


def write_fasta(path, records, seed: int) -> tuple[int, str]:
    """Write `records` [(name, length)] as a FASTA; returns the bases
    written and the sha256 of what `read_fasta` must give back (each name,
    its codes with 3 where N, its flags)."""
    rng = np.random.default_rng([seed, 1])
    h, bp = hashlib.sha256(), 0
    with open(path, "wb") as f:
        for name, n in records:
            codes, amb = _record(rng, n)
            seq = np.frombuffer(b"ACTG", np.uint8)[codes]  # code order: (c >> 1) & 3
            seq[amb] = ord("N")
            for a, m in zip(rng.integers(0, max(n, 1), 100), rng.integers(1000, 50_001, 100)):
                seq[a:a + m] |= 0x20
            f.write(f">{name} GRCh38-length random\n".encode())
            lines = -(-n // 60)
            body = np.full((lines, 61), ord("\n"), np.uint8)
            flat = np.zeros(lines * 60, np.uint8)
            flat[:n] = seq
            body[:, :60] = flat.reshape(lines, 60)
            f.write(body.ravel()[:n + lines - 1].tobytes() + b"\n")  # the last line's end
            h.update(name.encode())
            h.update(np.where(amb, np.uint8(3), codes))
            h.update(amb.astype(np.uint8))
            bp += n
    return bp, h.hexdigest()


def _rss_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 2**20


def read_once(path: str, route: str) -> dict:
    """`read_fasta` of `path` through `route`, in this process: wall, peak
    resident memory and the records' sha256."""
    from .. import native
    from ..seq import fasta

    if route == "numpy":
        fasta.fasta_scan = fasta.fasta_scan_plain
    else:
        native.library()  # built before the clock starts
    before = _rss_mib()
    sampled, done = [before], threading.Event()

    def sample():
        while not done.wait(0.005):
            sampled.append(_rss_mib())

    sampler = threading.Thread(target=sample)
    sampler.start()
    t = time.perf_counter()
    recs = fasta.read_fasta(path)
    wall = time.perf_counter() - t
    done.set()
    sampler.join()
    h = hashlib.sha256()
    for r in recs:
        h.update(r.name.encode())
        h.update(r.codes)
        h.update(r.ambiguous)
    return {"route": route, "wall_s": wall, "rss_before_mib": before,
            "peak_extra_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 - before,
            "sampled_peak_extra_mib": max(sampled) - before, "records": len(recs),
            "bp": sum(len(r) for r in recs), "sha256": h.hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", default=None, help="comma-separated names to keep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--routes", default="numpy,native,native,numpy")
    ap.add_argument("--dir", default=None, help="where the file is written (then removed)")
    ap.add_argument("--read", nargs=2, metavar=("PATH", "ROUTE"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.read:  # a child: one read, one JSON line
        print(json.dumps(read_once(*args.read)))
        return 0
    routes = args.routes.split(",")
    if not set(routes) <= set(ROUTES):
        ap.error(f"routes are {ROUTES}")
    records = genome_records(args.seed)
    if args.records:
        keep = args.records.split(",")
        records = [r for r in records if r[0] in keep]
        if len(records) != len(keep):
            ap.error(f"not all of {keep} are records of the genome")
    base = Path(args.dir) if args.dir else ROOT / "build"
    base.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base)
    ok, runs = True, []
    try:
        path = os.path.join(tmp, "genome.fa")
        t = time.perf_counter()
        bp, digest = write_fasta(path, records, args.seed)
        size = os.path.getsize(path)
        print(f"FASTA of {len(records)} records, {bp} bp, {size} bytes written in "
              f"{time.perf_counter() - t:.1f} s")
        for route in routes:
            res = subprocess.run([sys.executable, "-m", __spec__.name, "--read", path, route],
                                 cwd=ROOT, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"read_fasta ({route}) failed ({res.returncode}):\n{res.stderr}")
            got = json.loads(res.stdout.strip().splitlines()[-1])
            same = got["sha256"] == digest and got["bp"] == bp
            ok &= same
            runs.append(got)
            print(f"read_fasta, {route} scan: wall {got['wall_s']:.3f} s "
                  f"({size / got['wall_s'] / 1e9:.3f} GB/s); {got['records']} records, "
                  f"{got['bp']} bp; resident {got['rss_before_mib']:.0f} MiB before, peak extra "
                  f"{got['peak_extra_mib']:.0f} MiB by getrusage, "
                  f"{got['sampled_peak_extra_mib']:.0f} MiB sampled; records as written: {same}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"records": len(records), "bp": bp, "bytes": size, "ok": ok, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
