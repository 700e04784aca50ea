"""The control of `correct`: the reference with one guarantee broken, put
in the program's place, must come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's inputs as a run does, answers every part
of one call (every record, every read batch, every pool sequence) with the
control (`make(config, control=True)` of the configuration's reference;
for minimizers the leftmost minimum in every window, which breaks the
canonical guarantee that a position does not depend on the strand read),
and counts the parts that differ from the reference by the run's own
comparison (`check.py`). Prints one JSON line per seed. A run is correct
only with no part differing, so the control fails where it counts one or
more. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run  # first: it puts the checkout on the path and its caches inside it
import check  # noqa: E402
import gen  # noqa: E402
import reference  # noqa: E402


def control_reading(workload: str, seed: int, bench: dict | None = None) -> dict:
    """{differing_parts, parts}: the control's parts that differ from the
    reference over every part of one call of the cell, with seed `seed`,
    on `run.DEVICE`."""
    bench = bench or run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, traffic = run.cell_spec(workload, bench)
    inputs = gen.make(traffic, seed, run.DEVICE)
    ctrl = reference.make(config, control=True)
    kept = list(gen.expected(inputs, range(len(inputs.parts)), ctrl, run.DEVICE))
    bad, parts = check.differing(inputs, kept, reference.make(config), run.DEVICE)
    return {"differing_parts": bad, "parts": parts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run.DEVICE = args.device
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = control_reading(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
