#!/usr/bin/env python3
"""The benchmark of mde_tpu_torch: one run of one cell on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. `BENCHMARK.json` names the cells; each cell's
configuration, traffic mix, limits, entry and per-layer metrics are files
under benchmark/ found by name (harness/cells.py). The run makes its weights
and inputs from `--seed`, warms up the cell's shapes (set-up, `setup_s`),
measures for `--seconds`, and with `--trace 1` traces a short window after
it and reports the per-layer metrics in place of the end-to-end ones. It
then compares what the timed path produced with the plain reference
(reference/) and prints each number compared beside its limit, last on
standard error, and one JSON line last on standard output.

It exits non-zero with no result when no card is there (it never falls back
to the CPU), when the cell asks for more cards than torch sees, and when a
module of JAX or of the JAX package `mde_tpu` is loaded once the window has
closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import runner  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one process with few threads: the timed path runs on the card, and
    # idle host threads only contend with the thread that launches it
    torch.set_num_threads(1)
    try:
        out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), STARTED)
    except runner.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
