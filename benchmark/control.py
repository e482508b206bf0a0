#!/usr/bin/env python3
"""Readings that set the upper ends of a cell's limits; the benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--program] [--device cuda]

For each seed it makes the cell's weights and inputs as a run does, runs the
plain reference, and puts in the program's place (with `--program`, beside
the program itself, driven as a run's set-up drives it):
  * the control: the reference computed in the precision below the one the
    configuration states (the limits file's "control": "fp8" for a bf16
    training step);
  * the fault of half of each batch left out, the loss the mean over the
    rest, in the reference;
  * two looks at the reference against itself: `ulp`, from weights each
    moved by one float32 unit in the last place, up or down at random;
    `order`, with cuDNN choosing its convolutions' algorithms by timing
    them, so that only the order of their sums changes: how far the numbers
    swing for a change below the rounding the configuration makes.
It prints one JSON line a seed with the numbers `correct` compares, each
reading of a side beside the reference. A step that returns its state
unchanged reads 1 on each leaf's change gap by its definition (about 1 on
`median_change_gap`) and needs no run.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import cells, compare, traffic  # noqa: E402
from benchmark.harness.weights import seeded_state_dict  # noqa: E402
from benchmark.reference import plain  # noqa: E402


def moved_by_one_ulp(weights, seed):
    """Each floating-point weight moved by one unit in its last place, up or
    down as a generator seeded from `seed` draws."""
    out = {}
    for i, (k, w) in enumerate(weights.items()):
        if w.is_floating_point():
            gen = torch.Generator(device=w.device).manual_seed(traffic.sub_seed(seed, 4, i))
            up = torch.rand(w.shape, generator=gen, device=w.device) < 0.5
            w = torch.nextafter(w, torch.where(up, torch.inf, -torch.inf).to(w.dtype))
        out[k] = w
    return out


@contextlib.contextmanager
def algorithms_by_timing():
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def train_readings(cell, seed, device, lower, program, dump=None):
    config, t = cell.config, cell.traffic
    readings = {}
    if program:  # the program's first steps, as a run's set-up drives them
        session = cells.entry(cell).setup(cell, seed, device)
        session.release()
        pool, sides = session.pool[:t["checked_steps"]], {
            "program": (session.losses, session.first, session.change)}
    else:
        pool, sides = traffic.train_pool(t, plain.has_cues(config), seed, device)[
            :t["checked_steps"]], {}
    weights = seeded_state_dict(plain.model(config).state_dict(),
                                traffic.sub_seed(seed, 0), device)

    def steps(w=weights, **kw):
        return plain.train_steps(config, w, pool, seed, device, **kw)

    reference = steps()
    sides.update(control=steps(lower=lower), half_batch=steps(half_batch=True),
                 ulp=steps(moved_by_one_ulp(weights, seed)))
    with algorithms_by_timing():
        sides["order"] = steps()
    for label, side in sides.items():
        compared, look = compare.train_gaps(side, reference)
        readings[label] = {**compared, "look": look}
    if dump is not None:  # every leaf's norms, to choose the numbers compared
        Path(dump).mkdir(parents=True, exist_ok=True)
        (Path(dump) / f"{cell.name}.{seed}.json").write_text(json.dumps(
            {"reference": reference, **sides}))
    return readings


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--program", action="store_true",
                        help="also read the program's numbers on each seed, as a run "
                             "compares them, in this one process")
    parser.add_argument("--dump", default=None,
                        help="write every leaf's norms of each side to this directory")
    args = parser.parse_args()
    cell = cells.resolve(args.workload)
    lower = cell.limits["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        out = train_readings(cell, seed, args.device, lower, args.program, args.dump)
        print(json.dumps({"workload": args.workload, "seed": seed, "lower": lower, **out}),
              flush=True)
    if args.device == "cuda":
        print(json.dumps({"card": torch.cuda.get_device_name(0),
                          "peak_bytes": torch.cuda.max_memory_allocated()}))


if __name__ == "__main__":
    main()
