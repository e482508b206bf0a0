"""One run of one cell: set-up, the measured window, with `--trace 1` the
traced window and the per-layer metrics, then the comparison that decides
`correct`, and the result.

An entry module (entries/<name>.py) gives `setup(cell, seed, device)` ->
a session with:
  * `window(seconds)`: drives the timed path for `seconds` and returns
    {"attempted", "failed", "metrics": {end-to-end name: value}, ...};
  * `traced_window()`: a short run of the same path under the profiler,
    returning the per-layer context (`trace`, spans, work counts);
  * `release()`: frees the program's state;
  * `check()`: runs the plain reference and returns {name: value} of the
    numbers a run reads; each that the cell's limits file names is
    compared against its limit.
"""

import sys
import time

import torch

from . import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "mde_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is the JAX stack's
    or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class RunError(RuntimeError):
    """A run that must end without a result."""


def device_info(device, chips):
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def require_cards(chips):
    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false: the benchmark runs only on "
                       "NVIDIA cards and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")


def run(workload, seed, seconds, trace, started, device="cuda", spec=None,
        traffic_overrides=None, config_overrides=None):
    """The result dict of one run and the compared numbers with their
    limits. `started` is the host clock when the process began. The tests
    run it on the CPU at small sizes (`device`, the overrides)."""
    cell = cells.resolve(workload, spec)
    cell.traffic = {**cell.traffic, **(traffic_overrides or {})}
    cell.config = {**cell.config, **(config_overrides or {})}
    if device == "cuda":
        require_cards(cell.chips)
    session = cells.entry(cell).setup(cell, seed, device)
    setup_s = time.perf_counter() - started

    result = session.window(seconds)
    metrics = {}
    if trace:
        ctx = session.traced_window()
        ctx.update(window=result, cell=cell, device=device)
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_trace = ctx["trace"]
        busy = {"busy_s": dev_trace.busy_s, "window_s": dev_trace.window_s}
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        busy = {}
    device_record = dict(device_info(device, cell.chips), **busy)
    session.release()
    print(f"run: set-up {setup_s:.3f} s, window {result['seconds']:.3f} s, "
          f"{result['attempted']} attempted", file=sys.stderr)

    t0 = time.perf_counter()
    readings = session.check()
    print(f"run: the plain reference's check took {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    for k, v in readings.items():
        if k not in cell.limits:  # PERF.md names it, with its readings
            print(f"not compared {k}: {v!r} (no limit for this cell)", file=sys.stderr)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()
              if k in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of the JAX stack or package are loaded: {found}")
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": device_record}
    if trace:
        out["breakdown"] = dev_trace.breakdown
    out["checks"] = checks
    return out
