"""The traced window: spans of the harness's own around calls into the
program's layers, torch.profiler over the window, and its reduction to
kernel intervals, span device times, the busy time and the breakdown.

Spans wrap instance attributes of objects the harness built (a module's
`forward`, the optimizer's `step`, a cue embedder); nothing in the program
changes. A span's device time is that of the kernels launched inside it,
as the profiler attributes them (the `record_function` range's
`device_time_total`).
"""

import functools
import time

import torch

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def spanned(fn, name):
    """fn wrapped in a profiler range named `name`."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def wrap_forward(module, name):
    module.forward = spanned(module.forward, name)


def _union(intervals):
    """Merged (start, end) intervals of sorted input."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _device_time(e):
    us = getattr(e, "device_time_total", None)
    return e.cuda_time_total if us is None else us


class Trace:
    """What a traced window left: `kernels` [(name, start_us, end_us)] of
    compute kernels, `copies` of memcpy and memset, `spans` {name: device
    us}, `window_s`, `busy_s` and `breakdown`."""

    def __init__(self, prof, window_s, span_names):
        from torch.autograd import DeviceType
        events = prof.events()
        host = [e for e in events if e.device_type == DeviceType.CPU]
        # a profiler range also shows on the device's timeline, under its host
        # name, spanning the kernels launched inside it: not device work
        ranges = {e.name for e in host}
        device = [e for e in events
                  if e.device_type != DeviceType.CPU and e.name not in ranges]
        self.window_s = window_s
        self.kernels = [(e.name, e.time_range.start, e.time_range.end) for e in device
                        if not e.name.startswith(COPY_PREFIXES)]
        self.copies = [(e.name, e.time_range.start, e.time_range.end) for e in device
                       if e.name.startswith(COPY_PREFIXES)]
        self.spans = {name: 0.0 for name in span_names}
        for e in host:
            if e.name in self.spans:
                self.spans[e.name] += _device_time(e)
        busy = _union([(a, b) for _, a, b in self.kernels + self.copies])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.breakdown = {"device_ops": self._top_ops(), "idle_gaps": self._gaps(busy, host)}

    def kernel_us(self, *names):
        """Device us of the kernels whose name holds one of `names`."""
        return sum(b - a for n, a, b in self.kernels if any(s in n for s in names))

    def _top_ops(self, n=10):
        by_name = {}
        for name, a, b in self.kernels + self.copies:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return [[k[:200], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    @staticmethod
    def _gaps(busy, host, n=10):
        """The n longest idle gaps between device activity, each named by
        the innermost host event running at its start."""
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                       for i in range(len(busy) - 1)), reverse=True)[:n]
        out = []
        for length, start in gaps:
            around = [e for e in host if e.time_range.start <= start < e.time_range.end]
            name = (min(around, key=lambda e: e.time_range.elapsed_us()).name
                    if around else "host idle")
            out.append([name[:200], length / 1e6])
        return out


def traced(fn, span_names, device="cuda"):
    """Run fn() under the profiler, synchronized at both ends; returns
    (fn's result, Trace). On the CPU (the tests) only host events exist."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    return out, Trace(prof, window_s, span_names)
