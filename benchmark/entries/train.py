"""Entry: the training step of mde_tpu_torch, closed loop, steps back to back.

Set-up builds one training state and step as the program's users build
them: the configuration's params file through the program's parser
(`config/parsers.py`), `models.build_model` on the device with the seeded
weights, `train/state.py::create_train_state`, the cue embedders, and
`train/loop.py::make_train_step`. It drives that state through the traffic's
"checked_steps" first steps, one batch of the pool each, and keeps their
losses, the first gradient as the optimizer got it (AdamW's first moment
after one update over 1 - beta1) and the parameters' change over the steps.
Those steps warm up every shape the window uses. The window then runs steps
on the pool's batches in turn until `--seconds` have passed, and waits for
the device: images over the whole window's time.

After the window the program's state is freed and the plain reference runs
the same first steps from the same seeded weights on the same batches.
"""

import gc
import json
import sys
import time

import torch

from benchmark.harness import compare, trace as tracing, traffic
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference import plain, work

CUE_MODULES = ("semantics_areas_fc", "semantics_absolute_sizes_fc", "instance_areas_fc",
               "instance_absolute_sizes_fc")
SPANS = ("model.forward", "optimizer.step", "cues")


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def program_args(config, seed, device):
    from mde_tpu_torch.config.parsers import TrainArgParser, parse_cli
    return parse_cli(TrainArgParser(), [config["params_file"], *config["overrides"],
                                        "--seed", str(seed), "--device", device])


class Session:
    def __init__(self, cell, seed, device):
        from mde_tpu_torch.models import build_model
        from mde_tpu_torch.train import create_train_state
        self.config, self.traffic = cell.config, cell.traffic
        self.chips, self.seed, self.device = cell.chips, seed, device
        self.args = program_args(self.config, seed, device)
        weights = seeded_state_dict(plain.model(self.config).state_dict(),
                                    traffic.sub_seed(seed, 0), device)
        with torch.device(device):
            model = build_model(self.args)
        model.load_state_dict(weights, strict=True)
        del weights
        self.state = create_train_state(model, self.args, self.config["steps_per_epoch"])
        self.step = self._make_step()
        self.pool = traffic.train_pool(self.traffic, plain.has_cues(self.config), seed, device)
        self.batch = self.traffic["batch"]
        self.checked = self.traffic["checked_steps"]
        self.losses, self.first, self.change = self._checked_steps()
        self.next = self.checked

    def _make_step(self, spans=False):
        from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
        from mde_tpu_torch.train import make_train_step
        embedders = [SemanticsEmbedder(self.args, self.device),
                     InstanceEmbedder(self.args, self.device)]
        if spans:
            embedders = [tracing.spanned(e, "cues") for e in embedders]
        return make_train_step(self.args, *embedders)

    def _checked_steps(self):
        opt = self.state.optimizer
        start = [p.detach().clone() for p in opt.params]
        losses, first = [], None
        for k in range(self.checked):
            self.state, m = self.step(self.state, self.pool[k])
            losses.append(m["loss"].item())
            if k == 0:
                first = plain.leaf_norms({
                    name: opt.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    / (1.0 - opt.beta1(0)) for name, p in zip(opt.names, opt.params)})
        change = plain.leaf_norms({name: p.detach() - s
                                   for name, p, s in zip(opt.names, opt.params, start)})
        return losses, first, change

    def _steps(self, step, until=None, count=None):
        """Steps on the pool in turn, until `until` seconds have passed or
        `count` steps ran; returns the number run."""
        n, t0 = 0, time.perf_counter()
        while True:
            self.state, _ = step(self.state, self.pool[self.next % len(self.pool)])
            self.next += 1
            n += 1
            if (count is not None and n >= count) or (
                    until is not None and time.perf_counter() - t0 >= until):
                return n

    def window(self, seconds):
        sync(self.device)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        steps = self._steps(self.step, until=seconds)
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.window_peak = (torch.cuda.max_memory_allocated() if self.device == "cuda" else 0)
        images = steps * self.batch * self.chips
        return {"attempted": images, "failed": 0, "steps": steps, "seconds": elapsed,
                "metrics": {"train_img_per_s": images / elapsed}}

    def traced_window(self):
        model = self.state.model
        tracing.wrap_forward(model, "model.forward")
        for name in CUE_MODULES:
            if hasattr(model, name):
                tracing.wrap_forward(getattr(model, name), "cues")
        opt = self.state.optimizer
        opt.step = tracing.spanned(opt.step, "optimizer.step")
        step = self._make_step(spans=True)
        first = self.next
        count = self.traffic["trace_steps"]
        _, tr = tracing.traced(lambda: self._steps(step, count=count), SPANS, self.device)
        batches = [self.pool[k % len(self.pool)] for k in range(first, first + count)]
        t, c = self.traffic, self.config
        cue_shapes = None
        if plain.has_cues(c):
            cue_shapes = {"semantics": (t["batch"], 25, t["height"], t["width"]),
                          "instance_labels": (t["batch"], 25, t["height"], t["width"]),
                          "instance_areas": (t["batch"], 4, t["height"], t["width"])}
        flops = work.train_flops(plain.model(c).eval(), (t["batch"], 3, t["height"], t["width"]),
                                 cue_shapes)
        return {"kind": "train", "trace": tr, "steps": count, "chips": self.chips,
                "bf16": self.args.compute_dtype == "bfloat16",
                "flops_per_image": flops / t["batch"],
                "head_pixels": t["batch"] * (t["height"] // 2) * (t["width"] // 2),
                "n_bins": c["n_bins"], "depth_pixels": t["batch"] * t["height"] * t["width"],
                "valid_pixels": [int((b["depth"] >= 1e-3).sum()) for b in batches],
                "images": t["batch"], "window_peak_bytes": self.window_peak}

    def release(self):
        del self.state, self.step
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        weights = seeded_state_dict(plain.model(self.config).state_dict(),
                                    traffic.sub_seed(self.seed, 0), self.device)
        reference = plain.train_steps(self.config, weights, self.pool[:self.checked],
                                      self.seed, self.device)
        compared, look = compare.train_gaps((self.losses, self.first, self.change), reference)
        print(f"look (not compared): {json.dumps(look)}", file=sys.stderr)
        return compared


def setup(cell, seed, device):
    return Session(cell, seed, device)
