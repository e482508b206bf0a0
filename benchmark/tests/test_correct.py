"""What decides `correct`, driven on the CPU at a small size: the harness's
look for a card skipped, the rest of a run as it is, in float32 so that a
sound run reads far inside the limits. A sound run comes out correct; the
timed path broken underneath (a step that returns its state unchanged, half
of each batch left out) comes out not correct; the plain reference agrees with the port and runs each step
on the weights the last one made; and the control, the reference in the
precision below the configuration's, fails the limits.

    python -m pytest benchmark/tests/test_correct.py -q   (~4 minutes)
"""

import time

import pytest
import torch

from benchmark.harness import cells, compare, runner, traffic
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference import adabins as ref
from benchmark.reference import plain

TRAIN = "adabins-b1-nyu.train-bs16"
CUES = "adabins-b1-cues-a-nyu.train-bs16"
# 320x416 is the least multiple of 32 in NYU's aspect with the mViT's 129 tokens
SMALL_TRAIN = dict(batch=2, height=320, width=416, trace_steps=1)
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


def run_train(workload=TRAIN, trace=False):
    config = cells.resolve(workload).config
    return runner.run(workload, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                      traffic_overrides=SMALL_TRAIN,
                      config_overrides={"overrides": config["overrides"]
                                        + ["--compute_dtype", "float32"],
                                        "compute_dtype": "float32"})


def test_a_sound_training_run_is_correct_and_reports_its_metrics():
    out = run_train(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"grad_gap_3rd", "median_change_gap"}
    assert list(out)[-1] == "checks"
    assert "mfu_pct.train" in out["metrics"] and "setup_s" not in out["metrics"]


def test_a_sound_run_of_the_cue_configuration_is_correct():
    out = run_train(CUES)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}


def test_a_cue_mlp_whose_gradient_is_lost_is_not_correct(monkeypatch):
    # the human-size CueMLP's four leaves, the cue layer's largest gradients
    from mde_tpu_torch import models
    build = models.build_model

    def losing(args):
        model = build(args)
        for p in model.instance_absolute_sizes_fc.parameters():
            p.register_hook(torch.zeros_like)
        return model

    monkeypatch.setattr(models, "build_model", losing)
    out = run_train(CUES)
    assert not out["correct"]
    assert out["checks"]["grad_gap_3rd"]["value"] > out["checks"]["grad_gap_3rd"]["limit"]


def test_a_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from mde_tpu_torch.train import optim
    monkeypatch.setattr(optim.OneCycleAdamW, "step", lambda self, step: torch.zeros(()))
    out = run_train()
    assert not out["correct"]
    assert out["checks"]["median_change_gap"]["value"] > 0.9


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from mde_tpu_torch.train import loop
    make = loop.make_loss_fn

    def halved(*args, **kwargs):
        loss_fn = make(*args, **kwargs)
        return lambda model, batch, gen=None: loss_fn(
            model, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, gen)

    monkeypatch.setattr(loop, "make_loss_fn", halved)
    assert not run_train()["correct"]


def test_the_control_fails_the_limits_of_each_cell():
    for workload in (TRAIN, CUES):
        cell = cells.resolve(workload)
        cell.traffic = dict(cell.traffic, **SMALL_TRAIN)
        weights = seeded_state_dict(plain.model(cell.config).state_dict(),
                                    traffic.sub_seed(SEED, 0), "cpu")
        pool = traffic.train_pool(cell.traffic, plain.has_cues(cell.config), SEED, "cpu")[:3]
        reference = plain.train_steps(cell.config, weights, pool, SEED, "cpu")
        low = plain.train_steps(cell.config, weights, pool, SEED, "cpu",
                                lower=cell.limits["control"])
        readings, _ = compare.train_gaps(low, reference)
        assert any(v > cell.limits[k] for k, v in readings.items() if k in cell.limits), (
            workload, readings)


def test_each_reference_step_runs_on_the_weights_the_last_one_made(monkeypatch):
    # autocast keeps its casts of the parameters while a region lasts: one
    # region over every step would run the later steps on the first's weights
    cell = cells.resolve(TRAIN)
    assert cell.config["compute_dtype"] == "bfloat16"
    t = dict(cell.traffic, **SMALL_TRAIN)
    pool = traffic.train_pool(t, False, SEED, "cpu")[:2]
    weights = seeded_state_dict(plain.model(cell.config).state_dict(),
                                traffic.sub_seed(SEED, 0), "cpu")
    after = []
    step = ref.AdamW.step

    def recording(self, grads, lr, beta1):
        step(self, grads, lr, beta1)
        if self.t == 1:
            after.extend(p.detach().clone() for p in self.params)

    monkeypatch.setattr(ref.AdamW, "step", recording)
    losses, _, _ = plain.train_steps(cell.config, weights, pool, SEED, "cpu")
    net = plain.model(cell.config, "cpu")
    net.load_state_dict(weights, strict=True)
    net.train()
    with torch.no_grad():
        for p, moved in zip(net.parameters(), after, strict=True):
            p.copy_(moved)
    gen = torch.Generator().manual_seed(ref.dropout_seed(SEED, 1))
    depth = pool[1]["depth"]
    with torch.no_grad(), plain.precision(None), plain.autocast(cell.config, None, "cpu"):
        edges, pred = net(pool[1]["image"], None, gen)
        loss = (ref.silog(pred.float(), depth, cell.config["min_depth"])
                + cell.config["w_chamfer"] * ref.chamfer(edges.float(), depth))
    assert loss.item() == pytest.approx(losses[1], rel=1e-6)


def test_the_reference_follows_the_port_step_by_step_in_float32():
    from mde_tpu_torch.config.parsers import TrainArgParser, parse_cli
    from mde_tpu_torch.models import build_model
    config = cells.resolve(TRAIN).config
    args = parse_cli(TrainArgParser(), [config["params_file"], "--device", "cpu"])
    weights = seeded_state_dict(plain.model(config).state_dict(), 3, "cpu")
    port = build_model(args)
    port.load_state_dict(weights, strict=True)
    ref = plain.model(config, "cpu")
    ref.load_state_dict(weights, strict=True)
    image = torch.randn((1, 3, 320, 416), generator=torch.Generator().manual_seed(1))
    for mode in ("eval", "train"):
        port.train(mode == "train")
        ref.train(mode == "train")
        with torch.no_grad():
            a = port(image, generator=torch.Generator().manual_seed(2))
            b = ref(image, None, torch.Generator().manual_seed(2))
        torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a[1], b[1], rtol=1e-3, atol=2e-3)
