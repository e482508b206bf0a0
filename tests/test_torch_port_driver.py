"""Port parity, the training entry point: mde_tpu_torch.train.main_train and
`python -m mde_tpu_torch.train` on a tiny NYU-format tree on the CPU, and
the port's checkpoint read by mde_tpu's converter.

The run is the flagship params file with overrides: B1 AdaBins with 8 bins,
float32, batch 1 of 320x416 crops (the smallest NYU-shaped input with the
129 mViT tokens the head needs), 3 train frames (3 steps an epoch, one
epoch), one eval frame, `--device cpu`.

* In process: `main_train(max_steps=2)` takes 2 steps, validates at step 2
  and writes latest and best. The JSONL holds the tags and steps that
  mde_tpu/train/driver.py:164-215 writes at that cadence: `Epoch`,
  `Train/*` every 5 steps, `Train/QualSamples` every 500, `Test/SILog`,
  `Metrics/*` and `Test/QualSamples` at every validation; each figure line
  names its PNG, which decodes at the size of its panels. TensorBoard is hidden
  from this run (the JSONL is what is read; importing TensorFlow would cost
  more than the run).
* The CLI in a subprocess resumes from that latest checkpoint into a fresh
  experiment directory: it continues at epoch 0, batch 2, update 2, takes
  the epoch's last step, validates, and writes latest and best. Its
  checkpoint holds step 3 and the OneCycle learning rate of update 2. The
  subprocess sees no TensorFlow, as on the card's machine, and mirrors its
  scalars to a TensorBoard event file.
* Checkpoint: `mde_tpu.checkpoint.convert_reference_checkpoint` reads the
  port's latest checkpoint as an AdaBins .pt file; the JAX model on those
  weights gives the port's depth to rtol 1e-4 (atol 1e-4 m).
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.checkpoint import convert_reference_checkpoint
from mde_tpu.models import build_model as jax_build_model
from mde_tpu.ops.metrics import METRIC_NAMES
from mde_tpu_torch.config import TrainArgParser, parse_cli
from mde_tpu_torch.data import DepthDataLoader
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train import main_train, onecycle_lr_schedule

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = "params/args_train_nyu_efficientnet-b1.txt"
HW = (320, 416)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nyu_driver")
    scene = root / "office_0001"
    scene.mkdir()
    rng = np.random.default_rng(0)

    def frame(name, hw):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
            scene / f"rgb_{name}.jpg")
        Image.fromarray(rng.integers(400, 9000, hw).astype(np.uint16)).save(
            scene / f"sync_depth_{name}.png")
        return f"/office_0001/rgb_{name}.jpg /office_0001/sync_depth_{name}.png 518.8579"

    (root / "train.txt").write_text("\n".join(frame(i, (480, 640)) for i in range(3)) + "\n")
    (root / "eval.txt").write_text(frame("eval", HW) + "\n")
    return root


def _argv(tree, runs, *extra):
    return [PARAMS, "--bs", "1", "--epochs", "1", "--validate_every", "2",
            "--input_height", str(HW[0]), "--input_width", str(HW[1]), "--n_bins", "8",
            "--compute_dtype", "float32", "--device", "cpu", "--workers", "2",
            "--root", str(runs), "--data_path", str(tree), "--gt_path", str(tree),
            "--filenames_file", str(tree / "train.txt"), "--data_path_eval", str(tree),
            "--gt_path_eval", str(tree), "--filenames_file_eval", str(tree / "eval.txt"),
            *extra]


def _events(exp_dir):
    with open(os.path.join(exp_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _checkpoints(exp_dir, kind):
    return [os.path.join(exp_dir, f) for f in os.listdir(exp_dir) if f.endswith(f"_{kind}.pt")]


def jax_cadence(first_step, max_steps, steps_per_epoch, validate_every):
    """(tag, step) of every scalar and figure mde_tpu/train/driver.py writes
    from `first_step` to `max_steps` (its epoch loop :214-239 and `bookkeep`
    :164-212)."""
    out, step = [("Epoch", first_step)], first_step
    while True:
        if step % 5 == 0:
            out += [("Train/Loss", step), ("Train/SILog", step), ("Train/ChamferLoss", step)]
        if step % 500 == 0:
            out.append(("Train/QualSamples", step))
        step += 1
        if step % validate_every == 0 or step >= max_steps:
            out += ([("Test/SILog", step)] + [(f"Metrics/{k}", step) for k in METRIC_NAMES]
                    + [("Test/QualSamples", step)])
        if step >= max_steps:
            return out
        if step % steps_per_epoch == 0:
            out.append(("Epoch", step))


@pytest.fixture(scope="module")
def first_run(tree, tmp_path_factory):
    runs = tmp_path_factory.mktemp("runs")
    args = parse_cli(TrainArgParser(), _argv(tree, runs))
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        state = main_train(args, max_steps=2, interactive=False)
    finally:
        mp.undo()
    return args, state


def _check_figures(events, exp_dir, crop_hw=HW):
    """Each figure line names `{tag with / as _}_{step}.png` in the
    experiment directory: one row of RGB, GT and prediction (batch 1 of the
    2-row grid) in cells of the crop's size with 8-pixel gutters, the
    prediction at the model's half resolution on white."""
    from mde_tpu_torch.data import read_png
    figures = [e for e in events if "figure" in e]
    assert figures
    for e in figures:
        assert e["figure"] == os.path.join(exp_dir, f"{e['tag'].replace('/', '_')}_{e['step']}.png")
        png = read_png(e["figure"])
        h, w = crop_hw
        assert png.shape == (2 * h + 8, 3 * w + 16, 3) and png.dtype == np.uint8
        pred = png[:h, 2 * (w + 8):]
        assert (pred[h // 2:] == 255).all() and (pred[:, w // 2:] == 255).all()
        assert (png[h:] == 255).all()  # the second row: no second sample


def test_main_train_writes_the_jax_cadence(first_run):
    args, state = first_run
    assert state.step == 2
    events = _events(args.exp_dir)
    assert [(e["tag"], e["step"]) for e in events] == jax_cadence(0, 2, 3, 2)
    assert all(np.isfinite(e["value"]) for e in events if "value" in e)
    assert [e["value"] for e in events if e["tag"] == "Epoch"] == [0]
    _check_figures(events, args.exp_dir)


def test_figure_forward_changes_nothing_of_training(first_run):
    """The driver's figure forward on a trained state: eval mode and the
    training's compute dtype (bf16 convolutions at bfloat16), the model back
    in train mode after it; parameters, BN buffers, the AdamW state and
    torch's generator (from which nothing may be drawn) bit-equal."""
    from copy import deepcopy

    from mde_tpu_torch.data import DevicePrefetcher
    from mde_tpu_torch.train.driver import make_figure_forward

    args, state = first_run
    loader = DepthDataLoader(args, "train")
    loader.set_epoch(0)
    batch = next(iter(DevicePrefetcher(loader, "cpu")))
    model = state.model.train()
    before = (deepcopy(model.state_dict()), deepcopy(state.optimizer.optimizer.state_dict()),
              torch.get_rng_state())
    modes, dtypes = [], []
    hooks = [model.register_forward_hook(lambda m, i, out: modes.append(m.training)),
             model.encoder.original_model.conv_stem.register_forward_hook(
                 lambda m, i, out: dtypes.append(out.dtype))]
    try:
        for dtype in ("float32", "bfloat16"):
            fig_args = types.SimpleNamespace(**{**vars(args), "compute_dtype": dtype})
            pred = make_figure_forward(fig_args)(model, batch)
            assert pred.shape == (1, 1, HW[0] // 2, HW[1] // 2) and pred.dtype == torch.float32
    finally:
        for h in hooks:
            h.remove()
    assert modes == [False, False] and model.training
    assert dtypes == [torch.float32, torch.bfloat16]
    for k, v in before[0].items():
        assert torch.equal(model.state_dict()[k], v), k
    after = state.optimizer.optimizer.state_dict()
    assert after["param_groups"] == before[1]["param_groups"]
    for i, slots in before[1]["state"].items():
        for k, v in slots.items():
            assert torch.equal(after["state"][i][k], v), (i, k)
    assert torch.equal(torch.get_rng_state(), before[2])


def test_main_train_writes_latest_and_best(first_run):
    args, _ = first_run
    (latest,), (best,) = _checkpoints(args.exp_dir, "latest"), _checkpoints(args.exp_dir, "best")
    ckpt = torch.load(latest, weights_only=True)
    assert sorted(ckpt) == ["epoch", "model", "optimizer", "step"]
    assert (ckpt["epoch"], ckpt["step"]) == (0, 2)
    assert os.path.basename(latest).startswith("nyu_efficientnet-b1_")
    assert torch.load(best, weights_only=True)["step"] == 2


def test_cli_resumes_validates_and_writes_checkpoints(first_run, tree, tmp_path):
    """`python -m mde_tpu_torch.train` with --resume PATH into a fresh
    experiment directory: the epoch's last step (update 2), a validation,
    latest and best."""
    args, _ = first_run
    (latest,) = _checkpoints(args.exp_dir, "latest")
    no_tf = tmp_path / "no_tensorflow"
    (no_tf / "tensorflow").mkdir(parents=True)
    (no_tf / "tensorflow" / "__init__.py").write_text("raise ImportError('no tensorflow')\n")
    # two threads, as this file's own torch: the test workers share the cores
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(no_tf), REPO]),
               OMP_NUM_THREADS="2")
    argv = _argv(tree, tmp_path / "runs", "--name", "resumed", "--validate_every", "3",
                 "--resume", latest)
    proc = subprocess.run([sys.executable, "-m", "mde_tpu_torch.train", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"resumed from {latest} at step 2" in proc.stdout

    exp_dir = tmp_path / "runs" / "resumed"
    events = _events(exp_dir)
    assert [(e["tag"], e["step"]) for e in events] == jax_cadence(2, 3, 3, 3)
    assert events[0]["value"] == 0  # the saved epoch, continued
    _check_figures(events, str(exp_dir))
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(exp_dir))
    (new_latest,), (best,) = _checkpoints(exp_dir, "latest"), _checkpoints(exp_dir, "best")
    ckpt = torch.load(new_latest, weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (0, 3)
    lr = onecycle_lr_schedule(args.lr, 3, div_factor=args.div_factor,
                              final_div_factor=args.final_div_factor)(2)
    assert all(g["lr"] == lr for g in ckpt["optimizer"]["param_groups"])
    assert ckpt["optimizer"]["state"][0]["step"].item() == 3  # AdamW's own count


def test_resumed_epoch_starts_at_its_batch(tree):
    """set_epoch(epoch, first_batch) skips the batches a resumed run took:
    the rest equal a whole epoch's tail."""
    args = types.SimpleNamespace(**vars(parse_cli(TrainArgParser(), _argv(tree, tree))),
                                 no_native_aug=True)
    args.batch_size, args.num_threads = 1, 2
    loader = DepthDataLoader(args, "train")
    loader.set_epoch(1)
    whole = list(loader)
    loader.set_epoch(1, first_batch=2)
    tail = list(loader)
    assert len(whole) == 3 and len(tail) == 1
    np.testing.assert_array_equal(tail[0]["image"], whole[2]["image"])


def test_checkpoint_converts_to_the_jax_model(first_run):
    """The port's checkpoint through convert_reference_checkpoint: the JAX
    model's depth on those weights equals the port model's."""
    args, _ = first_run
    (latest,) = _checkpoints(args.exp_dir, "latest")
    params, stats = convert_reference_checkpoint(latest, args.encoder_name)
    image = np.random.default_rng(1).standard_normal((1, *HW, 3)).astype(np.float32)

    model = build_model(args)
    model.load_state_dict(torch.load(latest, weights_only=True)["model"], strict=True)
    with torch.no_grad():
        _, got = model.eval()(torch.from_numpy(image.transpose(0, 3, 1, 2).copy()))
    jax_model = jax_build_model(args, dtype=jnp.float32)
    _, want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(image))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_resume_of_a_missing_checkpoint_raises(tree, tmp_path):
    """An explicit --resume path that does not exist is an error, not a run
    from scratch (`--resume latest` before any checkpoint starts afresh)."""
    args = parse_cli(TrainArgParser(), _argv(tree, tmp_path, "--resume",
                                             str(tmp_path / "missing.pt")))
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        main_train(args, max_steps=1, interactive=False)



def test_torchrun_trains_on_two_gloo_ranks(tree, tmp_path):
    """`torchrun --nproc_per_node 2 -m mde_tpu_torch.train ... --distributed`
    on the CPU (gloo; B1 noAdaBins, 64x96 crops, one thread a rank), global
    batch 2 (one image a rank), one epoch of the
    3-frame split (one step a rank: the split is cut to a multiple of the
    ranks), validation every step: rank 0 alone writes one latest and one
    best checkpoint, named by its run id, and the JSONL at the JAX driver's
    cadence; its logged metrics are those of one process validating the
    saved weights."""
    import socket

    from mde_tpu_torch.data import DevicePrefetcher
    from mde_tpu_torch.train import make_eval_step, validate

    no_tf = tmp_path / "no_tensorflow"
    (no_tf / "tensorflow").mkdir(parents=True)
    (no_tf / "tensorflow" / "__init__.py").write_text("raise ImportError('no tensorflow')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(no_tf), REPO]),
               OMP_NUM_THREADS="1")
    # the noAdaBins model on 64x96 crops keeps the two ranks cheap; the
    # AdaBins head under DDP is test_torch_port_ddp.py's
    argv = _argv(tree, tmp_path / "runs", "--distributed", "--bs", "2", "--validate_every", "1",
                 "--encoder_name", "efficientnet-b1-noAdaBins", "--input_height", "64",
                 "--input_width", "96")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                           "2", "--master_addr", "127.0.0.1", "--master_port", str(port),
                           "-m", "mde_tpu_torch.train", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          stdin=subprocess.DEVNULL, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]

    args = parse_cli(TrainArgParser(), argv)
    exp_dir = os.path.join(args.root, args.name)
    (latest,), (best,) = _checkpoints(exp_dir, "latest"), _checkpoints(exp_dir, "best")
    assert latest[:-len("_latest.pt")] == best[:-len("_best.pt")]
    ckpt = torch.load(latest, weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (0, 1)
    events = _events(exp_dir)
    assert [(e["tag"], e["step"]) for e in events] == jax_cadence(0, 1, 1, 1)
    _check_figures(events, exp_dir, (64, 96))

    model = build_model(args)
    model.load_state_dict(ckpt["model"], strict=True)
    metrics, val_si = validate(args, make_eval_step(args), model,
                               DevicePrefetcher(DepthDataLoader(args, "online_eval"), "cpu"))
    # rtol 1e-4: the rank summed its convolutions on one thread, this
    # process on two (the reading is ~1e-5)
    logged = {e["tag"]: e["value"] for e in events if "value" in e}
    np.testing.assert_allclose(logged["Test/SILog"], val_si.get_value(), rtol=1e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(logged[f"Metrics/{k}"], v, rtol=1e-4, err_msg=k)
