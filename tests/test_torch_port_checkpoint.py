"""Port parity, checkpoints across the two packages (CPU, float32):
`--pretrained_backbone` files and orbax checkpoints of mde_tpu read by the
port.

* Backbone files: an .npz written by `mde_tpu.checkpoint.save_backbone_npz`
  from a seeded B1 encoder (3 input channels) goes into port models through
  `train/driver.py::apply_pretrained_backbone`, and the result equals what
  `mde_tpu.train.driver._apply_pretrained_backbone` makes of the same model
  (whose encoder tree comes from JAX's `convert_backbone_statedict` of the
  port's weights): exactly, for a plain model (everything from the file), a
  stem widened to 73 channels by input cues (the file's RGB slice, the cue
  slice untouched) and `--image none` (the stem stays random, the rest and
  the BN stats from the file). The port's own `save_backbone_npz` /
  `load_backbone_npz` / `backbone_trees` equal JAX's.
* Orbax: a TrainState of B1 AdaBins (16 bins) with the reference optimizer
  chain, its AdamW moments and counts set as after three updates (seeded
  values; compiling an optax update of this tree costs ~15 s here), saved
  by `mde_tpu.checkpoint.save_checkpoint`, goes through `orbax_to_pt.py`.
  The port model reading the `.pt` gives JAX's depth on a 320x416 frame
  (rtol 1e-4, atol 1e-4 m); the port's optimizer restored from it (through
  `load_checkpoint`, as `--resume PATH` restores) holds optax's moments and
  count in every parameter; the file carries the epoch and the step. That
  the port's AdamW continues from such a state as optax does is
  `tests/test_torch_port_train.py::test_adamw_clip_updates_match_optax`.
  The same directory restored without its AdamW state, or without its
  `batch_stats`, is refused, naming the directory and the keys found.
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CUES_A = dict(use_semantics="glove-25d", use_instance_segmentation="ade20k_swin_human_sizes",
              insertion_point="input")
REPO_PARAMS = "params/args_train_nyu_efficientnet-b1.txt"


def _args(**kw):
    base = dict(n_bins=16, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", use_fused_head=True, pretrained_backbone=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _tree_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.fixture(scope="module")
def backbone_file(tmp_path_factory):
    """An .npz written by mde_tpu from a seeded plain B1 encoder."""
    from mde_tpu.checkpoint import convert_backbone_statedict, save_backbone_npz
    from mde_tpu_torch.models.efficientnet import EfficientNetEncoder

    torch.manual_seed(1)
    encoder = EfficientNetEncoder("efficientnet-b1")
    for name, buf in encoder.named_buffers():  # stats unlike the defaults
        if "running_" in name:
            buf.uniform_(0.5, 1.5)
    params, stats = convert_backbone_statedict(encoder.state_dict(), "efficientnet-b1")
    path = str(tmp_path_factory.mktemp("backbone") / "b1.npz")
    save_backbone_npz(params, stats, path)
    return path, encoder.state_dict()


CONFIGS = {"rgb": {}, "cues_at_input": CUES_A, "image_none": dict(CUES_A, image="none")}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_pretrained_backbone_matches_jax(backbone_file, config):
    import jax.numpy as jnp
    import optax

    from mde_tpu.checkpoint import convert_backbone_statedict
    from mde_tpu.train.driver import _apply_pretrained_backbone
    from mde_tpu.train.state import TrainState as JaxTrainState
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train.driver import apply_pretrained_backbone

    path, file_sd = backbone_file
    args = _args(pretrained_backbone=path, **CONFIGS[config])
    torch.manual_seed(2)
    model = build_model(args)
    before = {k: v.clone() for k, v in model.encoder.original_model.state_dict().items()}
    params, stats = convert_backbone_statedict(before, "efficientnet-b1")
    state = JaxTrainState.create(apply_fn=None, params={"encoder": params},
                                 batch_stats={"encoder": stats}, tx=optax.identity())
    want = _apply_pretrained_backbone(state, args, jnp.float32)

    apply_pretrained_backbone(model, args)
    after = model.encoder.original_model.state_dict()
    got_params, got_stats = convert_backbone_statedict(after, "efficientnet-b1")
    _tree_equal(got_params, want.params["encoder"])
    _tree_equal(got_stats, want.batch_stats["encoder"])

    stem, pretrained = after["conv_stem.weight"], file_sd["conv_stem.weight"]
    if config == "image_none":
        assert stem.shape[1] == 70 and torch.equal(stem, before["conv_stem.weight"])
    else:
        assert stem.shape[1] == (73 if config == "cues_at_input" else 3)
        assert torch.equal(stem[:, :3], pretrained)
        assert torch.equal(stem[:, 3:], before["conv_stem.weight"][:, 3:])
    for k, v in file_sd.items():
        if k != "conv_stem.weight" and "num_batches" not in k:
            assert torch.equal(after[k], v), k


def test_backbone_npz_round_trips_as_jax(backbone_file, tmp_path):
    from mde_tpu.checkpoint import convert_backbone_statedict, load_backbone_npz as jax_load
    from mde_tpu_torch.checkpoint import (backbone_state_dict, backbone_trees,
                                          load_backbone_npz, save_backbone_npz)

    path, file_sd = backbone_file
    params, stats = load_backbone_npz(path)
    want_params, want_stats = jax_load(path)
    _tree_equal(params, want_params)
    _tree_equal(stats, want_stats)
    trees = backbone_trees({f"encoder.original_model.{k}": v for k, v in file_sd.items()},
                           "efficientnet-b1")
    jax_trees = convert_backbone_statedict(file_sd, "efficientnet-b1")
    _tree_equal(trees[0], jax_trees[0])
    _tree_equal(trees[1], jax_trees[1])
    sd = backbone_state_dict(params, stats, "efficientnet-b1")
    assert sd.keys() == file_sd.keys()
    for k, v in file_sd.items():
        if "num_batches" not in k:
            assert torch.equal(sd[k], v), k
    save_backbone_npz(*trees, str(tmp_path / "again.npz"))
    with np.load(path) as a, np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def orbax_run(tmp_path_factory):
    """A JAX TrainState with seeded AdamW moments, saved with orbax and
    converted by orbax_to_pt.py; JAX's depth on a frame."""
    import jax
    import jax.numpy as jnp

    import orbax_to_pt
    from mde_tpu.checkpoint import save_checkpoint
    from mde_tpu.config import TrainArgParser as JaxTrainArgParser, parse_cli as jax_parse_cli
    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu.train.state import TrainState as JaxTrainState
    from mde_tpu.train.optim import build_optimizer
    from test_torch_port_models import seeded_variables

    root = tmp_path_factory.mktemp("orbax")
    argv = [REPO_PARAMS, "--n_bins", "16", "--epochs", "3"]
    args = jax_parse_cli(JaxTrainArgParser(), argv, mode="train")
    model = jax_build_model(args, dtype=jnp.float32)
    params, stats = seeded_variables(model, [(1, 320, 416, 3)], seed=4)
    tx, _ = build_optimizer(params, args, steps_per_epoch=10)
    # jitted: an eager optax init compiles once per leaf shape
    state = jax.jit(lambda p, s: JaxTrainState.create(
        apply_fn=model.apply, params=p, tx=tx, batch_stats=s))(params, stats)
    # moments and counts as three updates would leave them, drawn from a seed
    rng = np.random.default_rng(5)
    inject = state.opt_state[1]
    adam = inject.inner_state[0]
    adam = adam._replace(
        count=jnp.asarray(3, adam.count.dtype),
        mu=jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape, np.float32), params),
        nu=jax.tree_util.tree_map(lambda p: rng.random(p.shape, np.float32), params))
    inject = inject._replace(count=jnp.asarray(3, inject.count.dtype),
                             inner_state=(adam, *inject.inner_state[1:]))
    state = state.replace(step=3, opt_state=(state.opt_state[0], inject))
    save_checkpoint(state, 2, "ckpt", root=str(root))

    image = rng.standard_normal((1, 320, 416, 3)).astype(np.float32)
    _, depth = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x,
                                                   train=False))(params, stats, image)
    out = str(root / "latest.pt")
    orbax_to_pt.main(argv + ["--orbax_dir", str(root / "ckpt"), "--out", out])
    return dict(path=out, dir=str(root / "ckpt"), image=image, depth=np.asarray(depth),
                mu=jax.tree_util.tree_map(np.asarray, adam.mu),
                nu=jax.tree_util.tree_map(np.asarray, adam.nu), count=int(adam.count),
                stats=stats, argv=argv)


def _port_state(orbax_run):
    from mde_tpu_torch.checkpoint import load_checkpoint
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state

    args = parse_cli(TrainArgParser(), orbax_run["argv"] + ["--device", "cpu"], mode="train")
    state = create_train_state(build_model(args), args, steps_per_epoch=10)
    state, epoch = load_checkpoint(orbax_run["path"], state)
    return state, epoch


def test_orbax_checkpoint_gives_jax_depth_on_the_port(orbax_run):
    from mde_tpu_torch.checkpoint import load_reference_checkpoint
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.models import build_model

    args = parse_cli(TrainArgParser(), orbax_run["argv"] + ["--device", "cpu"], mode="train")
    model = load_reference_checkpoint(build_model(args), orbax_run["path"]).eval()
    with torch.no_grad():
        _, depth = model(torch.from_numpy(orbax_run["image"].transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(depth.numpy().transpose(0, 2, 3, 1), orbax_run["depth"],
                               rtol=1e-4, atol=1e-4)


def test_orbax_checkpoint_carries_adam_state_and_step(orbax_run):
    from mde_tpu_torch.checkpoint import state_dict_from_flax

    state, epoch = _port_state(orbax_run)
    assert epoch == 2 and state.step == 3
    opt = state.optimizer.optimizer
    mu = state_dict_from_flax(orbax_run["mu"], orbax_run["stats"])
    nu = state_dict_from_flax(orbax_run["nu"], orbax_run["stats"])
    names = {id(p): k for k, p in state.model.named_parameters()}
    seen = 0
    for group in opt.param_groups:
        for p in group["params"]:
            s = opt.state[p]
            assert float(s["step"]) == orbax_run["count"] == 3
            assert torch.equal(s["exp_avg"], mu[names[id(p)]])
            assert torch.equal(s["exp_avg_sq"], nu[names[id(p)]])
            seen += 1
    assert seen == len(names)
    # conv_out's kernel, read straight from the optax tree: HWIO -> OIHW
    conv_out = state.model.conv_out[0].weight
    np.testing.assert_array_equal(opt.state[conv_out]["exp_avg"].numpy(),
                                  orbax_run["mu"]["conv_out"]["kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("drop", ["adam", "batch_stats"])
def test_orbax_checkpoint_without_adam_state_or_stats_is_refused(orbax_run, drop, tmp_path):
    """orbax_to_pt.py writes no `.pt` from a restored state that lacks the
    AdamW moments and count (optax's `ScaleByAdamState`) or the BN stats."""
    import orbax_to_pt
    from mde_tpu.checkpoint import load_checkpoint

    restored, epoch = load_checkpoint(orbax_run["dir"])
    if drop == "adam":  # the clip's state and the injected hyperparameters only
        restored["opt_state"] = [restored["opt_state"][0],
                                 {"hyperparams": restored["opt_state"][1]["hyperparams"]}]
    else:
        del restored["batch_stats"]
    mp = pytest.MonkeyPatch()
    mp.setattr(orbax_to_pt, "load_checkpoint", lambda path: (restored, epoch))
    out = tmp_path / "refused.pt"
    try:
        with pytest.raises(ValueError) as refusal:
            orbax_to_pt.main(orbax_run["argv"] + ["--orbax_dir", orbax_run["dir"],
                                                  "--out", str(out)])
    finally:
        mp.undo()
    message = str(refusal.value)
    assert orbax_run["dir"] in message and "hyperparams" in message
    assert ("AdamW" in message) == (drop == "adam")
    assert ("batch_stats" in message.split("(")[0]) == (drop == "batch_stats")
    assert not out.exists()
