"""Port parity, tensor parallelism: `--mesh_shape d,m` on gloo ranks of this
CPU (one thread each) against the port's one-process step and against
mde_tpu's step on a ('data', 'model') mesh with `train_state_sharding`. The
grid's rank map, and the refusal of a world that is not d·m, need no
process group: `test_torch_port_parallel.py`. Ten tests, fewer than
`tests/test_train.py`'s eleven, so that xdist's reorder by count queues
this file after it.

* Layout (no process group, no JAX compile): the port's
  `train_state_sharding` against JAX's, through the converter's name map,
  on B1 AdaBins and B5's conv_head, meshes 1,2 / 2,2 / 4,2 and 1,3, both
  modes. The pinned differences: in_proj's head-aligned rows, the column
  biases, and the attention pair replicated where the heads do not divide
  by m.
* Steps at 64x96, where the mViT has 6 tokens: the JAX model then slices 5
  queries and builds conv_out on them (its `tgt[:, 1:129]`), and the port
  model is built with `n_query_channels=5`, which computes that function;
  16 bins, so both run the plain head. Seeded weights, turned into JAX's
  trees by the inverse of the port's converter (no JAX init is traced).
  - `jax`: float32, dropout off, 1,2 against `mde_tpu`'s `make_train_step`
    on `make_mesh("1,2")` with `train_state_sharding` (loss rtol 2e-4,
    gradients within GRAD_TOL of the largest, BN stats rtol 1e-5 atol 1e-6,
    `test_torch_port_ddp.py`'s tolerances).
  - float64 against one process's float64 step, each to GRAD_TOL_F64 of
    the largest gradient after the step (the clipped gradient, once the
    slices are averaged over their data group), the clip's global norm to
    rtol 1e-12 and the BN buffers to BN_TOL_F64: `drop64` (1,2, dropout on:
    the model ranks draw one process's masks), `mesh22` (2,2 on 4 ranks,
    dropout off, 2 images a data rank), `accum64` (1,2, `--accum_steps 2`),
    `all64` (1,2, tp_mode "all") and `remat64` (1,2, tp_mode "all" under
    `--remat encoder`: the checkpointed blocks gather their weights again in
    the recomputation; in the targeted mode conv_head lies outside them, as
    in JAX). After each, every replicated parameter and buffer is bitwise
    equal on all ranks. The logged loss, SILog and chamfer are float32
    means over the data ranks: rtol METRIC_RTOL_F64.
* `fused`: B1 AdaBins at 320x416 (130 tokens) with 128 bins, float32,
  dropout on, 1,2 against one process: the fused head's entry (its plain
  twin on the CPU) runs whole on each rank with conv_out gathered; loss
  rtol 2e-4, gradients within GRAD_TOL.
* Checkpoints: a one-process checkpoint (weights and AdamW moments) loads
  under 1,2 into equal slices, and the 1,2 state saves the one-process file
  back, tensor for tensor.
* The driver: `main_train --distributed --mesh_shape 1,2` on 2 ranks, 2
  steps and a validation on a tiny NYU tree: equal metrics on the ranks,
  the validation's metrics those of one process on the saved (gathered)
  weights, rtol 1e-5.

Cost: one spawn of five one-thread processes (a world of 4 for 2,2; then
two worlds of 2, one for the small 1,2 steps, one for the driver, the
fused-head step and the checkpoints; one process for the one-process
references) while this process traces and runs JAX's 1,2 step; under xdist
one worker of the run does this and the others read its numbers and files
(`_torch_port_shared.py`). Each world meets in a file store of its own, so
no rank binds a port.
"""

import hashlib
import os
import shutil
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_port_shared import shared

torch.set_num_threads(2)

GRAD_TOL = 2e-2  # float32, of the largest gradient value (test_torch_port_ddp.py)
BN_TOL = (1e-5, 1e-6)  # float32 BN running stats, (rtol, atol) (test_torch_port_ddp.py)
GRAD_TOL_F64, NORM_RTOL_F64, BN_TOL_F64 = 1e-9, 1e-12, (1e-9, 1e-12)
# the logged loss, SILog and chamfer are float32 means of the data ranks' values
METRIC_RTOL_F64 = 1e-6
SMALL_HW, BIG_HW = (64, 96), (320, 416)
SMALL_QUERIES = 5  # the queries of 6 tokens (mde_tpu/models/mvit.py's tgt[:, 1:129])
F64_CASES = ["drop64", "mesh22", "accum64", "all64", "remat64"]
WAIT_S = 600  # the spawned work's limit: past it a collective has hung


def _args(**kw):
    base = dict(n_bins=16, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357,
                wd=0.1, div_factor=25.0, final_div_factor=100.0, same_lr=False,
                encoder_lr_factor=1.0, seed=0, use_fused_head=True,
                use_pallas_chamfer=False, compute_dtype="float32", accum_steps=1,
                remat="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _model(args, queries):
    from mde_tpu_torch.models import UnetAdaptiveBins
    return UnetAdaptiveBins(n_bins=args.n_bins, min_val=args.min_depth, max_val=args.max_depth,
                            encoder_name=args.encoder_name, fused_head=True, remat=args.remat,
                            n_query_channels=queries)


# --- spawned processes ----------------------------------------------------------


def _digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step(case, out_dir, tp=True):
    """One training step of `case` on this process's grid (tensor-parallel
    when `tp`, else the one-process model); writes what the test reads."""
    from mde_tpu_torch import parallel
    from mde_tpu_torch.models.tp import shard_model
    from mde_tpu_torch.train import create_train_state, make_train_step, wrap_ddp
    from float64_convs import depthwise_as_taps

    args = _args(**case["args"])
    model = _model(args, case["queries"])
    model.load_state_dict(case["state_dict"], strict=True)
    if not case["dropout"]:
        for m in model.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
    f64 = case["name"] != "jax" and case["name"] != "fused"
    to_float = torch.Tensor.float
    if f64:  # the `.float()` casts of the model and the losses leave float64 as it is
        model.double()
        torch.Tensor.float = (lambda self, *a, **k: self if self.dtype == torch.float64
                              else to_float(self, *a, **k))
    g = parallel.grid() if tp else parallel.Grid()
    if tp:
        shard_model(model, g, case.get("tp_mode", "targeted"))
    state = create_train_state(model, args, steps_per_epoch=10)
    if tp:
        wrap_ddp(state)
    seen = {}
    real = state.optimizer.step

    def watch(index):
        if case["name"] == "jax":  # before the clip, as JAX's optimizer receives them
            seen["grads"] = {parallel.plain_name(k): p.grad.detach().clone()
                             for k, p in model.named_parameters() if p.grad is not None}
        seen["norm"] = real(index).item()
        if case["name"] != "jax":  # averaged over the data group and clipped
            seen["grads"] = {parallel.plain_name(k): p.grad.detach().clone()
                             for k, p in model.named_parameters()}
        return seen["norm"]

    state.optimizer.step = watch
    n = case["batch"]["image"].shape[0] // g.data
    shard = {k: v[g.data_index * n:(g.data_index + 1) * n] for k, v in case["batch"].items()}
    if f64:
        shard = {k: v.double() for k, v in shard.items()}
    try:
        with depthwise_as_taps():
            state, metrics = make_train_step(args)(state, shard)
    finally:
        torch.Tensor.float = to_float
    layout = getattr(model, "tp_layout", {})
    local = parallel.local_state_dict(model)
    grads = seen["grads"]
    if layout:
        grads = parallel.gather_state_dict(grads, layout)
    out = {"metrics": {k: v.item() for k, v in metrics.items()}, "norm": seen["norm"],
           "replicated": _digest({k: v for k, v in local.items() if k not in layout}),
           "split": sorted(layout)}
    if g.rank == 0:
        out.update(grads=grads, buffers={k: v for k, v in local.items()
                                         if "running_" in k or "num_batches" in k})
    name = f"{case['name']}_{'tp' if tp else 'one'}_{g.rank}.pt"
    torch.save(out, os.path.join(out_dir, name + ".tmp"))
    os.replace(os.path.join(out_dir, name + ".tmp"), os.path.join(out_dir, name))


def _checkpoints(work):
    """Under 1,2: the one-process checkpoint into the sharded state (equal
    slices of weights and moments), then the sharded state saved back."""
    from mde_tpu_torch import parallel
    from mde_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from mde_tpu_torch.models.tp import shard_model
    from mde_tpu_torch.train import create_train_state

    args = _args()
    model = shard_model(_model(args, SMALL_QUERIES))
    state = create_train_state(model, args, steps_per_epoch=10)
    state, epoch = load_checkpoint(os.path.join(work, "one_process.pt"), state)
    want = torch.load(os.path.join(work, "one_process.pt"), weights_only=True)
    layout = model.tp_layout
    sliced = parallel.shard_state_dict(want["model"], layout)
    equal = all(torch.equal(v, sliced[k]) for k, v in parallel.local_state_dict(model).items())
    got = state.optimizer.optimizer.state_dict()["state"]
    for i, name in enumerate(state.optimizer.names):
        for key in ("exp_avg", "exp_avg_sq"):
            w = want["optimizer"]["state"][i][key]
            if name in layout:
                w = parallel.shard_state_dict({name: w}, layout)[name]
            equal = equal and torch.equal(got[i][key], w)
    rank = parallel.grid().rank
    torch.save({"equal": equal, "epoch": epoch, "step": state.step,
                "split": sorted(layout)}, os.path.join(work, f"ckpt_{rank}.pt"))
    save_checkpoint(state, epoch, "tensor_parallel.pt", root=work)


def _driver(argv, work):
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.train import main_train

    sys.modules["torch.utils.tensorboard"] = None  # the JSONL is what is read
    args = parse_cli(TrainArgParser(), argv)
    state = main_train(args, max_steps=2, interactive=False)
    from mde_tpu_torch import parallel
    torch.save({"exp_dir": args.exp_dir, "step": state.step,
                "split": sorted(state.model.tp_layout)},
               os.path.join(work, f"driver_{parallel.grid().rank}.pt"))


def _join(rank, world_size, store, mesh_shape):
    from mde_tpu_torch import parallel
    parallel.init_distributed(rank, world_size, f"file://{store}", "gloo", "cpu", mesh_shape)


def _process(index, stores, cases_file, work):
    """Spawned process `index`: 0-3 run 2,2, then 0 and 1 the small 1,2
    steps, 2 and 3 the driver, the fused-head step and the checkpoints; 4
    the one-process references. Each world meets in its own file store
    (`stores`), so no rank binds a port."""
    from mde_tpu_torch import parallel
    torch.set_num_threads(1)
    cases, references, argv = torch.load(cases_file, mmap=True)
    if index == 4:
        for case in references:
            _step(case, work, tp=False)
        return
    _join(index, 4, stores[0], "2,2")
    try:
        _step(cases["mesh22"], work)
    finally:
        parallel.destroy_distributed()
    pair = index // 2
    _join(index % 2, 2, stores[1 + pair], "1,2")
    try:
        if pair == 0:
            for name in ("jax", "drop64", "accum64", "all64", "remat64"):
                _step(cases[name], work)
        else:
            _driver(argv, work)
            _step(cases["fused"], work)
            _checkpoints(work)
    finally:
        parallel.destroy_distributed()


# --- this process ------------------------------------------------------------------


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _batch(rng, n, hw):
    image = rng.standard_normal((n, *hw, 3)).astype(np.float32)
    depth = (rng.random((n, *hw, 1)) * 9.9 + 0.05).astype(np.float32)
    depth[:, :hw[0] // 8] = 0.0  # not valid
    depth[1 % n, hw[0] // 2:] = 0.0  # the images differ in their valid counts
    return {"image": _nchw(image), "depth": _nchw(depth)}


def _tree(root):
    """A tiny NYU tree (test_torch_port_driver.py's): 3 train frames of
    480x640 and one eval frame of 320x416."""
    from PIL import Image
    scene = root / "office_0001"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)

    def frame(name, hw):
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
            scene / f"rgb_{name}.jpg")
        Image.fromarray(rng.integers(400, 9000, hw).astype(np.uint16)).save(
            scene / f"sync_depth_{name}.png")
        return f"/office_0001/rgb_{name}.jpg /office_0001/sync_depth_{name}.png 518.8579"

    (root / "train.txt").write_text("\n".join(frame(i, (480, 640)) for i in range(3)) + "\n")
    (root / "eval.txt").write_text(frame("eval", BIG_HW) + "\n")
    return ["params/args_train_nyu_efficientnet-b1.txt", "--bs", "1", "--epochs", "1",
            "--validate_every", "2", "--input_height", str(BIG_HW[0]),
            "--input_width", str(BIG_HW[1]), "--n_bins", "8", "--compute_dtype", "float32",
            "--device", "cpu", "--workers", "1", "--root", str(root / "runs"),
            "--data_path", str(root), "--gt_path", str(root),
            "--filenames_file", str(root / "train.txt"), "--data_path_eval", str(root),
            "--gt_path_eval", str(root), "--filenames_file_eval", str(root / "eval.txt"),
            "--distributed", "--mesh_shape", "1,2"]


def _one_process_checkpoint(work):
    """A one-process checkpoint with AdamW moments: one update from seeded
    gradients."""
    from mde_tpu_torch.checkpoint import save_checkpoint
    from mde_tpu_torch.train import create_train_state

    torch.manual_seed(7)
    args = _args()
    state = create_train_state(_model(args, SMALL_QUERIES), args, steps_per_epoch=10)
    for p in state.model.parameters():
        p.grad = torch.randn_like(p)
    state.optimizer.step(0)
    state.step = 1
    save_checkpoint(state, 3, "one_process.pt", root=str(work))


def _jax_step(params, stats, batch):
    """JAX's step on make_mesh("1,2") with train_state_sharding, flax's
    dropout an identity; the gradients kept by an optax transformation that
    updates by zero."""
    import flax
    import jax
    import jax.numpy as jnp
    import optax

    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu.parallel import batch_sharding, make_mesh, train_state_sharding
    from mde_tpu.train.loop import make_train_step as jax_make_train_step
    from mde_tpu.train.state import TrainState as JaxTrainState
    from mde_tpu_torch.checkpoint import state_dict_from_flax

    args = _args()

    def init(p):
        return {"grads": jax.tree_util.tree_map(np.zeros_like, p)}

    def update(updates, state, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"grads": updates}

    mesh = make_mesh("1,2", devices=jax.devices()[:2])
    model = jax_build_model(args, dtype=jnp.float32)
    state = JaxTrainState.create(apply_fn=model.apply, params=params, batch_stats=stats,
                                 tx=optax.GradientTransformation(init, update))
    sharding = train_state_sharding(state, mesh)
    state = jax.device_put(state, sharding)
    arrays = {k: jax.device_put(np.ascontiguousarray(v.numpy().transpose(0, 2, 3, 1)),
                                batch_sharding(mesh)) for k, v in batch.items()}
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    try:
        new_state, metrics = jax_make_train_step(model, args, None, None, mesh)(
            state, arrays, jax.random.PRNGKey(0))
        grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"])
        new_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
        metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        mp_.undo()
    split = [s.spec for s in jax.tree_util.tree_leaves(sharding.params)]
    return dict(metrics=metrics, n_split=sum("model" in tuple(s) for s in split),
                grads=state_dict_from_flax(grads, stats, args.encoder_name),
                state=state_dict_from_flax(params, new_stats, args.encoder_name))


def _compare(result, want, rtol, atol):
    """Largest gradient error of `result` against `want`, of the largest
    gradient value; the BN running stats' largest |got - want| / (atol +
    rtol |want|), at most 1 where they agree as `assert_allclose(rtol,
    atol)` asks."""
    largest = max(v.abs().max().item() for v in want["grads"].values())
    grad = max(((result["grads"][k] - v).abs().max().item() / largest, k)
               for k, v in want["grads"].items())
    bn = max((((result["buffers"][k].double() - v.double()).abs()
               / (atol + rtol * v.double().abs())).max().item(), k)
             for k, v in want["buffers"].items() if "running_" in k)
    return {"grad": grad, "bn": bn}


def _wait(path, procs, deadline):
    """Until `path` exists; raises a failed process's error, or at the
    deadline (a hung collective)."""
    while not os.path.exists(path):
        if time.perf_counter() > deadline or not all(
                p.is_alive() or p.exitcode == 0 for p in procs.processes):
            procs.join(0.1)  # raises the failed process's error
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)


def _seeded(model, seed):
    """Seeded weights (chip_smoke.py's `seeded_state_dict`): lecun-scale
    kernels, small biases, BN running stats mean +-0.1 and var 0.5-1.5."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.long)
        elif name.endswith("running_mean"):
            sd[name] = 0.2 * torch.rand(t.shape, generator=gen) - 0.1
        elif name.endswith("running_var"):
            sd[name] = 0.5 + torch.rand(t.shape, generator=gen)
        elif name.endswith("positional_encodings"):
            sd[name] = torch.rand(t.shape, generator=gen)
        elif t.dim() > 1:
            sd[name] = torch.randn(t.shape, generator=gen) / (t[0].numel() ** 0.5)
        elif name.endswith("weight"):
            sd[name] = 1 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return sd


def _flax_trees(sd):
    """The JAX model's (params, batch_stats) of a port B1 AdaBins state_dict,
    numpy: the inverse of `mde_tpu_torch.checkpoint.state_dict_from_flax`
    (held by the round trip in `jax_variables`), with no JAX init to trace."""
    from mde_tpu_torch.checkpoint import backbone_trees

    def a(name):
        return sd[name].detach().numpy()

    def conv(name):
        p = {"kernel": a(name + ".weight").transpose(2, 3, 1, 0)}
        if name + ".bias" in sd:
            p["bias"] = a(name + ".bias")
        return p

    def dense(name):
        return {"kernel": a(name + ".weight").T, "bias": a(name + ".bias")}

    def norm(name):
        return {"scale": a(name + ".weight"), "bias": a(name + ".bias")}

    def bn(name):
        return norm(name), {"mean": a(name + ".running_mean"), "var": a(name + ".running_var")}

    params, stats = {}, {}
    params["encoder"], stats["encoder"] = backbone_trees(sd, "efficientnet-b1")
    dec, dec_stats = {"conv2": conv("decoder.conv2"), "conv3": conv("decoder.conv3")}, {}
    for i in range(1, 5):
        up, ust = {}, {}
        for ab, conv_i, bn_i in (("a", 0, 1), ("b", 3, 4)):
            up[f"conv_{ab}"] = conv(f"decoder.up{i}._net.{conv_i}")
            up[f"bn_{ab}"], ust[f"bn_{ab}"] = bn(f"decoder.up{i}._net.{bn_i}")
        dec[f"up{i}"], dec_stats[f"up{i}"] = up, ust
    params["decoder"], stats["decoder"] = dec, dec_stats
    root = "adaptive_bins_layer.patch_transformer."
    pt = {"embedding_convPxP": conv(root + "embedding_convPxP"),
          "positional_encodings": a(root + "positional_encodings")}
    for i in range(4):
        layer = f"{root}transformer_encoder.layers.{i}."
        pt[f"layer_{i}"] = {
            "self_attn": {"in_proj": {"kernel": a(layer + "self_attn.in_proj_weight").T,
                                      "bias": a(layer + "self_attn.in_proj_bias")},
                          "out_proj": dense(layer + "self_attn.out_proj")},
            "linear1": dense(layer + "linear1"), "linear2": dense(layer + "linear2"),
            "norm1": norm(layer + "norm1"), "norm2": norm(layer + "norm2")}
    params["adaptive_bins_layer"] = {
        "patch_transformer": pt, "conv3x3": conv("adaptive_bins_layer.conv3x3"),
        **{f"regressor_{i}": dense(f"adaptive_bins_layer.regressor.{j}")
           for i, j in enumerate((0, 2, 4))}}
    params["conv_out"] = conv("conv_out.0")
    return params, stats


def _jax_variables():
    """The step cases' weights: a seeded port B1 AdaBins of 16 bins whose
    conv_out reads 5 queries, and JAX's (params, batch_stats) of it, numpy;
    the JAX trees convert back to the same state_dict."""
    from mde_tpu_torch.checkpoint import state_dict_from_flax
    with torch.device("meta"):
        model = _model(_args(), SMALL_QUERIES)
    sd = _seeded(model, 32)
    params, stats = _flax_trees(sd)
    back = state_dict_from_flax(params, stats, "efficientnet-b1")
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items() if "num_batches" not in k)
    return sd, params, stats


@pytest.fixture(scope="module")
def jax_variables():
    return _jax_variables()


def _runs(work):
    """Every case on its spawned ranks and references, and JAX's step here,
    reduced to the numbers the tests read; each result file is read and
    deleted as soon as it is written, the checkpoint files and the driver's
    run once they are compared and validated, and `work` with them."""
    rng = np.random.default_rng(31)
    small, params, stats = _jax_variables()
    with torch.device("meta"):
        big = _model(_args(n_bins=128), 128)
    big = _seeded(big, 33)
    two, four = _batch(rng, 2, SMALL_HW), _batch(rng, 4, SMALL_HW)
    base = dict(queries=SMALL_QUERIES, state_dict=small, batch=two, dropout=True, args={})
    cases = {
        "jax": dict(base, name="jax", dropout=False),
        "drop64": dict(base, name="drop64"),
        "mesh22": dict(base, name="mesh22", batch=four, dropout=False),
        "accum64": dict(base, name="accum64", args={"accum_steps": 2}),
        "all64": dict(base, name="all64", tp_mode="all"),
        "remat64": dict(base, name="remat64", tp_mode="all", args={"remat": "encoder"}),
        "fused": dict(base, name="fused", queries=128, state_dict=big,
                      batch=_batch(rng, 1, BIG_HW),
                      args={"n_bins": 128, "use_pallas_chamfer": True}),
    }
    references = [cases[k] for k in ("mesh22", "drop64", "accum64", "fused")]
    argv = _tree(work / "nyu")
    _one_process_checkpoint(work)
    cases_file = str(work / "cases.pt")
    torch.save((cases, references, argv), cases_file)
    stores = [str(work / f"store_{name}") for name in ("22", "12_steps", "12_driver")]
    procs = mp.start_processes(_process, args=(stores, cases_file, str(work)),
                               nprocs=5, join=False, start_method="spawn")
    deadline = time.perf_counter() + WAIT_S
    out = {}
    try:
        out["jax_mesh"] = _jax_step(params, stats, two)

        def take(name):
            path = work / name
            _wait(path, procs, deadline)
            result = torch.load(path, weights_only=False)
            path.unlink()
            return result

        refs = {c["name"]: take(f"{c['name']}_one_0.pt") for c in references}
        for name, ranks in (("mesh22", 4), ("jax", 2), ("drop64", 2), ("accum64", 2),
                            ("all64", 2), ("remat64", 2), ("fused", 2)):
            # the fused step's ranks are the driver's (ranks 0 and 1 of that world)
            got = [take(f"{name}_tp_{r}.pt") for r in range(ranks)]
            want = refs.get(name, refs["drop64"]) if name != "jax" else None
            tol = BN_TOL_F64 if name in F64_CASES else BN_TOL
            out[name] = dict(ranks=[{k: v for k, v in g.items()
                                     if k not in ("grads", "buffers")} for g in got],
                             want=None if want is None else {"metrics": want["metrics"],
                                                             "norm": want["norm"]},
                             error=None if want is None else _compare(got[0], want, *tol))
            if name == "jax":
                j = out["jax_mesh"]
                out[name]["error"] = _compare(got[0], {
                    "grads": {k: v for k, v in j["grads"].items() if k in got[0]["grads"]},
                    "buffers": {k: v for k, v in j["state"].items() if "running_" in k}},
                    *BN_TOL)
                out[name]["grad_keys"] = (set(got[0]["grads"]), set(j["grads"]))
        while not procs.join(1.0):
            if time.perf_counter() > deadline:
                raise TimeoutError("the ranks did not end")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
    out["ckpt"] = [torch.load(work / f"ckpt_{r}.pt") for r in range(2)]
    out["ckpt_files"] = _differences(torch.load(work / "one_process.pt", weights_only=True),
                                     torch.load(work / "tensor_parallel.pt", weights_only=True))
    out["driver"] = [torch.load(work / f"driver_{r}.pt") for r in range(2)]
    out["driver_validation"] = _validate_driver_run(out["driver"][0]["exp_dir"], argv)
    shutil.rmtree(work, ignore_errors=True)
    return out


def _differences(one, tp):
    """What the one-process checkpoint file and the 1,2 grid's hold: epoch
    and step, the model's keys, the tensors that differ, the optimizer's
    param groups and the AdamW slots that differ."""
    return dict(
        counts=((one["epoch"], one["step"]), (tp["epoch"], tp["step"])),
        model_keys=(sorted(one["model"]), sorted(tp["model"])),
        model_unequal=[k for k, v in one["model"].items()
                       if k not in tp["model"] or not torch.equal(tp["model"][k], v)],
        param_groups=(one["optimizer"]["param_groups"], tp["optimizer"]["param_groups"]),
        slots_unequal=[(i, k) for i, slots in one["optimizer"]["state"].items()
                       for k, v in slots.items()
                       if not torch.equal(tp["optimizer"]["state"][i][k], v)])


def _validate_driver_run(exp_dir, argv):
    """The driver run's checkpoints, its logged metrics, and one process's
    validation of its latest checkpoint on the same split."""
    import json

    from mde_tpu_torch.checkpoint import load_checkpoint
    from mde_tpu_torch.config import TrainArgParser, parse_cli
    from mde_tpu_torch.data import DepthDataLoader, DevicePrefetcher
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_eval_step, validate

    latest = [f for f in os.listdir(exp_dir) if f.endswith("_latest.pt")]
    args = parse_cli(TrainArgParser(), [a for a in argv if a not in ("--distributed",)])
    state = create_train_state(build_model(args), args, steps_per_epoch=3)
    state, _ = load_checkpoint(os.path.join(exp_dir, latest[0]), state)
    want, _ = validate(args, make_eval_step(args), state.model,
                       DevicePrefetcher(DepthDataLoader(args, "online_eval"), "cpu"))
    with open(os.path.join(exp_dir, "events.jsonl")) as f:
        logged = {e["tag"][len("Metrics/"):]: e["value"] for e in map(json.loads, f)
                  if e["tag"].startswith("Metrics/")}
    return dict(latest=latest, step=state.step, want=want, logged=logged)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """`_runs`'s numbers, computed by one xdist worker of the run
    (`_torch_port_shared.py`)."""
    return shared(request, "tp_runs", lambda: _runs(tmp_path_factory.mktemp("tp")))


# --- the tests ---------------------------------------------------------------------


def _flax_to_torch_dims(params, stats, encoder_name):
    """{flax leaf path: (torch name, {flax dim: torch dim})} through the
    converter: each leaf is filled with its number x 4096 plus its index
    along one dim, and the torch tensor that holds the number is found, and
    the dim along which it varies."""
    import jax
    from mde_tpu_torch.checkpoint import state_dict_from_flax

    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = [p for p, _ in leaves]
    out = {p: [None, {}] for p in paths}
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), stats)
    for back in (1, 2):  # the last dim, then the one before it
        arrays = []
        for i, (_, leaf) in enumerate(leaves):
            shape = leaf.shape
            fill = np.full(shape, 4096.0 * (i + 1), np.float32)
            if len(shape) >= back:
                dim = len(shape) - back
                fill += np.arange(shape[dim], dtype=np.float32).reshape(
                    [-1 if d == dim else 1 for d in range(len(shape))])
            arrays.append(fill)
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), arrays)
        for name, t in state_dict_from_flax(tree, zeros, encoder_name).items():
            i = int(t.reshape(-1)[0].item()) // 4096 - 1
            if i < 0 or "running_" in name:
                continue
            path = paths[i]
            out[path][0] = name
            for d in range(t.dim()):
                if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any()):
                    out[path][1][len(leaves[i][1].shape) - back] = d
    return {p: (name, dims) for p, (name, dims) in out.items()}


def test_layout_matches_jax(jax_variables):
    """The same tensors split, each on the corresponding dim and the same
    indices for each rank, as `mde_tpu.parallel.train_state_sharding` on
    make_mesh(d,m) of the virtual CPU devices, B1 AdaBins (the JAX tree of
    the step cases: its conv_out reads 5 queries, and 16 bins) and B5's
    conv_head, both modes; the pinned differences asserted as such."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from mde_tpu.models.efficientnet import _pw_conv
    from mde_tpu.parallel import make_mesh, train_state_sharding as jax_sharding
    from mde_tpu_torch.models.efficientnet import EfficientNetEncoder
    from mde_tpu_torch.parallel import Grid, train_state_sharding
    from mde_tpu_torch.parallel.sharding import rank_index

    _, params, stats = jax_variables
    args = _args()
    names = _flax_to_torch_dims(params, stats, args.encoder_name)
    with torch.device("meta"):
        model = _model(args, SMALL_QUERIES)
        b5 = EfficientNetEncoder("efficientnet-b5")

    class Head(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return _pw_conv(2048, jnp.float32, "conv_head")(x)

    b5_params = jax.eval_shape(Head().init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, 1, 1, 512), jnp.float32))["params"]
    torch_shapes = dict(model.named_parameters())
    heads = model.adaptive_bins_layer.patch_transformer.transformer_encoder.layers[0]
    assert heads.self_attn.num_heads == 4
    for shape in ("1,2", "2,2", "4,2", "1,3"):
        d, m = map(int, shape.split(","))
        mesh = make_mesh(shape, devices=jax.devices()[:d * m])
        for mode in ("targeted", "all"):
            jax_specs = jax.tree_util.tree_flatten_with_path(
                jax_sharding(params, mesh, mode))[0]
            want, slices = {}, {}
            for path, sharding in jax_specs:
                spec = tuple(sharding.spec)
                if "model" not in spec:
                    continue
                dim = spec.index("model")
                name, dims = names[path]
                want[name] = dims[dim]
                leaf = dict(jax.tree_util.tree_flatten_with_path(params)[0])[path]
                slices[name] = {dev.id: idx[dim] for dev, idx in
                                sharding.devices_indices_map(leaf.shape).items()}
            got = {}
            for rank in range(d * m):
                layout = train_state_sharding(model, Grid(d, m, rank), mode)
                got = {k: v[0] for k, v in layout.items()}
                for k, (dim, index) in layout.items():
                    size = torch_shapes[k].shape[dim]
                    if k.endswith("in_proj_weight") or k.endswith("in_proj_bias"):
                        if mode == "targeted":  # pinned: the rows of this rank's heads
                            assert torch.equal(index, rank_index("heads", size, m, rank % m))
                            continue
                    if k in slices:
                        sl = slices[k][rank]
                        assert torch.equal(index, torch.arange(size)[sl]), (shape, mode, k)
            extra, missing = {}, {}
            if mode == "targeted":
                # pinned: a column-parallel layer's bias is split with its weight
                extra = {k: 0 for k in got if k.endswith("bias")}
                if 4 % m:  # pinned: the attention pair replicated, whole heads only
                    missing = {k: v for k, v in want.items() if "in_proj" in k}
            assert all(k in want or k in extra for k in got)
            assert {**{k: v for k, v in want.items() if k not in missing}, **extra} == got, \
                (shape, mode)
            if mode == "targeted":
                assert ("conv_out.0.weight" in got) == (args.n_bins % m == 0)
                assert ("adaptive_bins_layer.patch_transformer.transformer_encoder.layers.0."
                        "self_attn.in_proj_weight" in got) == (4 % m == 0)
                assert missing == {} or m == 3
            b5_spec = tuple(jax_sharding(b5_params, mesh, mode)["conv_head"]["kernel"].spec)
            b5_got = train_state_sharding(b5, Grid(d, m, 0), mode)
            assert ("model" in b5_spec) == ("conv_head.weight" in b5_got) == (2048 % m == 0)
            assert "model" not in b5_spec or (b5_spec[-1] == "model"
                                              and b5_got["conv_head.weight"][0] == 0)


def _tp_checks(result, loss_rtol):
    """The ranks' metrics equal, some parameters split, and every
    replicated parameter and buffer bitwise equal on all ranks; the metrics
    against `want`."""
    ranks = result["ranks"]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert ranks[0]["split"] and all(r["split"] == ranks[0]["split"] for r in ranks)
    assert len({r["replicated"] for r in ranks}) == 1
    if result["want"] is not None:
        for k in ("loss", "silog", "chamfer"):
            np.testing.assert_allclose(ranks[0]["metrics"][k], result["want"]["metrics"][k],
                                       rtol=loss_rtol, err_msg=k)


def test_step_matches_jax_two_device_model_axis(runs):
    """1,2 float32 step against JAX's on make_mesh("1,2") with
    train_state_sharding: loss and SILog, the gathered gradients, the BN
    running stats."""
    got, jax_mesh = runs["jax"], runs["jax_mesh"]
    assert jax_mesh["n_split"] > 0  # JAX's rule split something on 'model'
    _tp_checks(got, 2e-4)
    for k in ("loss", "silog"):
        np.testing.assert_allclose(got["ranks"][0]["metrics"][k], jax_mesh["metrics"][k],
                                   rtol=2e-4, err_msg=k)
    port_keys, jax_keys = got["grad_keys"]
    jax_keys = {k for k in jax_keys if "running_" not in k and "num_batches" not in k}
    # the encoder's last BatchNorm feeds no output: no gradient on either rank
    assert port_keys == jax_keys - {f"encoder.original_model.bn2.{p}" for p in ("weight", "bias")}
    err = got["error"]
    print(f"jax: 1,2 vs JAX's 1,2 mesh, largest gradient error {err['grad'][0]:.2e} "
          f"({err['grad'][1]}), BN {err['bn'][0]:.2e}")
    assert err["grad"][0] < GRAD_TOL, err
    assert err["bn"][0] <= 1.0, err


@pytest.mark.parametrize("case", F64_CASES)
def test_float64_steps_match_one_process(runs, case):
    """Gathered gradients within 1e-9 of the largest, the clip's global norm
    rtol 1e-12, the BN buffers, the losses; replicas bitwise equal."""
    got = runs[case]
    _tp_checks(got, METRIC_RTOL_F64)
    for r in got["ranks"]:
        np.testing.assert_allclose(r["norm"], got["want"]["norm"], rtol=NORM_RTOL_F64)
    err = got["error"]
    print(f"{case}: largest gradient error {err['grad'][0]:.2e} ({err['grad'][1]}), "
          f"BN {err['bn'][0]:.2e}")
    assert err["grad"][0] < GRAD_TOL_F64, err
    assert err["bn"][0] <= 1.0, err


def test_fused_head_step_matches_one_process(runs):
    """320x416, 128 bins, float32, dropout on: the fused head's entry with
    conv_out gathered, whole on each rank."""
    got = runs["fused"]
    _tp_checks(got, 2e-4)
    err = got["error"]
    print(f"fused: largest gradient error {err['grad'][0]:.2e} ({err['grad'][1]})")
    assert err["grad"][0] < GRAD_TOL, err
    assert err["bn"][0] <= 1.0, err


def test_checkpoints_cross_between_one_process_and_the_grid(runs):
    """A one-process checkpoint loads under 1,2 into equal slices of the
    weights and AdamW moments; the 1,2 state saves that same file back."""
    ranks = runs["ckpt"]
    assert all(r["equal"] for r in ranks)
    assert all((r["epoch"], r["step"]) == (3, 1) for r in ranks)
    assert any(k.endswith("conv_out.0.weight") for k in ranks[0]["split"])
    files = runs["ckpt_files"]  # the two files, compared where they were written
    one_counts, tp_counts = files["counts"]
    assert tp_counts == one_counts
    one_keys, tp_keys = files["model_keys"]
    assert tp_keys == one_keys
    assert not files["model_unequal"], files["model_unequal"]
    one_groups, tp_groups = files["param_groups"]
    assert tp_groups == one_groups
    assert not files["slots_unequal"], files["slots_unequal"]


def test_driver_trains_on_a_1_2_grid(runs):
    """main_train --distributed --mesh_shape 1,2: 2 steps and a validation
    on both ranks, the split layers held as slices; rank 0's logged metrics
    those of one process validating the gathered checkpoint, rtol 1e-5."""
    from mde_tpu_torch.ops import METRIC_NAMES

    ranks = runs["driver"]
    assert [r["step"] for r in ranks] == [2, 2] and ranks[0]["exp_dir"] == ranks[1]["exp_dir"]
    assert "encoder.original_model.conv_head.weight" in ranks[0]["split"]
    # one process's validation of the latest checkpoint, run where it was written
    checked = runs["driver_validation"]
    (latest,) = checked["latest"]
    assert checked["step"] == 2
    want, logged = checked["want"], checked["logged"]
    assert sorted(logged) == sorted(METRIC_NAMES)
    for k in METRIC_NAMES:
        np.testing.assert_allclose(logged[k], want[k], rtol=1e-5, err_msg=k)
