"""Port parity, data parallelism: a 2-rank DistributedDataParallel step of
mde_tpu_torch (gloo, two processes on this CPU) against the port's one-process
step on the concatenated batch, and against mde_tpu's `make_train_step` on a
2-device mesh (GSPMD: BatchNorm and SILog over the global batch). The parts
that need no process group are `test_torch_port_parallel.py`.

Cases, each one step from the same seeded weights:
* `noadabins`: B1 noAdaBins at 64x96, 2 images a rank, float32. BatchNorm's
  global moments and SILog's global variance, the parts where a per-rank
  loss averaged by DDP would differ; held against one process (its float64
  step on the whole batch, the one `noadabins64` runs) and against JAX's
  2-device mesh.
* `noadabins64`: the same in float64, where rounding no longer hides a
  fault: the 2-rank step must equal the one-process step to 1e-9 of the
  largest gradient (the reading is ~2e-11), which holds the scaling of the
  gradients through the differentiable all-reduces and DDP's mean exactly.
* `accum64`: `noadabins64` with `--accum_steps 2` (DDP's `no_sync` on the
  first micro-batch), against one process whose micro-batch i is the ranks'
  micro-batches i together; to 1e-9 as well.
* `adabins`: B1 AdaBins, 16 bins, at 320x416 (the 129 mViT tokens the head
  needs), one image a rank, float32, mViT dropout off (the ranks draw their
  own masks). The fused head and the chamfer kernel's entry run per rank
  (their plain versions on the CPU); the chamfer, a mean of per-image
  losses, is averaged by DDP. Held against one process.

Tolerances, float32: loss rtol 2e-4 (JAX's `test_one_vs_eight_device_parity`);
BatchNorm running stats rtol 1e-5 with atol 1e-6 (means of BatchNorms whose
input is itself normalised are ~1e-10, float32 noise); gradients within
GRAD_TOL (2e-2) of the largest gradient value. The ranks sum the batch
moments in another order (about the running mean, then over the ranks) than
one process's fused BatchNorm kernel, and train-mode BatchNorm backwards grow
that rounding through the encoder: the reading is 6.9e-3 (noadabins,
against one process's float64 step) and 9.4e-3 (adabins, against its
float32 step) and 4.0e-3 against JAX (whose flax BatchNorm takes the same
E[x^2] - E[x]^2 form), the largest in the first blocks; float64 shows there
is no more to it. Both ranks must end with the
same gradients and buffers. The card's check (`chip_smoke.py` phase 9) holds
its float32 2-rank step to the same GRAD_TOL.

Cost: the ranks and the one-process reference run every case in three
spawned processes of one thread each, while the test's own process compiles
and runs JAX's 2-device step (9.3 GB of resident memory together, this file
alone); under xdist one worker of the run does this and the others read
its numbers (`_torch_port_shared.py`). The ranks meet in a file store, so
they bind no port.
"""

import hashlib
import os
import shutil
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_port_shared import shared

torch.set_num_threads(2)

GRAD_TOL = 2e-2  # float32, of the largest gradient value
GRAD_TOL_F64, LOSS_RTOL_F64 = 1e-9, 1e-12
SMALL_HW, BIG_HW = (64, 96), (320, 416)


def _args(**kw):
    base = dict(n_bins=16, min_depth=1e-3, max_depth=10.0, norm="linear",
                encoder_name="efficientnet-b1-noAdaBins", use_semantics=None,
                use_instance_segmentation=None, insertion_point="before-attn",
                image="rgb", w_chamfer=0.1, chamfer=True, epochs=25, lr=0.000357,
                wd=0.1, div_factor=25.0, final_div_factor=100.0, same_lr=False,
                encoder_lr_factor=1.0, seed=0, use_fused_head=True,
                use_pallas_chamfer=True, compute_dtype="float32", accum_steps=1,
                remat="none")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _step(case, rank, world_size, out_dir):
    """One training step of `case` on this rank's shard (the whole batch
    with one rank); writes the loss, the gradients the optimizer received
    and the state after the step."""
    from mde_tpu_torch.models import build_model
    from mde_tpu_torch.train import create_train_state, make_train_step, wrap_ddp

    args = _args(**case["args"])
    model = build_model(args)
    model.load_state_dict(case["state_dict"], strict=True)
    for m in model.modules():
        if hasattr(m, "dropout"):
            m.dropout = 0.0
    f64 = case.get("float64", False)
    if f64:  # the `.float()` casts of the model and the losses leave float64 as it is
        model.double()
        to_float = torch.Tensor.float
        torch.Tensor.float = (lambda self, *a, **k: self if self.dtype == torch.float64
                              else to_float(self, *a, **k))
    state = create_train_state(model, args, steps_per_epoch=10)
    if world_size > 1:
        wrap_ddp(state)
    seen = {}
    real = state.optimizer.step

    def watch(step_index):
        seen.update({k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                     for k, p in model.named_parameters()})
        return real(step_index)

    state.optimizer.step = watch
    batch = case["batch"]
    n = batch["image"].shape[0] // world_size
    shard = {k: v[rank * n:(rank + 1) * n].double() if f64 else v[rank * n:(rank + 1) * n]
             for k, v in batch.items()}
    try:
        state, metrics = make_train_step(args)(state, shard)
    finally:
        if f64:
            torch.Tensor.float = to_float
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    out = {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": seen,
           "state": buffers}
    if rank == 1:  # its gradients and buffers as a digest: rank 0's are kept
        digest = hashlib.sha256()
        for tensors in (seen, buffers):
            for k in sorted(tensors):
                digest.update(tensors[k].numpy().tobytes())
        out = {"metrics": out["metrics"], "digest": digest.hexdigest()}
    torch.save(out, os.path.join(out_dir, f"{case['name']}_{world_size}_{rank}.pt"))


def _digest(result):
    digest = hashlib.sha256()
    for tensors in (result["grads"], result["state"]):
        for k in sorted(tensors):
            digest.update(tensors[k].numpy().tobytes())
    return digest.hexdigest()


def _process(index, store, cases_file, out_dir):
    """A spawned process: 0 and 1 join the 2-rank gloo group, which meets in
    the file store `store` (no port to bind), and run every case; 2 runs the
    one-process steps meanwhile."""
    from mde_tpu_torch import parallel
    torch.set_num_threads(1)
    cases, single = torch.load(cases_file, mmap=True)
    if index == 2:
        for case in single:
            _step(case, 0, 1, out_dir)
        return
    parallel.init_distributed(index, 2, f"file://{store}", "gloo", "cpu")
    try:
        for case in cases:
            _step(case, index, 2, out_dir)
    finally:
        parallel.destroy_distributed()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _batch(rng, n, hw):
    image = rng.standard_normal((n, *hw, 3)).astype(np.float32)
    depth = (rng.random((n, *hw, 1)) * 9.9 + 0.05).astype(np.float32)
    depth[:, :hw[0] // 8] = 0.0  # not valid
    depth[1, hw[0] // 2:] = 0.0  # the images differ in their valid counts
    return image, depth


def _inputs():
    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu_torch.checkpoint import state_dict_from_flax
    from test_torch_port_models import seeded_variables

    from mde_tpu_torch.models import build_model

    rng = np.random.default_rng(21)
    args = _args()
    params, stats = seeded_variables(jax_build_model(args), [(1, *SMALL_HW, 3)], seed=22)
    image, depth = _batch(rng, 4, SMALL_HW)
    out = {"noadabins": dict(args={}, params=params, stats=stats, image=image, depth=depth,
                             state_dict=state_dict_from_flax(params, stats,
                                                             args.encoder_name))}
    # no JAX side for this case: the port's own initialisation, seeded
    kw = {"encoder_name": "efficientnet-b1"}
    torch.manual_seed(22)
    image, depth = _batch(rng, 2, BIG_HW)
    out["adabins"] = dict(args=kw, image=image, depth=depth,
                          state_dict=build_model(_args(**kw)).state_dict())
    return out


def _runs(inputs, out_dir):
    """Every case on 2 spawned gloo ranks, and beside them in a third process
    on the whole batch, while this process runs JAX's step on a 2-device
    mesh; {case: {"two": (rank 0, rank 1), "one": result}, "jax": ...}."""
    cases, single = [], []
    for name in CASES:
        src = inputs["adabins" if name == "adabins" else "noadabins"]
        kw = dict(src["args"], **({"accum_steps": 2} if name == "accum64" else {}))
        image, depth = _nchw(src["image"]), _nchw(src["depth"])
        case = dict(name=name, args=kw, state_dict=src["state_dict"],
                    batch={"image": image, "depth": depth}, float64=name.endswith("64"))
        cases.append(case)
        if name == "accum64":  # micro-batch i of one process = the ranks' micro-batches i
            order = [0, 2, 1, 3]
            image, depth = image[order], depth[order]
        if name != "noadabins":  # held against noadabins64's one-process step
            single.append(dict(case, batch={"image": image, "depth": depth}))
    cases_file = os.path.join(out_dir, "cases.pt")
    torch.save((cases, single), cases_file)
    store = os.path.join(out_dir, "store")
    context = mp.start_processes(_process, args=(store, cases_file, out_dir), nprocs=3,
                                 join=False, start_method="spawn")
    try:
        jax_result = _jax_two_devices(inputs)
    finally:
        while not context.join():
            pass

    def load(name, world_size, rank):
        return torch.load(os.path.join(out_dir, f"{name}_{world_size}_{rank}.pt"))

    out = {c["name"]: {"two": (load(c["name"], 2, 0), load(c["name"], 2, 1)),
                       "one": load(c["name"] if c["name"] != "noadabins" else "noadabins64",
                                   1, 0)} for c in cases}
    out["jax"] = jax_result
    shutil.rmtree(out_dir)  # ~0.5 GB of gradients, now in memory
    return out


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """`_runs`' numbers, computed by one xdist worker of the run: one spawn
    of the ranks a run (`_torch_port_shared.py`)."""
    return shared(request, "ddp_runs",
                  lambda: _runs(_inputs(), str(tmp_path_factory.mktemp("ddp"))))


CASES = ["noadabins", "noadabins64", "accum64", "adabins"]


def _largest(grads):
    return max(g.abs().max().item() for g in grads.values())


def _grad_error(got, want):
    largest = _largest(want)
    return max(((got[k] - w).abs().max().item() / largest, k) for k, w in want.items())


def _tol(case):
    return (LOSS_RTOL_F64, GRAD_TOL_F64) if case.endswith("64") else (2e-4, GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_one_process(runs, case):
    """Loss, SILog and chamfer; the gradients the optimizer receives; the BN
    running stats after the step. Both ranks end alike."""
    two, one = runs[case]["two"], runs[case]["one"]
    loss_rtol, grad_tol = _tol(case)
    assert two[0]["metrics"] == two[1]["metrics"]
    assert _digest(two[0]) == two[1]["digest"]  # the same gradients and buffers
    for k in ("loss", "silog", "chamfer"):
        np.testing.assert_allclose(two[0]["metrics"][k], one["metrics"][k], rtol=loss_rtol,
                                   err_msg=k)
    if case == "adabins":
        assert one["metrics"]["chamfer"] > 0
    err = _grad_error(two[0]["grads"], one["grads"])
    print(f"{case}: 2 ranks vs 1 process, largest gradient error {err[0]:.2e} of the largest "
          f"value ({err[1]})")
    assert err[0] < grad_tol, err
    # the encoder's last BatchNorm feeds no output: no gradient on any rank,
    # a zero one for the optimizer, and no hang
    assert not two[0]["grads"]["encoder.original_model.bn2.weight"].any()
    for k, v in one["state"].items():
        if "running_" in k or "num_batches" in k:
            np.testing.assert_allclose(two[0]["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _jax_two_devices(inputs):
    """JAX's step on a 2-device mesh for `noadabins`, its gradients kept by
    an optax transformation that updates by zero."""
    import jax
    import jax.numpy as jnp
    import optax

    from mde_tpu.models import build_model as jax_build_model
    from mde_tpu.parallel import batch_sharding, make_mesh, replicated_sharding
    from mde_tpu.train.loop import make_train_step as jax_make_train_step
    from mde_tpu.train.state import TrainState as JaxTrainState
    from mde_tpu_torch.checkpoint import state_dict_from_flax

    src = inputs["noadabins"]
    args = _args()

    def init(p):
        return {"grads": jax.tree_util.tree_map(np.zeros_like, p)}

    def update(updates, state, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {"grads": updates}

    mesh = make_mesh("2", devices=jax.devices()[:2])
    model = jax_build_model(args, dtype=jnp.float32)
    state = JaxTrainState.create(apply_fn=model.apply, params=src["params"],
                                 batch_stats=src["stats"],
                                 tx=optax.GradientTransformation(init, update))
    state = jax.device_put(state, replicated_sharding(mesh))
    batch = {"image": jax.device_put(src["image"], batch_sharding(mesh)),
             "depth": jax.device_put(src["depth"], batch_sharding(mesh))}
    new_state, metrics = jax_make_train_step(model, args, None, None, mesh)(
        state, batch, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state["grads"])
    stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=state_dict_from_flax(grads, src["stats"], args.encoder_name),
                state=state_dict_from_flax(src["params"], stats, args.encoder_name))


@pytest.fixture(scope="module")
def jax_two_devices(runs):
    return runs["jax"]


def test_two_ranks_match_jax_two_device_mesh(runs, jax_two_devices):
    """noadabins: loss and SILog, the gradients and the BN running stats of
    the 2-rank step against JAX's step on a 2-device mesh."""
    got = runs["noadabins"]["two"][0]
    for k in ("loss", "silog"):
        np.testing.assert_allclose(got["metrics"][k], jax_two_devices["metrics"][k],
                                   rtol=2e-4, err_msg=k)
    want = {k: v for k, v in jax_two_devices["grads"].items() if k in got["grads"]}
    assert want.keys() == got["grads"].keys()
    err = _grad_error(got["grads"], want)
    print(f"noadabins: 2 ranks vs JAX's 2-device mesh, largest gradient error {err[0]:.2e} "
          f"of the largest value ({err[1]})")
    assert err[0] < GRAD_TOL, err
    for k, v in jax_two_devices["state"].items():
        if "running_" in k:
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
