"""Port parity, HRNetV2-W48 + C1 training: mde_tpu_torch.offline.hrnet_train
against mde_tpu.offline.hrnet_train (CPU, float32).

The JAX model is seeded from the port's encoder and decoder state_dicts
through its own converter (`convert_hrnet_c1`, handed the dicts in memory).
One `make_semseg_train_step` on each side (the JAX step under its own
jax.jit) in float32 and in float64: W48 widths (48/96/192/384 branches, 4
blocks a branch), one exchange unit a stage instead of (1, 4, 3) (the stage
tables of both packages and the converter's set for this file: the full
network's JAX training step takes longer than this file's budget to trace
and compile), a batch of 2 of 64x64, 8 classes, labels at 1/4 resolution
with a -1 border and a -1 patch, torch's native CPU convolutions (oneDNN's
are less exact), SGD + poly (base lr 0.02 over 100 iterations, momentum
0.9, weight decay 1e-4). JAX's float64 step runs under x64 with the float32
casts of its `hrnet.py` and `ops/resize.py` (BatchNorm, logits, resize)
read as float64 (the modules' `jnp` swapped for this file); it is the
reference the float32 noise is measured against. The updated state_dicts go
through the same converter and are held leaf by leaf.

Tolerances: loss and pixel accuracy rtol 1e-5 against JAX's float32 step.
The two float64 steps agree: loss rtol 1e-12, accuracy (the port's is a
float32 ratio of counts) 1e-7, every updated parameter and BatchNorm running
mean and variance within 1e-10 of its tensor's largest magnitude (measured
2.3e-13). Against JAX's float64 step, each tensor of the port's float32
step lies within twice JAX's own float32 distance from it plus 1e-5 of the
largest magnitude or, beyond that, within a noise bound fixed by name:
1e-2 for a BatchNorm bias, 1e-4 for any other tensor; and the port's
summed squared float32 error is at most twice JAX's. More than half the
parameters and 90 % of the BatchNorm stats lie within 1e-5 of JAX's float32
step. Float32 noise is real and large at initialisation: each of the ~100
train-mode BatchNorms takes the mean out of the gradient it passes down, so
a BatchNorm bias feeding a ReLU, a convolution and the next BatchNorm gets a
sum of terms of either sign, ~1e-3 of their size, and the layers below
inherit the noise. Measured: 153 of 353 updated tensors beyond 1e-5 of
JAX's float32 step, JAX's own float32 error up to 2.9e-2 of a BatchNorm
bias's largest value; two tensors of the port beyond twice JAX's (stage 4's
first block: bn1's bias at 5.9e-3 against JAX's 2.3e-5, conv1 at 1.8e-5
against 8.2e-8); 14 of 234 BatchNorm stats beyond 1e-5, none beyond twice
JAX's noise. `-s` prints these counts.
The poly schedule equals JAX's (float32) at steps 0, 1, 50, 99, 100 and 150,
and the optimizer runs update k at the schedule's step k.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mde_tpu.offline import hrnet as jax_hrnet
from mde_tpu.offline import hrnet_convert
from mde_tpu.offline import hrnet_train as jax_train
from mde_tpu.offline.hrnet_convert import convert_hrnet_c1
from mde_tpu.ops import resize as jax_resize
from mde_tpu_torch.offline import hrnet, hrnet_train
from mde_tpu_torch.offline.layers import seeded

torch.set_num_threads(4)

HW = (64, 64)
N_CLASSES = 8
BASE_LR, MAX_ITERS = 0.02, 100


def _convert(model):
    """convert_hrnet_c1 on the port's state_dicts, in memory."""
    sds = iter([model.encoder.state_dict(), model.decoder.state_dict()])
    real_load = torch.load
    torch.load = lambda *a, **k: next(sds)
    try:
        return convert_hrnet_c1("encoder", "decoder")
    finally:
        torch.load = real_load


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *HW, 3), dtype=np.float32)
    labels = rng.integers(0, N_CLASSES, (2, HW[0] // 4, HW[1] // 4)).astype(np.int32)
    labels[:, 0] = -1
    labels[:, :, -1] = -1
    labels[1, 5:9, 3:7] = -1
    return x, labels


class _WidestJnp:
    """`jax.numpy` with `float32` read as the widest float of the calling
    thread's mode: float64 under x64, where the JAX module's float32
    BatchNorms, logit cast and resize then compute in float64; float32, as
    written, elsewhere."""

    @property
    def float32(self):
        return jax.dtypes.canonicalize_dtype(jnp.float64)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def steps():
    mp = pytest.MonkeyPatch()
    for module in (jax_hrnet, hrnet):
        mp.setattr(module, "_STAGE_CFG", {k: (1, c, b) for k, (_, c, b) in
                                          module._STAGE_CFG.items()})
    mp.setattr(hrnet_convert, "_STAGES", {k: (1, b) for k, (_, b) in
                                          hrnet_convert._STAGES.items()})
    # torch's native CPU convolutions: oneDNN's float32 convolutions drift
    # ~1e-2 of the largest value from the float64 step in the decoder's
    # 3x3 conv weight gradient (~2e-5 natively, as JAX's)
    mp.setattr(torch.backends.mkldnn, "enabled", False)
    mp.setattr(jax_hrnet, "jnp", _WidestJnp())
    mp.setattr(jax_resize, "jnp", _WidestJnp())
    try:
        yield _steps()
    finally:
        mp.undo()


def _jax_step(params, stats, x, labels, dtype):
    """JAX's step at `dtype` (float64 under x64) on the given parameters."""
    tree = jax.tree_util.tree_map
    with jax.enable_x64(dtype == jnp.float64):
        jmodel = jax_hrnet.HRNetV2C1(num_classes=N_CLASSES, dtype=dtype)
        tx = jax_train.build_semseg_optimizer(BASE_LR, MAX_ITERS)
        p = tree(lambda a: jnp.asarray(a, dtype), params)
        jp, _, js, jm = jax_train.make_semseg_train_step(jmodel, tx)(
            p, tx.init(p), tree(lambda a: jnp.asarray(a, dtype), stats),
            jnp.asarray(x, dtype), jnp.asarray(labels))
        assert jp["cbr_conv"]["kernel"].dtype == dtype
        return tree(np.asarray, jp), tree(np.asarray, js), {k: float(v) for k, v in jm.items()}


def _steps():
    """{"port32", "port64", "jax32", "jax64"}: (params, stats, metrics) after
    one step, in the converter's tree; JAX's two steps run in two threads
    beside the port's."""
    model = seeded(lambda: hrnet.HRNetV2C1(num_classes=N_CLASSES), 0)
    # copies: the converter's arrays share memory with the port's parameters,
    # which the port's step updates in place
    params, stats = jax.tree_util.tree_map(np.array, _convert(model))
    x, labels = _batch()
    jax_out, failures = {}, []

    def jax_step(dtype):
        try:
            jax_out[dtype] = _jax_step(params, stats, x, labels, dtype)
        except BaseException as e:  # raised again below
            failures.append(e)

    threads = [threading.Thread(target=jax_step, args=(d,)) for d in (jnp.float32, jnp.float64)]
    for thread in threads:
        thread.start()
    out = {}
    try:
        images = torch.from_numpy(x).permute(0, 3, 1, 2)
        for dtype in (torch.float32, torch.float64):
            m = model if dtype == torch.float32 else seeded(
                lambda: hrnet.HRNetV2C1(num_classes=N_CLASSES), 0).double()
            opt, sched = hrnet_train.build_semseg_optimizer(m, BASE_LR, MAX_ITERS)
            metrics = hrnet_train.make_semseg_train_step(m, opt, sched)(
                images.to(dtype), torch.from_numpy(labels))
            out["port32" if dtype == torch.float32 else "port64"] = (
                *_convert(m), {k: float(v) for k, v in metrics.items()})
            if dtype == torch.float32:
                out["opt"] = opt
    finally:
        for thread in threads:
            thread.join()
    if failures:
        raise failures[0]
    out["jax32"], out["jax64"] = jax_out[jnp.float32], jax_out[jnp.float64]
    return out


def test_loss_and_accuracy_match_jax(steps):
    got, want = steps["port32"][2], steps["jax32"][2]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0 < want["acc"] < 1 and np.isfinite(want["loss"])


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return np.asarray(tree, np.float64)


def _leaf_errors(got, want):
    """{path: max |got - want| / max |want|} over want's leaves."""
    errs = {}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = _leaf(got, path)
        errs[jax.tree_util.keystr(path)] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return errs


# the two float64 steps, each leaf against the largest magnitude of JAX's
# (measured: parameters 2.3e-13, BatchNorm stats 4.8e-14)
FLOAT64_AGREE = 1e-10
# float32 noise against JAX's float64 step beyond twice JAX's own, fixed by
# name: a BatchNorm bias whose gradient cancels (measured: the port's 5.9e-3
# on stage 4's first block bn1, where JAX's is 2.3e-5), any other tensor (the
# convolution before that bn1: 1.8e-5 against JAX's 8.2e-8)
CANCELLING_NOISE = 1e-2
FLOAT32_NOISE = 1e-4


def _noise_bound(key):
    return CANCELLING_NOISE if "bn" in key and key.endswith("['bias']") else FLOAT32_NOISE


def _hold(steps, part):
    """Each leaf of the port's float32 step within twice JAX's float32
    distance from JAX's float64 step plus 1e-5, or within its name's float32
    noise bound of it; the port's float64 step within FLOAT64_AGREE of JAX's
    float64 step; the port's summed squared float32 error at most twice
    JAX's. Returns the errors against JAX's float32 step."""
    got, want, ref, got64 = (steps[k][part] for k in ("port32", "jax32", "jax64", "port64"))
    port_err, jax_err = _leaf_errors(got, ref), _leaf_errors(want, ref)
    agree64 = _leaf_errors(got64, ref)
    beyond = {}
    for key, e in port_err.items():
        assert agree64[key] <= FLOAT64_AGREE, (key, agree64[key])
        if e > 2 * jax_err[key] + 1e-5:
            assert e <= _noise_bound(key), (key, e, jax_err[key])
            beyond[key] = (e, jax_err[key])
    assert sum(e * e for e in port_err.values()) <= 2 * sum(e * e for e in jax_err.values())
    errs = _leaf_errors(got, want)
    print(f"{sum(e > 1e-5 for e in errs.values())} of {len(errs)} leaves beyond 1e-5 of "
          f"JAX's float32 step; float64 steps apart by {max(agree64.values()):.2e}; beyond "
          f"twice JAX's float32 noise (port, JAX): {beyond}")
    return errs


def test_updated_parameters_match_jax(steps):
    errs = _hold(steps, 0)
    assert len(errs) > 300 and sum(e <= 1e-5 for e in errs.values()) > len(errs) // 2


def test_batchnorm_stats_match_jax(steps):
    errs = _hold(steps, 1)
    assert sum(e <= 1e-5 for e in errs.values()) > 0.9 * len(errs)
    # the stats moved: flax's momentum 0.9 from mean 0, variance 1
    assert np.abs(steps["jax32"][1]["cbr_bn"]["mean"]).max() > 0


def test_float64_steps_agree(steps):
    (got, got_stats, got_m), (want, want_stats, want_m) = steps["port64"], steps["jax64"]
    np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-12)
    # the port's accuracy is a float32 ratio of counts
    np.testing.assert_allclose(got_m["acc"], want_m["acc"], rtol=1e-7)
    for g, w in ((got, want), (got_stats, want_stats)):
        assert max(_leaf_errors(g, w).values()) <= FLOAT64_AGREE


def test_poly_schedule_and_optimizer_steps_equal_jax(steps):
    opt = steps["opt"]
    jsched = jax_train.poly_lr_schedule(BASE_LR, MAX_ITERS)
    sched = hrnet_train.poly_lr_schedule(BASE_LR, MAX_ITERS)
    for s in (0, 1, 50, 99, 100, 150):
        assert sched(s) == float(jsched(jnp.asarray(s))), s
    assert opt.param_groups[0]["lr"] == pytest.approx(sched(1), rel=1e-7)  # after one step
    g = opt.param_groups[0]
    assert (g["momentum"], g["dampening"], g["weight_decay"], g["nesterov"]) == \
        (0.9, 0.0, 1e-4, False)
    assert isinstance(jax_train.build_semseg_optimizer(), optax.GradientTransformation)
