"""Port parity, the serving slice: mde_tpu_torch.infer.InferenceHelper against
mde_tpu.infer.InferenceHelper on the same weights and image (CPU, float32,
B1, 256 bins, 320x416), plus the checkpoint name map and build_model.

320x416 is the smallest NYU-shaped input with the 129 mViT tokens the head
needs (10*13 = 130), and its 160x208 decoder map is a multiple of 128 pixels,
so the port's model takes the fused bins head — its plain version on the CPU
— while the JAX helper runs the unfused head.

Depth tolerance atol 2e-3 m, rtol 1e-4: the ~60 convolutions before the head
sum in different orders in oneDNN and XLA, and the softmax over 256 bins and
the flip-TTA resize carry those differences into metres.
"""

import jax
import numpy as np
import pytest
import torch

from mde_tpu.checkpoint import convert_reference_checkpoint
from mde_tpu.config import TrainArgParser, parse_cli
from mde_tpu.infer import InferenceHelper as JaxInferenceHelper
from mde_tpu_torch.checkpoint import load_reference_checkpoint, state_dict_from_flax
from mde_tpu_torch.data.transforms import normalize_image
from mde_tpu_torch.infer import InferenceHelper
from mde_tpu_torch.kernels import bins_head
from mde_tpu_torch.models import UnetAdaptiveBins, build_model
from mde_tpu_torch.models import unet_adaptive_bins
from test_torch_port_models import flax_variables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    return flax_variables(n_bins=256, seed=4)


@pytest.fixture(scope="module")
def predictions(weights):
    params, stats = weights
    rng = np.random.default_rng(5)
    image = normalize_image(rng.random((320, 416, 3), dtype=np.float32))[None]
    want = JaxInferenceHelper(params=params, batch_stats=stats).predict(image)

    helper = InferenceHelper(state_dict=state_dict_from_flax(params, stats),
                             device=torch.device("cpu"))
    calls = []

    def spy(features, *rest):
        calls.append(features.shape)
        return bins_head.fused_bins_head(features, *rest)

    mp = pytest.MonkeyPatch()
    mp.setattr(unet_adaptive_bins, "fused_bins_head", spy)
    bins_head.LAUNCHES = 0
    try:
        got = helper.predict(image)
    finally:
        mp.undo()
    return want, got, calls, bins_head.LAUNCHES


def test_predict_depth_matches_jax(predictions):
    (_, want), (_, got), _, _ = predictions
    assert got.shape == want.shape == (1, 320, 416, 1)
    assert np.all(np.isfinite(got)) and got.min() >= 1e-3 and got.max() <= 10
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_predict_centers_match_jax(predictions):
    (want, _), (got, _), _, _ = predictions
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_predict_takes_the_fused_head_once(predictions):
    """One batch-2 forward per request through the fused head; on the CPU the
    wrapper runs the plain version and launches no kernel."""
    _, _, calls, launches = predictions
    assert calls == [torch.Size([2, 128, 160, 208])]
    assert launches == 0


def test_state_dict_round_trips_through_reference_converter(weights, tmp_path):
    """state_dict_from_flax -> torch.save -> convert_reference_checkpoint gives
    the flax trees back exactly, and the port loads it with strict=True."""
    params, stats = weights
    sd = state_dict_from_flax(params, stats)
    path = tmp_path / "adabins.pt"
    torch.save({"model": sd}, path)
    back_params, back_stats = convert_reference_checkpoint(str(path), "efficientnet-b1")
    for want, got in ((params, back_params), (stats, back_stats)):
        want_leaves, want_def = jax.tree_util.tree_flatten(want)
        got_leaves, got_def = jax.tree_util.tree_flatten(got)
        assert got_def == want_def
        for a, b in zip(want_leaves, got_leaves):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    model = UnetAdaptiveBins(n_bins=256, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1")
    model.load_state_dict(sd, strict=True)


def test_load_reference_checkpoint_strips_prefixes(weights, tmp_path):
    """DDP `module.` prefixes and the two legacy mViT names load too."""
    sd = state_dict_from_flax(*weights)
    legacy = {}
    for k, v in sd.items():
        k = k.replace("adaptive_bins_layer.conv3x3.", "adaptive_bins_layer.embedding_conv.")
        k = k.replace("patch_transformer.embedding_convPxP", "patch_transformer.embedding_encoder")
        legacy["module." + k] = v
    path = tmp_path / "legacy.pt"
    torch.save({"model": legacy, "epoch": 3}, path)
    model = UnetAdaptiveBins(n_bins=256, min_val=1e-3, max_val=10.0,
                             encoder_name="efficientnet-b1")
    load_reference_checkpoint(model, str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _args(*extra):
    return parse_cli(TrainArgParser(), ["--encoder_name", "efficientnet-b1",
                                        "--n_bins", "256", *extra])


@pytest.mark.parametrize("extra,fused", [((), True), (("--no-use_fused_head",), False)])
def test_build_model_follows_fused_head_flag(extra, fused):
    model = build_model(_args(*extra))
    assert model.fused_head is fused and model.n_bins == 256
    assert model.conv_out[0].weight.shape == (256, 128, 1, 1)


CUE_BUILDS = {
    "semantics_raw": (("--use_semantics", "raw"), 3, 129, {}),
    "coco": (("--use_instance_segmentation", "coco"), 3, 163, {"instance_areas_fc": 1}),
    "noAdaBins": (("--encoder_name", "efficientnet-b1-noAdaBins"), 3, None, {}),
    "image_none": (("--image", "none", "--use_semantics", "glove-25d",
                    "--insertion_point", "input"), 25, 128, {}),
    "human_sizes_input": (("--use_semantics", "glove-25d-ade20k-places-human-sizes",
                           "--use_instance_segmentation", "ade20k_swin_bbox_human_sizes",
                           "--insertion_point", "input"), 83, 128,
                          {"semantics_absolute_sizes_fc": 3, "instance_areas_fc": 1,
                           "instance_absolute_sizes_fc": 3}),
}


def _jax_state_dict_shapes(args):
    """Names and shapes of the JAX model's tree for these args, under the
    port's torch names (init traced by eval_shape, at 320x416: below 129
    mViT tokens the JAX head has fewer queries and a narrower conv_out)."""
    from mde_tpu.models import build_model as jax_build_model
    from test_torch_port_cues import jax_embed, raw_cues
    raw = raw_cues(np.random.default_rng(0), 1, (320, 416), args.use_instance_segmentation)
    raw["image"] = np.zeros((1, 320, 416, 3), np.float32)
    cues = jax.eval_shape(jax_embed(args), raw)
    shapes = jax.eval_shape(
        jax_build_model(args).init, jax.random.PRNGKey(0), raw["image"],
        *[c if (args.use_semantics, args.use_instance_segmentation)[min(i, 1)] else None
          for i, c in enumerate(cues)])
    zeros = jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros["params"], zeros["batch_stats"], args.encoder_name)
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("case", list(CUE_BUILDS))
def test_build_model_builds_cue_configs(case):
    """The stem, the mViT and the CueMLPs take the widths and names of the
    JAX model's tree, and every other tensor matches it too."""
    extra, stem, mvit, mlps = CUE_BUILDS[case]
    args = _args(*extra)
    model = build_model(args)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _jax_state_dict_shapes(args)
    assert got["encoder.original_model.conv_stem.weight"] == (32, stem, 3, 3)
    if mvit is None:
        assert model.decoder.conv3.weight.shape[0] == 1
        assert not any(k.startswith(("adaptive_bins_layer.", "conv_out.")) for k in got)
    else:
        assert got["adaptive_bins_layer.conv3x3.weight"] == (128, mvit, 3, 3)
        assert got["adaptive_bins_layer.patch_transformer.embedding_convPxP.weight"] == (
            128, mvit, 16, 16)
    assert {k.split(".")[0] for k in got if k.endswith("_fc.0.weight")} == set(mlps)
    for name, c in mlps.items():
        assert got[name + ".0.weight"] == (10, c, 1, 1) and got[name + ".2.weight"] == (
            10, 10, 1, 1)


@pytest.mark.parametrize("extra", [
    ("--image", "none"),
    ("--use_semantics", "glove-25d-ade20k-places-human-sizes")])
def test_build_model_refuses_what_jax_refuses(extra):
    """No input cue to replace the image; semantics human-sizes before the
    mViT (a reference configuration that cannot run)."""
    with pytest.raises(ValueError):
        build_model(_args(*extra))
