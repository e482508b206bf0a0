"""Port parity, the cue configurations: mde_tpu_torch.cues and the cue models
against mde_tpu's (CPU, float32).

Three configurations of the shipped params files, each at full width (B1,
256 bins, NYU 1e-3-10 m):
  A  glove-25d semantics + ade20k_swin_human_sizes instances at the input
     (a 73-channel stem),
  B  glove-25d-inst-areas semantics + coco instances before the mViT (a
     198-channel patch conv and conv3x3),
  C  A's cues on the noAdaBins head (no bins, no mViT).

Each side embeds the same raw maps with its own embedders, and the JAX
weights (seeded, `seeded_variables`) reach the port through
`state_dict_from_flax`. A and B run at 320x416, the smallest NYU-shaped input
with the 129 mViT tokens the head needs, so the port takes the fused head
(its plain version on the CPU) while JAX runs the unfused one; their
tolerances are the serving slice's (tests/test_torch_port_slice.py): depth
rtol 1e-4, atol 2e-3 m, as ~60 convolutions sum in other orders in oneDNN and
XLA and the softmax over 256 bins carries that into metres; centres rtol 1e-4,
atol 1e-4. C has no mViT and runs at 64x96.

Embedders: gathers must be equal, NaN where JAX gives NaN (`jnp.take`: an
index in [-n, n) wraps, any other gives a NaN row); area maps rtol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.checkpoint import convert_reference_checkpoint
from mde_tpu.config import TrainArgParser, parse_cli
from mde_tpu.cues import InstanceEmbedder as JaxInstanceEmbedder
from mde_tpu.cues import SemanticsEmbedder as JaxSemanticsEmbedder
from mde_tpu.models import build_model as jax_build_model
from mde_tpu.models.unet_adaptive_bins import (
    get_num_channels_to_add as jax_get_num_channels_to_add)
from mde_tpu_torch.checkpoint import state_dict_from_flax
from mde_tpu_torch.cues import InstanceEmbedder, SemanticsEmbedder
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.unet_adaptive_bins import get_num_channels_to_add
from test_torch_port_models import nchw, nhwc, seeded_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PARAMS = {
    "A": "args_train_nyu_efficientnet-b1_sem_glove-25d_inst_ade20k_swin_human_sizes_"
         "insertion_point_input.txt",
    "B": "args_train_nyu_efficientnet-b1_sem_glove-25d-inst-areas_inst_coco.txt",
    "C": "args_train_nyu_efficientnet-b1-noAdaBins_sem_glove-25d_inst_ade20k_swin_"
         "human_sizes_insertion_point_input.txt",
}
SEMANTICS_MODES = ["glove", "glove-25d", "glove-25d-inst-areas", "glove-25d-ade20k-places",
                   "glove-25d-ade20k-places-random", "glove-25d-ade20k-places-human-sizes",
                   "raw"]
INSTANCE_MODES = ["coco", "ade20k_swin", "ade20k_swin_bbox", "ade20k_swin_human_sizes",
                  "ade20k_swin_bbox_human_sizes"]


def config_args(name, *extra):
    """The parsed params file of configuration A, B or C, plus overrides."""
    return parse_cli(TrainArgParser(), [os.path.join(REPO, "params", PARAMS[name]), *extra])


def raw_cues(rng, n, hw, inst_mode):
    """Raw cue maps (N, H, W, 1) as the loaders give them: semantic labels
    uniform in [0, 150); instance labels as rectangular blocks on the
    background class, areas each block's pixel count (0 on the background)."""
    h, w = hw
    coco = inst_mode == "coco"
    background, n_classes = (0, 81) if coco else (100, 101)
    labels = np.full((n, h, w), background, np.int32)
    block = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for b in range(1, 5):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            y1, x1 = y0 + rng.integers(h // 8, h // 2), x0 + rng.integers(w // 8, w // 2)
            labels[i, y0:y1, x0:x1] = rng.integers(1 if coco else 0, n_classes - 1)
            block[i, y0:y1, x0:x1] = b
    areas = np.zeros((n, h, w), np.float32)
    for i in range(n):
        counts = np.bincount(block[i].ravel(), minlength=5)
        counts[0] = 0
        areas[i] = counts[block[i]]
    return {"semantics": rng.integers(0, 150, (n, h, w, 1)).astype(np.int32),
            "instance_labels": labels[..., None], "instance_areas": areas[..., None]}


def jax_embed(args):
    """raw maps -> the JAX embedders' (semantics, instance_labels,
    instance_areas); traceable, so a jitted forward embeds too."""
    sem_embedder, inst_embedder = JaxSemanticsEmbedder(args), JaxInstanceEmbedder(args)

    def embed(raw):
        _, sem = sem_embedder(raw["semantics"])
        _, lab, areas = inst_embedder(raw["instance_labels"], raw["instance_areas"])
        return sem, lab, areas

    return embed


def port_cues(args, raw):
    _, sem = SemanticsEmbedder(args, CPU)(nchw(raw["semantics"]))
    _, lab, areas = InstanceEmbedder(args, CPU)(nchw(raw["instance_labels"]),
                                                nchw(raw["instance_areas"]))
    return sem, lab, areas


def jax_config(name, hw, seed, *extra, n=1):
    """args, the JAX model, its seeded (params, batch_stats), and an input
    batch of raw cue maps and an image, all numpy."""
    args = config_args(name, *extra)
    rng = np.random.default_rng(seed)
    raw = raw_cues(rng, n, hw, args.use_instance_segmentation)
    raw["image"] = rng.standard_normal((n, *hw, 3)).astype(np.float32)
    model = jax_build_model(args, dtype=jnp.float32)
    cues = jax.eval_shape(jax_embed(args), raw)
    params, stats = seeded_variables(model, [raw["image"].shape] + [c.shape for c in cues],
                                     seed)
    return args, model, params, stats, raw


def port_model(args, params, stats):
    model = build_model(args)
    model.load_state_dict(state_dict_from_flax(params, stats, args.encoder_name), strict=True)
    return model.eval()


# --- embedders -------------------------------------------------------------

def _labels(seed, shape=(2, 9, 11, 1)):
    """Labels across every table's range, with -1, -n - 1 and indices past
    the end, which `jnp.take` wraps or fills with NaN."""
    labels = np.random.default_rng(seed).integers(-160, 170, shape).astype(np.int32)
    labels.flat[:4] = [-1, 150, -151, 0]
    return labels


def _assert_same(got, want, what):
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)


@pytest.mark.parametrize("mode", SEMANTICS_MODES)
def test_semantics_embedder_matches_jax(mode):
    """Raw labels clamped alike, the gathered channels equal, NaN where JAX
    gives NaN; the per-class area channel (inst-areas) rtol 1e-6."""
    args = config_args("A", "--use_semantics", mode)
    labels = _labels(1)
    want_raw, want = (np.asarray(a) for a in JaxSemanticsEmbedder(args)(jnp.asarray(labels)))
    got_raw, got = SemanticsEmbedder(args, CPU)(nchw(labels))
    np.testing.assert_array_equal(got_raw.numpy().transpose(0, 2, 3, 1), want_raw)
    _assert_same(got, want, mode)
    got = got.numpy().transpose(0, 2, 3, 1)
    area = 25 if mode == "glove-25d-inst-areas" else None
    gathers = [c for c in range(want.shape[-1]) if c != area]
    np.testing.assert_array_equal(got[..., gathers], want[..., gathers])
    if area is not None:
        np.testing.assert_allclose(got[..., area], want[..., area], rtol=1e-6)
    if mode in ("glove", "glove-25d", "glove-25d-inst-areas"):
        assert np.isnan(got).any() and not np.isnan(got).all()


@pytest.mark.parametrize("mode", INSTANCE_MODES)
def test_instance_embedder_matches_jax(mode):
    args = config_args("A", "--use_instance_segmentation", mode)
    labels = _labels(2)
    areas = np.random.default_rng(3).integers(0, 5000, labels.shape).astype(np.int32)
    want = [np.asarray(a) for a in JaxInstanceEmbedder(args)(jnp.asarray(labels),
                                                             jnp.asarray(areas))]
    got = InstanceEmbedder(args, CPU)(nchw(labels), nchw(areas))
    for name, g, w in zip(("raw", "embedding", "areas"), got, want):
        _assert_same(g, w, f"{mode} {name}")
        np.testing.assert_array_equal(g.numpy().transpose(0, 2, 3, 1), w, err_msg=name)


def test_per_class_area_map_counts_like_jax():
    """-1 counts as the last class, out-of-range labels count nowhere and
    gather NaN, as `.at[].add` and `take_along_axis` do."""
    from mde_tpu.cues.embedders import per_class_area_map as jax_area_map
    from mde_tpu_torch.cues import per_class_area_map
    labels = _labels(4, (3, 17, 23))
    labels[1] = 7  # one class covers the whole image
    want = np.asarray(jax_area_map(jnp.asarray(labels), 150))[..., 0]
    got = per_class_area_map(torch.from_numpy(labels), 150)[:, 0].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isnan(got).any() and (got[1] == 1.0).all()


@pytest.mark.parametrize("semantics,instances,image", [
    (None, None, "rgb"), ("raw", None, "rgb"), ("glove", "coco", "rgb"),
    ("glove-25d", "ade20k_swin_human_sizes", "none"),
    ("glove-25d-inst-areas", "ade20k_swin_bbox", "rgb"),
    ("glove-25d-ade20k-places-human-sizes", "ade20k_swin_bbox_human_sizes", "rgb"),
    ("glove-25d-ade20k-places-random", "raw", "rgb")])
def test_num_channels_to_add_matches_jax(semantics, instances, image):
    for encoder in ("efficientnet-b1", "efficientnet-b1-noAdaBins"):
        assert (get_num_channels_to_add(encoder, semantics, instances, image)
                == jax_get_num_channels_to_add(encoder, semantics, instances, image))


def test_unsupported_semantics_mode_exits_as_in_jax():
    """one-hot-ade20k-places is named by one params file; neither package
    supports it."""
    for fn in (get_num_channels_to_add, jax_get_num_channels_to_add):
        with pytest.raises(SystemExit):
            fn("efficientnet-b1", "one-hot-ade20k-places", None, "rgb")


# --- the cue models --------------------------------------------------------

FORWARDS = {"A": ((320, 416), ()), "B": ((320, 416), ()),
            "A-image-none": ((320, 416), ("--image", "none")), "C": ((64, 96), ())}


def _from_a(name, params, stats):
    """A-image-none's and C's trees are A's with the stem's RGB inputs, or
    the AdaBins head and all but conv3's first output, taken away: tracing
    `init` again would cost seconds, and flax checks every shape in `apply`."""
    params = dict(params)
    if name == "A-image-none":
        enc = dict(params["encoder"])
        enc["conv_stem"] = {"kernel": enc["conv_stem"]["kernel"][:, :, 3:]}
        params["encoder"] = enc
    else:
        del params["adaptive_bins_layer"], params["conv_out"]
        dec = dict(params["decoder"])
        dec["conv3"] = {"kernel": dec["conv3"]["kernel"][..., :1],
                        "bias": dec["conv3"]["bias"][:1]}
        params["decoder"] = dec
    return params, stats


@pytest.fixture(scope="module")
def a_weights():
    _, _, params, stats, _ = jax_config("A", FORWARDS["A"][0], 11)
    return params, stats


@pytest.fixture(scope="module", params=list(FORWARDS))
def forward(request):
    """One configuration's JAX forward (jitted once) and the port's, on the
    same weights and raw maps, each side with its own embedders."""
    name = request.param
    hw, extra = FORWARDS[name]
    args = config_args(name[0], *extra)
    rng = np.random.default_rng(10 + len(name))
    raw = raw_cues(rng, 1, hw, args.use_instance_segmentation)
    raw["image"] = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    if name == "B":
        _, _, params, stats, _ = jax_config("B", hw, 12)
    else:
        params, stats = request.getfixturevalue("a_weights")
        if name != "A":
            params, stats = _from_a(name, params, stats)
    model = jax_build_model(args, dtype=jnp.float32)
    embed = jax_embed(args)
    want = jax.jit(lambda v, r: model.apply(v, r["image"], *embed(r), train=False))(
        {"params": params, "batch_stats": stats}, raw)
    port = port_model(args, params, stats)
    with torch.no_grad():
        got = port(nchw(raw["image"]), *port_cues(args, raw))
    return dict(name=name, args=args, params=params, stats=stats, port=port,
                want=want, got=got)


def test_cue_model_depth_matches_jax(forward):
    (_, want), (_, got) = forward["want"], forward["got"]
    h, w = FORWARDS[forward["name"]][0]
    assert got.shape == (1, 1, h // 2, w // 2)
    got = nhwc(got)
    assert np.all(np.isfinite(got)) and got.min() > 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=2e-3)


def test_cue_model_centers_match_jax(forward):
    (want, _), (got, _) = forward["want"], forward["got"]
    if forward["name"] == "C":
        assert want is None and got is None
        return
    assert got.shape == want.shape == (1, 257)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cue_model_widths(forward):
    """The stem and the mViT take the cue channels where they go in."""
    port = forward["port"]
    stem = port.encoder.original_model.conv_stem.weight.shape[1]
    want_stem, want_mvit = {"A": (73, 128), "B": (3, 198), "A-image-none": (70, 128),
                            "C": (73, None)}[forward["name"]]
    assert stem == want_stem
    mvit = getattr(port, "adaptive_bins_layer", None)
    assert (None if mvit is None else mvit.conv3x3.weight.shape[1]) == want_mvit


def test_state_dict_round_trips_through_reference_converter(forward, tmp_path):
    """state_dict_from_flax -> torch.save -> convert_reference_checkpoint gives
    the flax trees back exactly (CueMLPs, widened convs, no head for C)."""
    params, stats, args = forward["params"], forward["stats"], forward["args"]
    sd = state_dict_from_flax(params, stats, args.encoder_name)
    path = tmp_path / "cues.pt"
    torch.save({"model": sd}, path)
    back_params, back_stats = convert_reference_checkpoint(str(path), args.encoder_name)
    for want, got in ((params, back_params), (stats, back_stats)):
        want_leaves, want_def = jax.tree_util.tree_flatten(want)
        got_leaves, got_def = jax.tree_util.tree_flatten(got)
        assert got_def == want_def
        for a, b in zip(want_leaves, got_leaves):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
