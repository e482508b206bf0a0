"""Port parity, the detector's parts: mde_tpu_torch.offline's Swin, checkpoint
loader and host functions against mde_tpu.offline (CPU, float32).

A narrow Swin (embed 32, depths (2, 2, 2, 2)) on a frame that is no
multiple of the window or the patch is seeded through the JAX package's
`convert_swin_backbone` from the port's state_dict (no JAX init), every key
read: its four maps within 1e-4 absolute (LayerNorm outputs, O(1)).
`load_detector` reads an mmdet-layout checkpoint (with mmdet's index
buffers and BatchNorm counters) exactly and refuses a renamed key or a
wrong index, naming it; a table of another window is resized as
`resize_rel_pos_table`. `paste_masks` and `collapse_detections` are numpy
on both sides: equal. Two pins: the LayerNorm eps (flax's 1e-6, not mmdet's
1e-5), and the two mappings of `convert_detector` that differ from mmdet's
layout (the bbox heads' flatten order, the mask upsample's kernel flip).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.offline import cascade_rcnn as jax_rcnn
from mde_tpu.offline.swin import SwinTransformer as JaxSwin
from mde_tpu.offline.swin_convert import convert_swin_backbone
from mde_tpu_torch.offline import cascade_rcnn, swin
from mde_tpu_torch.offline.layers import LayerNorm, seeded

torch.set_num_threads(2)

NARROW_DEPTHS = (2, 2, 2, 2)


class _Recording(dict):
    def __init__(self, *a, read):
        super().__init__(*a)
        self.read = read

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def test_narrow_swin_matches_jax_off_window_multiples():
    kw = dict(embed_dim=32, depths=NARROW_DEPTHS, num_heads=(2, 4, 8, 16))
    model = seeded(lambda: swin.SwinTransformer(**kw), 1).eval()
    with torch.no_grad():  # position bias and norms away from their init
        g = torch.Generator().manual_seed(2)
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, swin.WindowAttention):
                m.relative_position_bias_table.normal_(0, 1.0, generator=g)
    read = set()
    sd = _Recording({"backbone." + k: v for k, v in model.state_dict().items()}, read=read)
    params = convert_swin_backbone(sd, depths=kw["depths"])
    assert read == set(sd), "keys convert_swin_backbone never reads"
    x = np.random.default_rng(3).standard_normal((1, 62, 90, 3), dtype=np.float32)  # not /4
    jmodel = JaxSwin(dtype=jnp.float32, **kw)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[-2:]) for g in got] == [(16, 23), (8, 12), (4, 6), (2, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), rtol=0,
                                   atol=1e-4)


def test_layernorm_eps_is_flax_not_mmdet():
    """The JAX package's Swin norms are flax's default LayerNorm (eps 1e-6);
    mmdet's are torch's (1e-5). The port follows the JAX package."""
    assert nn.LayerNorm().epsilon == 1e-6
    model = swin.SwinTransformer(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16))
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 8 + 3 + 4 + 1 and all(m.eps == 1e-6 for m in norms)


def test_reference_converter_layout_differences_are_pinned():
    """What `_to_jax_layout` undoes: flax's ConvTranspose with the converter's
    kernel is torch's with the kernel flipped, and flax's Dense reads the roi
    features flattened (H, W, C)."""
    from mde_tpu.offline.swin_convert import _deconv
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 5, 6), dtype=np.float32)
    up = torch.nn.ConvTranspose2d(6, 3, 2, 2)
    sd = {"u.weight": up.weight.detach(), "u.bias": up.bias.detach()}
    flax_up = nn.ConvTranspose(3, (2, 2), strides=(2, 2))
    raw = np.asarray(flax_up.apply({"params": _deconv(sd, "u")}, x))
    with torch.no_grad():
        plain = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        up.weight.copy_(torch.flip(up.weight, dims=(2, 3)))
        flipped = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(raw, flipped, rtol=1e-5, atol=1e-5)
    assert np.abs(raw - plain).max() > 1e-2
    feats = rng.standard_normal((2, 7, 7, 3), dtype=np.float32)  # NHWC
    w = rng.standard_normal((5, 3 * 7 * 7), dtype=np.float32)    # mmdet: (C, H, W) columns
    mmdet = feats.transpose(0, 3, 1, 2).reshape(2, -1) @ w.T
    flax_dense = feats.reshape(2, -1) @ w.T                       # what the converter wires
    fixed = feats.reshape(2, -1) @ w.reshape(5, 3, 7, 7).transpose(0, 2, 3, 1).reshape(5, -1).T
    np.testing.assert_allclose(fixed, mmdet, rtol=1e-5, atol=1e-4)
    assert np.abs(flax_dense - mmdet).max() > 1e-1


def _load(tmp_path, sd, **kw):
    """load_detector of `sd` written as an mmdet file, the file removed after
    (each is ~350 MB)."""
    path = tmp_path / "checkpoint.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    try:
        return cascade_rcnn.load_detector(str(path), depths=NARROW_DEPTHS, **kw)
    finally:
        path.unlink()


def test_load_detector_reads_mmdet_checkpoints_and_refuses_bad_ones(tmp_path):
    """On the Swin-B widths at depths (2, 2, 2, 2)."""
    model = seeded(lambda: cascade_rcnn.CascadeMaskRCNN(depths=NARROW_DEPTHS), 2).eval()
    sd = dict(model.state_dict())
    # an mmdet file also holds the index buffers and BN counters
    for s, depth in enumerate(NARROW_DEPTHS):
        for b in range(depth):
            sd[f"backbone.layers.{s}.blocks.{b}.attn.relative_position_index"] = torch.from_numpy(
                swin.relative_position_index(7))
    sd["roi_head.bbox_head.0.shared_convs.0.bn.num_batches_tracked"] = torch.tensor(3)
    loaded = _load(tmp_path, sd)
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert loaded.num_classes == 100
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3, 32, 32), np.float32))
    with torch.no_grad():
        for a, b in zip(loaded.backbone(x), model.backbone(x)):
            assert torch.equal(a, b)
    bad = dict(sd)
    bad["neck.fpn_convs.3.weight"] = bad.pop("neck.fpn_convs.3.conv.weight")
    with pytest.raises(KeyError, match=r"neck\.fpn_convs\.3\.conv\.weight.*"
                                       r"neck\.fpn_convs\.3\.weight"):
        _load(tmp_path, bad)
    bad = dict(sd)
    bad["backbone.layers.0.blocks.1.attn.relative_position_index"] = torch.zeros(49, 49)
    with pytest.raises(ValueError, match="relative_position_index"):
        _load(tmp_path, bad)
    # a window-12 table into window 7: resized as resize_rel_pos_table does
    table = torch.randn(23 * 23, 4, generator=torch.Generator().manual_seed(6))
    sd["backbone.layers.0.blocks.0.attn.relative_position_bias_table"] = table
    with pytest.raises(RuntimeError, match="size mismatch"):
        _load(tmp_path, sd)
    resized = _load(tmp_path, sd, window_size=7)
    np.testing.assert_array_equal(
        resized.backbone.layers[0].blocks[0].attn.relative_position_bias_table.detach().numpy(),
        swin.resize_rel_pos_table(table.numpy(), 13 * 13))


def _fake_detections(rng, n=12, hw=(60, 80)):
    h, w = hw
    boxes = np.concatenate([rng.uniform(-10, [w, h], (n, 2))] * 2, 1)
    boxes[:, 2:] += rng.uniform(0.3, 40, (n, 2))
    boxes[0] = [w - 0.5, 3, w + 30, 20]   # past the edge: nothing pasted
    return {"boxes": boxes.astype(np.float32),
            "masks28": rng.uniform(0, 1, (n, 28, 28)).astype(np.float32),
            "valid": rng.uniform(size=n) > 0.2,
            "labels": rng.integers(0, 5, n).astype(np.int32),
            "scores": rng.uniform(size=n).astype(np.float32)}


@pytest.mark.parametrize("use_bbox_area", [False, True])
def test_paste_masks_and_collapse_equal_jax(use_bbox_area):
    det = _fake_detections(np.random.default_rng(7))
    want = jax_rcnn.paste_masks(det, 60, 80)
    got = cascade_rcnn.paste_masks(det, 60, 80)
    np.testing.assert_array_equal(got, want)
    assert want[det["valid"]].any(axis=(1, 2)).sum() >= 5
    for a, b in zip(cascade_rcnn.collapse_detections(det, got, 60, 80, use_bbox_area),
                    jax_rcnn.collapse_detections(det, want, 60, 80, use_bbox_area)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
