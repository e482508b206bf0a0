"""Port parity, offline evaluation and the three training/evaluation CLIs:
`python -m mde_tpu_torch.offline.{train_detector, eval_detector,
eval_semseg}` against `scripts/{train_detector, eval_detector,
eval_semseg}.py` and the JAX package's numpy functions (CPU).

* `DetectionEvaluator.summarize` equals JAX's on random detections with
  masks (NaN where a class has no GT alike), and `intersection_and_union`
  equals JAX's.
* Each CLI takes the script's flags and --device.
* eval_detector and eval_semseg with the model call replaced (a frame's
  detections or class map made from its pixels): the printed metrics equal
  what the scripts' loops compute with the JAX package's `paste_masks`,
  `DetectionEvaluator`, `intersection_and_union` and `color_encode` on
  Pillow's decode, and --result-dir's RGB grids equal the script's
  img | gt | pred arrays.
* train_detector runs 2 steps of the seeded full-width detector (bf16,
  use_checkpoint) at --fixed-scale 64,96 on a 2-image tree, its step given
  64 rois a stage (the card runs the CLI's 512, chip_smoke.py phase 11): the samples it
  trains on are the JAX script's sequence under the same seed (its init
  sample, then each epoch's permutation), every printed loss is finite, and
  the mmdet-layout checkpoint loads strictly through `load_detector`.
"""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.offline import cascade_rcnn as jax_rcnn
from mde_tpu.offline import coco_dataset as jax_coco
from mde_tpu.offline import detection_data as jax_data
from mde_tpu.offline import detection_eval as jax_eval
from mde_tpu.ops import metrics as jax_metrics
from mde_tpu.utils import graphs as jax_graphs
from mde_tpu_torch.ops.metrics import intersection_and_union
from mde_tpu_torch.offline import eval_detector, eval_semseg, train_detector
from mde_tpu_torch.offline.cascade_rcnn import load_detector
from mde_tpu_torch.offline.detection_eval import DetectionEvaluator

torch.set_num_threads(4)
REPO = Path(__file__).resolve().parent.parent
HW = (48, 64)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or got[k] == want[k], k


def test_detection_evaluator_equals_jax():
    rng = np.random.default_rng(0)
    ours, theirs = DetectionEvaluator(6, with_masks=True), jax_eval.DetectionEvaluator(
        6, with_masks=True)
    for _ in range(4):
        g, d = int(rng.integers(2, 7)), int(rng.integers(0, 12))
        xy = rng.uniform(0, 40, (g, 2))
        gt_boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (g, 2))], 1)
        det_boxes = gt_boxes[rng.integers(0, g, d)] + rng.normal(0, 2, (d, 4))
        gts = {"boxes": gt_boxes, "labels": rng.integers(0, 4, g),
               "masks": rng.random((g, 24, 32)) < 0.3}
        dets = {"boxes": det_boxes, "scores": rng.random(d), "labels": rng.integers(0, 5, d),
                "masks": rng.random((d, 24, 32)) < 0.3}
        ours.add_image(dets, gts)
        theirs.add_image(dets, gts)
    got = ours.summarize()
    _same(got, theirs.summarize())
    assert set(got) == {"bbox_mAP", "bbox_mAP50", "segm_mAP", "segm_mAP50"}
    assert 0 < got["bbox_mAP50"] <= 1


def test_intersection_and_union_equals_jax():
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 12, (37, 53))
    label = rng.integers(-1, 12, (37, 53))
    for got, want in zip(intersection_and_union(pred, label, 12),
                         jax_metrics.intersection_and_union(pred, label, 12)):
        np.testing.assert_array_equal(got, want)


def _script_flags(name, capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr("sys.argv", [name, "--help"])
    with pytest.raises(SystemExit):
        module.main()
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


@pytest.mark.parametrize("name,module", [("train_detector", train_detector),
                                         ("eval_detector", eval_detector),
                                         ("eval_semseg", eval_semseg)])
def test_cli_flags_are_the_scripts(name, module, capsys, monkeypatch):
    want = _script_flags(name, capsys, monkeypatch)
    with pytest.raises(SystemExit):
        module.parse_args(["--help"])
    assert set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out)) == want | {"--device"}


def _coco_tree(root, n_images, hw):
    rng = np.random.default_rng(2)
    images, anns = [], []
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(root / f"{i}.jpg")
        images.append({"id": i, "file_name": f"{i}.jpg", "height": hw[0], "width": hw[1]})
        for j in range(3):
            x, y = rng.uniform(0, [hw[1] - 20, hw[0] - 20])
            bw, bh = rng.uniform(8, 20, 2)
            ann = {"id": 10 * i + j, "image_id": i, "category_id": int(rng.integers(1, 4)),
                   "bbox": [x, y, bw, bh], "iscrowd": 0}
            if j != 2:
                ann["segmentation"] = [[x, y, x + bw, y + 0.3 * bh, x + 0.6 * bw, y + bh]]
            anns.append(ann)
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": str(c)} for c in (1, 2, 3)]}))
    return ann_file


def _fake_det(img):
    """Detections drawn from the frame's pixels, in its coordinates."""
    rng = np.random.default_rng(int(img.sum()) % 1000)
    h, w = img.shape[:2]
    xy = rng.uniform(0, [w - 10, h - 10], (10, 2))
    return {"boxes": np.concatenate([xy, xy + rng.uniform(4, 20, (10, 2))], 1).astype(np.float32),
            "scores": rng.uniform(size=10).astype(np.float32),
            "labels": rng.integers(0, 3, 10), "valid": np.arange(10) < 8,
            "masks28": rng.uniform(size=(10, 28, 28)).astype(np.float32)}


def test_eval_detector_cli_equals_the_scripts_loop(tmp_path, monkeypatch, capsys):
    ann_file = _coco_tree(tmp_path, 3, HW)
    monkeypatch.setattr(eval_detector, "build_detector", lambda args, device: "detector")
    monkeypatch.setattr(eval_detector, "detect", lambda model, img, *a: _fake_det(img))
    got = eval_detector.main(["--images", str(tmp_path), "--annotations", str(ann_file),
                              "--checkpoint", "x.pth", "--num-classes", "3", "--score-thr", "0.3",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    ds = jax_coco.CocoInstanceDataset(str(tmp_path), str(ann_file))
    ev = jax_eval.DetectionEvaluator(3, with_masks=True)
    for i in range(len(ds)):
        img, gt_boxes, gt_labels, gt_masks = ds[i]
        det = _fake_det(img)
        keep = det["valid"] & (det["scores"] > 0.3)
        masks_full = jax_rcnn.paste_masks(det, *img.shape[:2])
        ev.add_image({"boxes": det["boxes"][keep], "scores": det["scores"][keep],
                      "labels": det["labels"][keep], "masks": masks_full[keep]},
                     {"boxes": gt_boxes, "labels": gt_labels, "masks": gt_masks})
    want = ev.summarize()
    _same(got, want)
    assert "evaluating 3 images" in out
    for k, v in want.items():
        assert f"{k}: {v:.4f}" in out


def _fake_segment(model, img):
    return ((img[..., 0] * 255).astype(np.int64) * 7 + (img[..., 1] * 255).astype(np.int64)) % 150


def test_eval_semseg_cli_equals_the_scripts_loop(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(tmp_path / f"f{i}.jpg")
        Image.fromarray(rng.integers(0, 151, HW).astype(np.uint8)).save(tmp_path / f"f{i}.png")
        lines.append(json.dumps({"fpath_img": f"f{i}.jpg", "fpath_segm": f"f{i}.png"}))
    (tmp_path / "val.odgt").write_text("\n".join(lines) + "\n")
    monkeypatch.setattr(eval_semseg, "build_model", lambda args, device: "hrnet")
    monkeypatch.setattr(eval_semseg, "segment", _fake_segment)
    result = tmp_path / "vis"
    got = eval_semseg.main(["--odgt", str(tmp_path / "val.odgt"), "--root", str(tmp_path),
                            "--encoder-ckpt", "e.pth", "--decoder-ckpt", "d.pth",
                            "--result-dir", str(result), "--device", "cpu"])
    out = capsys.readouterr().out
    inter_sum, union_sum, acc_sum, pix_sum = np.zeros(150), np.zeros(150), 0.0, 0.0
    colors = jax_graphs.load_color150()
    for i in range(3):
        img = np.asarray(Image.open(tmp_path / f"f{i}.jpg").convert("RGB"), np.float32) / 255.0
        segm = np.asarray(Image.open(tmp_path / f"f{i}.png"), dtype=np.int64) - 1
        pred = _fake_segment(None, img)
        valid = segm >= 0
        acc_sum += float(np.sum((pred == segm) & valid))
        pix_sum += float(np.sum(valid))
        inter, union = jax_metrics.intersection_and_union(pred, segm, 150)
        inter_sum += inter
        union_sum += union
        vis = np.concatenate([(img * 255).astype(np.uint8), jax_graphs.color_encode(segm, colors),
                              jax_graphs.color_encode(pred, colors)], axis=1)
        written = Image.open(result / f"f{i}.png")
        assert written.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(written), vis)
    iou = np.full(150, np.nan)
    iou[union_sum > 0] = inter_sum[union_sum > 0] / union_sum[union_sum > 0]
    np.testing.assert_array_equal(got["iou"], iou)
    assert got["mIoU"] == np.nanmean(iou) and got["accuracy"] == 100.0 * acc_sum / pix_sum
    assert f"Mean IoU: {np.nanmean(iou):.4f}, Accuracy: {100.0 * acc_sum / pix_sum:.2f}%" in out
    assert f"class [7], IoU: {iou[7]:.4f}" in out


def test_train_detector_two_steps_and_its_checkpoint(tmp_path, monkeypatch, capsys):
    ann_file = _coco_tree(tmp_path, 2, HW)
    seen = []
    real_step = train_detector.train_step

    def step(model, opt, sched, sample, uniform):
        seen.append(sample)
        # 64 rois a stage, not the CLI's 512: the mask heads' convolutions
        # over 512 rois of 14x14 take ~20 s a bf16 step on this CPU
        return real_step(model, opt, sched, sample, uniform, num_samples=64)

    monkeypatch.setattr(train_detector, "train_step", step)
    out_dir = tmp_path / "run"
    model = train_detector.main([
        "--images", str(tmp_path), "--annotations", str(ann_file), "--num-classes", "3",
        "--epochs", "3", "--max-steps", "2", "--fixed-scale", "64,96", "--log-every", "1",
        "--max-gt", "8", "--out", str(out_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    totals = [float(v) for v in re.findall(r"total (\S+) rpn", out)]
    assert len(totals) == 2 and np.isfinite(totals).all(), out
    # the JAX script's sample sequence: its init sample, then the permutation
    monkeypatch.setattr(jax_data, "SCALES_MAIN", [(64, 96)])
    monkeypatch.setattr(jax_data, "SCALES_PRE_CROP", [(64, 96)])
    monkeypatch.setattr(jax_data, "CROP_RANGE", (64, 64))
    jds = jax_coco.CocoInstanceDataset(str(tmp_path), str(ann_file))
    rng = np.random.default_rng(0)
    jds.train_sample(rng, 0, max_gt=8)
    want = [jds.train_sample(rng, int(i), max_gt=8) for i in rng.permutation(2)]
    assert len(seen) == 2
    for got, w in zip(seen, want):
        for k in w:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w[k]), err_msg=k)
    # the checkpoint is ~1.7 GB (weights and AdamW state): removed as soon as
    # it is read, so parallel test workers do not fill the disk
    path = out_dir / "detector_latest.pth"
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        assert set(ckpt) == {"state_dict", "optimizer", "meta"}
        assert ckpt["meta"] == {"epoch": 1, "iter": 2}
        del ckpt
        loaded = load_detector(str(path))
    finally:
        path.unlink()
    assert loaded.num_classes == 3
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_train_detector_pretrained_warm_start(tmp_path, capsys):
    """--pretrained: an mmdet file with every key warm-starts the detector
    (its weights, float32, in training mode); a file that lacks keys keeps
    the seeded initialisation and says why, as the JAX script does."""
    from mde_tpu_torch.offline.cascade_rcnn import CascadeMaskRCNN
    from mde_tpu_torch.offline.layers import seeded
    source = seeded(lambda: CascadeMaskRCNN(3), 5).state_dict()
    full, partial = tmp_path / "full.pth", tmp_path / "partial.pth"
    torch.save({"state_dict": {k: source[k] for k in list(source)[:4]}}, partial)
    args = train_detector.parse_args(["--images", ".", "--annotations", "x.json",
                                      "--num-classes", "3", "--device", "cpu",
                                      "--pretrained", str(partial)])
    model = train_detector.build_detector(args, torch.device("cpu"))
    assert "partial checkpoint" in capsys.readouterr().out and model.training
    seeded0 = seeded(lambda: CascadeMaskRCNN(3), 0).state_dict()
    assert all(torch.equal(v, seeded0[k]) for k, v in model.state_dict().items())
    torch.save({"state_dict": source}, full)  # ~580 MB: removed once read
    try:
        args.pretrained = str(full)
        model = train_detector.build_detector(args, torch.device("cpu"))
    finally:
        full.unlink()
    assert "warm-started" in capsys.readouterr().out
    assert all(torch.equal(v, source[k]) for k, v in model.state_dict().items())
    assert model.backbone.patch_embed.proj.weight.dtype == torch.float32
