"""The offline CLIs' file handling, with the model call replaced:
`python -m mde_tpu_torch.offline.generate_semantics` and
`generate_instances` against the rules of `scripts/generate_semantics.py`
and `scripts/generate_instances.py` (CPU).

Each CLI walks rgb_*.jpg recursively, writes beside each frame under the
name with every "rgb" replaced, keeps an existing output unless
--overwrite, and writes the formats the dataset reads: uint8 .npy
semantics; ade20k .npz instance maps (labels 0..99, background -1), an npz
holding the object None when nothing is valid; coco .npy maps (background
0, classes 1..80). The detections go through the JAX package's
`paste_masks` and `collapse_detections` beside the port's: the written maps
are equal. The per-class (area, depth mean, depth std) pickle reads the
depth PNGs. `mde_tpu_torch.data.dataset` finds and loads every file
written. `--device cuda` without a card is an error.
"""

import pickle
import types

import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.offline import cascade_rcnn as jax_rcnn
from mde_tpu_torch.data import dataset
from mde_tpu_torch.offline import generate_instances, generate_semantics

HW = (30, 40)
FRAMES = ["scene_a/rgb_00001.jpg", "scene_a/rgb_00002.jpg", "scene_b/deep/rgb_00007.jpg"]
N_VALID = (5, 0, 4)  # detections a frame; the second has none valid
_VALID_BY_FRAME = {}  # decoded frame bytes -> (seed, valid count)


@pytest.fixture
def tree(tmp_path):
    rng = np.random.default_rng(0)
    for i, name in enumerate(FRAMES):
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(path)
        decoded = np.asarray(Image.open(path).convert("RGB"))
        _VALID_BY_FRAME[decoded.tobytes()] = (i, N_VALID[i])
        depth = rng.integers(500, 9000, HW).astype(np.uint16)
        Image.fromarray(depth).save(str(path).replace("rgb", "sync_depth").replace(".jpg", ".png"))
    (tmp_path / "scene_b" / "not_a_frame.jpg").write_bytes(b"")
    return tmp_path


def _fake_segment(model, img):
    assert model == "hrnet"
    return ((img[..., 0] * 255).astype(np.int32) % 150).astype(np.int32)


def test_semantics_cli_walk_names_skip_and_overwrite(tree, monkeypatch):
    monkeypatch.setattr(generate_semantics, "build_model", lambda args, device: "hrnet")
    monkeypatch.setattr(generate_semantics, "segment", _fake_segment)
    argv = ["--images", str(tree), "--random-init", "0", "--device", "cpu"]
    generate_semantics.main(argv)
    outs = sorted(p.relative_to(tree).as_posix() for p in tree.rglob("semantic_seg_*.npy"))
    assert outs == sorted(f.replace("rgb", "semantic_seg").replace(".jpg", ".npy")
                          for f in FRAMES)
    first = tree / "scene_a" / "semantic_seg_00001.npy"
    seg = np.load(first)
    img = np.asarray(Image.open(tree / FRAMES[0]), np.float32) / 255.0
    assert seg.dtype == np.uint8 and seg.shape == HW
    np.testing.assert_array_equal(seg, _fake_segment("hrnet", img).astype(np.uint8))
    np.save(first, np.zeros(HW, np.uint8))
    generate_semantics.main(argv)  # kept
    assert not np.load(first).any()
    generate_semantics.main(argv + ["--overwrite"])
    np.testing.assert_array_equal(np.load(first), seg)


def test_cli_refusals():
    with pytest.raises(SystemExit):
        generate_semantics.parse_args(["--images", "x"])
    with pytest.raises(SystemExit):
        generate_instances.parse_args(["--images", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_semantics.device_of("cuda")


def _fake_detections(seed, h, w, n_valid):
    rng = np.random.default_rng(seed)
    n = 8
    xy = rng.uniform(-5, [w, h], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 25, (n, 2))], 1).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return {"boxes": boxes, "scores": rng.uniform(size=n).astype(np.float32),
            "labels": rng.integers(0, 80, n).astype(np.int64), "valid": valid,
            "masks28": rng.uniform(size=(n, 28, 28)).astype(np.float32)}


def _fake_detect(model, img):
    """The frame's own detections (N_VALID of them valid)."""
    seed, n_valid = _VALID_BY_FRAME[img.tobytes()]
    return _fake_detections(seed, *img.shape[:2], n_valid)


def _jax_maps(det, coco, bbox):
    masks = jax_rcnn.paste_masks(det, *HW)
    if coco:
        lab, area = jax_rcnn.collapse_detections(dict(det, labels=det["labels"] + 1), masks,
                                                 *HW, use_bbox_area=bbox)
        return np.where(lab < 0, 0, lab), area
    return jax_rcnn.collapse_detections(det, masks, *HW, use_bbox_area=bbox)


@pytest.mark.parametrize("classes,bbox", [("ade20k", False), ("ade20k", True), ("coco", False)])
def test_instances_cli_outputs_equal_the_scripts_rules(tree, monkeypatch, classes, bbox):
    monkeypatch.setattr(generate_instances, "build_detector", lambda args, device: "detector")
    monkeypatch.setattr(generate_instances, "detect", _fake_detect)
    stats = tree / "stats.pkl"
    argv = ["--images", str(tree), "--random-init", "0", "--device", "cpu", "--classes", classes,
            "--depths", str(tree), "--stats-out", str(stats)] + (["--bbox-areas"] if bbox else [])
    generate_instances.main(argv)
    coco = classes == "coco"
    tag = "coco" if coco else ("ade20k_swin_bbox" if bbox else "ade20k_swin")
    ext = ".npy" if coco else ".npz"
    points = pickle.load(open(stats, "rb"))
    assert len(points) == (80 if coco else 100) + 1
    want_points = [[] for _ in points]
    empty = 0
    for name in FRAMES:
        img = np.asarray(Image.open(tree / name).convert("RGB"))
        det = _fake_detect(None, img)
        paths = [tree / name.replace("rgb", f"instance_{kind}_{tag}").replace(".jpg", ext)
                 for kind in ("labels", "areas")]
        want = _jax_maps(det, coco, bbox)
        for path, w in zip(paths, want):
            if coco:
                got = np.load(path)
            else:
                got = np.load(path, allow_pickle=True)["arr_0"]
            if not coco and not det["valid"].any():
                assert got.dtype == object and got.item() is None
                empty += 1
                continue
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, w)
        depth = np.asarray(Image.open(str(tree / name).replace("rgb", "sync_depth")
                                      .replace(".jpg", ".png")), np.float32) / 1000.0
        masks = jax_rcnn.paste_masks(det, *HW)
        for i in np.flatnonzero(det["valid"]):
            if masks[i].any():
                want_points[int(det["labels"][i])].append(
                    [int(masks[i].sum()), float(depth[masks[i]].mean()),
                     float(depth[masks[i]].std())])
    assert points == want_points and sum(map(len, points)) > 0
    assert coco or empty == 2  # one frame with nothing valid: both its files hold None
    first = paths[0]
    before = first.read_bytes()
    first.write_bytes(b"stale")
    generate_instances.main(argv)  # both files exist: kept
    assert first.read_bytes() == b"stale"
    generate_instances.main(argv + ["--overwrite"])
    assert first.read_bytes() == before


def test_dataset_reads_what_the_clis_write(tree, monkeypatch):
    monkeypatch.setattr(generate_semantics, "build_model", lambda args, device: "hrnet")
    monkeypatch.setattr(generate_semantics, "segment", _fake_segment)
    monkeypatch.setattr(generate_instances, "build_detector", lambda args, device: "detector")
    monkeypatch.setattr(generate_instances, "detect", _fake_detect)
    base = ["--images", str(tree), "--random-init", "0", "--device", "cpu"]
    generate_semantics.main(base)
    generate_instances.main(base)
    generate_instances.main(base + ["--classes", "coco"])
    lines = [f"/{f} /{f.replace('rgb', 'sync_depth').replace('.jpg', '.png')} 518.8579"
             for f in FRAMES]
    (tree / "train.txt").write_text("\n".join(lines) + "\n")
    for mode in ("ade20k_swin", "coco"):
        args = types.SimpleNamespace(
            dataset="nyu", data_path=str(tree), gt_path=str(tree),
            filenames_file=str(tree / "train.txt"), use_semantics="glove-25d",
            use_instance_segmentation=mode, do_kb_crop=False)
        ds = dataset.DepthDataset(args, "train")
        for i, name in enumerate(FRAMES):
            image = str(tree / name)
            paths = dataset._derive_side_paths(image, args)
            img = np.asarray(Image.open(image).convert("RGB"))
            sem = dataset._load_label_map(paths["semantics"], HW, -1)
            np.testing.assert_array_equal(sem, _fake_segment(
                "hrnet", img.astype(np.float32) / 255.0).astype(np.uint8))
            labels = dataset._load_label_map(paths["instance_labels"], HW, -1)
            det = _fake_detect(None, img)
            if mode == "ade20k_swin" and not det["valid"].any():
                assert (labels == -1).all()  # the None file's fallback
            else:
                np.testing.assert_array_equal(labels, _jax_maps(det, mode == "coco", False)[0])
            raw = ds.load_raw_train(i)
            assert raw["semantics"].dtype == raw["instance_labels"].dtype == np.int32
