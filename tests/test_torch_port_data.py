"""Port parity, the data slice: mde_tpu_torch.data and mde_tpu_torch.config
against PIL and mde_tpu (CPU).

* Decode: the port's own JPEG and PNG decoders (csrc/mdeaug.cpp) equal PIL's
  decode bit for bit (`np.array_equal`): the repo's NYU frame (its SHA-256
  is pinned here and in chip_smoke.py, whose machine has no PIL), random
  JPEGs at 4:2:0, 4:2:2 and 4:4:4, with optimized tables and with restart
  markers, 8- and 16-bit grayscale PNGs and an 8-bit RGB PNG (a KITTI
  frame's format); `read_rgb` of grey JPEG and grey, grey-alpha and RGBA
  PNG equals PIL's `convert("RGB")`, other kinds raise by name;
  `write_png` (grey and RGB) round-trips through PIL.
* Loader: with the same args and seed, the port's DepthDataLoader gives
  mde_tpu.data's batches for the first two batches of two epochs: integer
  maps and depth (derived from uint16) exactly, images to rtol 1e-6. Cases:
  NYU train on the numpy and the native path, NYU with semantics (.npy) and
  ade20k instances (.npz, one with no predictions) on both paths, KITTI with
  do_kb_crop and use_right on both paths, and online_eval with one missing
  GT (NYU) and KITTI's kb crop; `load_raw_train` and `augment_batch` (the
  two-step native route) exactly. A file the loader cannot read raises.
* Parser: `vars(parse_cli(...))` equals JAX's, less the port's --device, for
  every params/*.txt.
"""

import glob
import hashlib
import os
import types

import numpy as np
import pytest
from PIL import Image

from mde_tpu.config import parsers as jax_parsers
from mde_tpu.data import DepthDataLoader as JaxDepthDataLoader
from mde_tpu.data.native import get_lib as jax_native_lib
from mde_tpu_torch.config import parsers
from mde_tpu_torch.data import DepthDataLoader, decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSROOM = os.path.join(REPO, "test_imgs", "classroom__rgb_00283.jpg")
# SHA-256 of PIL's decode of the frame above, (480, 640, 3) uint8 bytes
CLASSROOM_SHA256 = "fc05530ffb6b5028a13461478c4a7a6af573e4c652eb3304c516b1bd02bef062"


# --- decode ----------------------------------------------------------------

def test_classroom_frame_decodes_as_pil():
    got = decode.read_rgb(CLASSROOM)
    want = np.asarray(Image.open(CLASSROOM))
    assert got.dtype == np.uint8 and got.shape == (480, 640, 3)
    assert np.array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == CLASSROOM_SHA256
    assert decode.image_size(CLASSROOM) == Image.open(CLASSROOM).size


JPEG_CASES = {  # size, PIL save options
    "420_q75": ((37, 53), {}),
    "420_q95_odd": ((61, 9), dict(quality=95)),
    "422": ((40, 71), dict(subsampling=1)),
    "444": ((33, 47), dict(subsampling=0, quality=90)),
    "optimized": ((48, 64), dict(optimize=True)),
    "restarts": ((50, 70), dict(quality=85, restart_marker_blocks=1)),
    "tiny": ((3, 2), {}),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_random_jpeg_decodes_as_pil(tmp_path, case):
    (h, w), options = JPEG_CASES[case]
    rng = np.random.default_rng(len(case))
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(3 * yy + xx) % 256, (5 * xx) % 256, (7 * yy + 2 * xx) % 256], -1)
    image = np.where(rng.random((h, w, 1)) < 0.5, noise, smooth).astype(np.uint8)
    path = tmp_path / "x.jpg"
    Image.fromarray(image).save(path, **options)
    assert np.array_equal(decode.read_rgb(path), np.asarray(Image.open(path)))
    assert decode.image_size(path) == (w, h)


@pytest.mark.parametrize("dtype,shape", [(np.uint16, (37, 53)), (np.uint8, (20, 31)),
                                         (np.uint8, (33, 17, 3)), (np.uint16, (1, 1))],
                         ids=["gray16", "gray8", "rgb8", "gray16_1px"])
def test_png_decodes_as_pil(tmp_path, dtype, shape):
    rng = np.random.default_rng(3)
    array = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    path = tmp_path / "x.png"
    Image.fromarray(array).save(path)
    got = decode.read_png(path) if len(shape) == 2 else decode.read_rgb(path)
    assert got.shape == shape
    assert np.array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_write_png_reads_back_in_pil(tmp_path, dtype):
    array = np.random.default_rng(4).integers(0, np.iinfo(dtype).max, (19, 23)).astype(dtype)
    path = tmp_path / "x.png"
    decode.write_png(path, array)
    assert np.array_equal(np.asarray(Image.open(path)), array)
    assert np.array_equal(decode.read_png(path), array)


def test_write_png_rgb_reads_back_in_pil(tmp_path):
    array = np.random.default_rng(4).integers(0, 256, (19, 23, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    decode.write_png(path, array)
    assert Image.open(path).mode == "RGB"
    assert np.array_equal(np.asarray(Image.open(path)), array)
    assert np.array_equal(decode.read_rgb(path), array)


@pytest.mark.parametrize("mode,ext", [("L", "jpg"), ("L", "png"), ("LA", "png"), ("RGBA", "png")])
def test_read_rgb_converts_as_pil(tmp_path, mode, ext):
    """Grey JPEG (one component) and grey, grey-alpha and RGBA PNG come out
    as PIL's `Image.open(path).convert("RGB")`, bit for bit."""
    rng = np.random.default_rng(6)
    channels = len(mode)
    pix = rng.integers(0, 256, (27, 41, channels), dtype=np.uint8)
    yy, xx = np.mgrid[:27, :41]
    pix[..., 0] = np.where(rng.random((27, 41)) < 0.5, pix[..., 0], (5 * yy + 3 * xx) % 256)
    path = tmp_path / f"x.{ext}"
    Image.fromarray(pix[..., 0] if channels == 1 else pix, mode).save(path)
    got = decode.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (27, 41, 3)
    assert np.array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_read_rgb_refuses_other_kinds_by_name(tmp_path):
    """A 16-bit grayscale PNG and a palette PNG raise, naming the file."""
    Image.fromarray(np.zeros((4, 5), np.uint16)).save(tmp_path / "deep.png")
    Image.fromarray(np.zeros((4, 5), np.uint8)).convert("P").save(tmp_path / "pal.png")
    for name in ("deep.png", "pal.png"):
        with pytest.raises(IOError, match=name):
            decode.read_rgb(tmp_path / name)


def test_unreadable_files_raise(tmp_path):
    """A missing file, a progressive JPEG and a truncated PNG raise IOError
    with the decoder's message."""
    with pytest.raises(IOError, match="cannot open"):
        decode.read_rgb(tmp_path / "missing.jpg")
    image = np.random.default_rng(5).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    Image.fromarray(image).save(tmp_path / "p.jpg", progressive=True)
    with pytest.raises(IOError, match="progressive"):
        decode.read_rgb(tmp_path / "p.jpg")
    Image.fromarray(image[..., 0]).save(tmp_path / "t.png")
    data = (tmp_path / "t.png").read_bytes()
    (tmp_path / "t.png").write_bytes(data[:len(data) // 2])
    with pytest.raises(IOError):
        decode.read_png(tmp_path / "t.png")


# --- loader ----------------------------------------------------------------

NYU_HW, KITTI_HW = (480, 640), (375, 1242)


def _save_pair(folder, rgb_name, depth_name, rng, hw, depth_hi):
    Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(folder / rgb_name)
    Image.fromarray(rng.integers(0, depth_hi, hw).astype(np.uint16)).save(folder / depth_name)


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    """4 NYU frames with semantics (.npy) and ade20k instance maps (.npz;
    frame 3's hold no predictions), and an eval split whose second GT is
    missing."""
    root = tmp_path_factory.mktemp("nyu_port")
    scene = root / "kitchen_0001"
    scene.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        _save_pair(scene, f"rgb_{i:05d}.jpg", f"sync_depth_{i:05d}.png", rng, NYU_HW, 9000)
        np.save(scene / f"semantic_seg_{i:05d}.npy",
                rng.integers(0, 150, NYU_HW).astype(np.uint8))
        labels = None if i == 3 else rng.integers(-1, 100, NYU_HW).astype(np.int32)
        areas = None if i == 3 else rng.integers(0, 5000, NYU_HW).astype(np.int32)
        np.savez(scene / f"instance_labels_ade20k_swin_{i:05d}.npz", labels)
        np.savez(scene / f"instance_areas_ade20k_swin_{i:05d}.npz", areas)
        lines.append(f"/kitchen_0001/rgb_{i:05d}.jpg /kitchen_0001/sync_depth_{i:05d}.png "
                     "518.8579")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    eval_lines = [lines[0], lines[1].replace("sync_depth_00001", "sync_depth_missing")]
    (root / "eval.txt").write_text("\n".join(eval_lines) + "\n")
    return root


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_port")
    scene = root / "2011_09_26_drive_0001"
    for side in ("image_02", "image_03", "proj_depth"):
        (scene / side).mkdir(parents=True)
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        _save_pair(scene, f"image_02/{i:010d}.jpg", f"proj_depth/{i:010d}.png", rng, KITTI_HW,
                   80 * 256)
        Image.fromarray(rng.integers(0, 255, (*KITTI_HW, 3), dtype=np.uint8)).save(
            scene / f"image_03/{i:010d}.jpg")
        d = "/2011_09_26_drive_0001"
        lines.append(f"{d}/image_02/{i:010d}.jpg {d}/proj_depth/{i:010d}.png 721.5377 "
                     f"{d}/image_03/{i:010d}.jpg {d}/proj_depth/{i:010d}.png")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "eval.txt").write_text("\n".join(ln.split(" 721.5377")[0] + " 721.5377"
                                             for ln in lines[:2]) + "\n")
    return root


def _args(root, dataset, **kw):
    base = dict(dataset=dataset, data_path=str(root), gt_path=str(root),
                filenames_file=str(root / "train.txt"),
                filenames_file_eval=str(root / "eval.txt"),
                data_path_eval=str(root), gt_path_eval=str(root),
                input_height=96, input_width=128, do_kb_crop=dataset == "kitti",
                do_random_rotate=True, degree=2.5, use_semantics=None,
                use_instance_segmentation=None, image="rgb", batch_size=2, eval_batch_size=1,
                num_threads=2, seed=7, use_right=dataset == "kitti", no_native_aug=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


CUES = dict(use_semantics="glove-25d", use_instance_segmentation="ade20k_swin")
TRAIN_CASES = {
    "nyu_numpy": ("nyu", dict(no_native_aug=True)),
    "nyu_native": ("nyu", {}),
    "nyu_cues_numpy": ("nyu", dict(CUES, no_native_aug=True)),
    "nyu_cues_native": ("nyu", CUES),
    "kitti_numpy": ("kitti", dict(no_native_aug=True)),
    "kitti_native": ("kitti", {}),
}


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list):
            assert g == w, key
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "image":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:  # depth from uint16, the label and area maps, focal, flags
            np.testing.assert_array_equal(g, w, err_msg=key)


def _first_batches(loader, epochs=(0, 1), n=2):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        for i, batch in enumerate(loader):
            out.append(batch)
            if i + 1 == n:
                break
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_batches_match_jax(nyu_tree, kitti_tree, case):
    dataset, kw = TRAIN_CASES[case]
    args = _args(nyu_tree if dataset == "nyu" else kitti_tree, dataset, **kw)
    if not args.no_native_aug:  # JAX would drop to its numpy path without it
        assert jax_native_lib() is not None
    got = _first_batches(DepthDataLoader(args, "train"))
    want = _first_batches(JaxDepthDataLoader(args, "train"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["image"].shape == (2, 96, 128, 3)
        _assert_same_batch(g, w)
    assert not np.array_equal(got[0]["image"], got[2]["image"])  # epochs differ


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_eval_batches_match_jax(nyu_tree, kitti_tree, dataset):
    """Full frames at batch 1; the NYU split's second GT is missing."""
    root = nyu_tree if dataset == "nyu" else kitti_tree
    args = _args(root, dataset, **(CUES if dataset == "nyu" else {}))
    got = list(DepthDataLoader(args, "online_eval"))
    want = list(JaxDepthDataLoader(args, "online_eval"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same_batch(g, w)
    if dataset == "nyu":
        assert [bool(b["has_valid_depth"][0]) for b in got] == [True, False]
    else:
        assert got[0]["image"].shape == (1, 352, 1216, 3)


def test_augment_batch_matches_jax(nyu_tree):
    """The engine on decoded, boundary-cropped samples (`load_raw_train`,
    the two-step native route): the port's equals JAX's, exactly."""
    from mde_tpu.data import DepthDataset as JaxDepthDataset
    from mde_tpu.data.native import augment_batch as jax_augment_batch
    from mde_tpu_torch.data import DepthDataset
    from mde_tpu_torch.data.native import augment_batch
    args = _args(nyu_tree, "nyu", **CUES)
    samples = [DepthDataset(args, "train").load_raw_train(i) for i in (0, 3)]
    want_samples = [JaxDepthDataset(args, "train").load_raw_train(i) for i in (0, 3)]
    for got, want in zip(samples, want_samples):
        _assert_same_batch(got, want)
    params = [dict(angle_deg=1.7, crop_x=5, crop_y=9, do_flip=True, do_augment=True,
                   gamma=1.05, brightness=0.9, color=(0.95, 1.0, 1.08)),
              dict(angle_deg=0.0, crop_x=0, crop_y=3)]
    got = augment_batch(samples, 96, 128, params, num_threads=2)
    want = jax_augment_batch(want_samples, 96, 128, params, num_threads=2)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_rank_takes_its_share_of_the_order(nyu_tree):
    """Two ranks split the epoch's permutation between them, each with half
    the batch, as the JAX loader does over jax processes."""
    args = _args(nyu_tree, "nyu", no_native_aug=True)
    whole = DepthDataLoader(args, "train")._order()
    ranks = [DepthDataLoader(args, "train", rank=r, world_size=2) for r in (0, 1)]
    assert all(r.batch_size == 1 for r in ranks)
    orders = [r._order(r.rank, r.world_size) for r in ranks]
    assert np.array_equal(np.sort(np.concatenate(orders)), np.sort(whole))
    assert np.array_equal(orders[0], whole[0::2]) and np.array_equal(orders[1], whole[1::2])


@pytest.mark.parametrize("line,match", [
    ("/kitchen_0001/missing.jpg /kitchen_0001/sync_depth_00000.png", "missing.jpg"),
    ("/kitchen_0001/rgb_00000.jpg /kitchen_0001/missing.png", "1 of 1 samples.*missing.png"),
], ids=["header_read", "engine"])
def test_native_loader_refuses_a_frame_it_cannot_read(nyu_tree, tmp_path, line, match):
    """A file the header read or the C++ engine cannot open raises IOError
    naming it; no batch of zeros comes out."""
    bad = tmp_path / "train.txt"
    bad.write_text(f"{line} 518.8579\n")
    args = _args(nyu_tree, "nyu", filenames_file=str(bad), batch_size=1)
    with pytest.raises(IOError, match=match):
        next(iter(DepthDataLoader(args, "train")))


# --- parser ----------------------------------------------------------------

PARAMS = sorted(glob.glob(os.path.join(REPO, "params", "args_*.txt")))


@pytest.mark.parametrize("path", PARAMS, ids=os.path.basename)
def test_params_file_parses_as_jax(path):
    mode = "eval" if "args_test_" in path else "train"
    cls = "EvalArgParser" if mode == "eval" else "TrainArgParser"
    want = vars(jax_parsers.parse_cli(getattr(jax_parsers, cls)(), [path], mode=mode))
    got = vars(parsers.parse_cli(getattr(parsers, cls)(), [path], mode=mode))
    assert got.pop("device") == "cuda"
    assert got == want
