"""Port parity, the evaluation entry point: mde_tpu_torch.evaluate against
mde_tpu.evaluate.evaluate on small NYU and KITTI trees (CPU, float32).

Each case parses `params/args_test_nyu.txt` with overrides on both sides (the
port's `EvalArgParser` adds `--device cpu`) and evaluates a seeded port
checkpoint (`torch.save` of {"model": state_dict}), which the JAX side reads
through `convert_reference_checkpoint`, with `--save_dir` set:

* `nyu`: B1 noAdaBins on 96x128 JPEG frames, eigen crop (the part of its
  fixed window inside the frame), 3 frames of which the second has no GT
  file (`Total invalid: 1`; its prediction is still saved, at its image's
  size).
* `kitti`: B1 noAdaBins on 96x320 PNG frames, garg crop, the 80 m range,
  2 frames.

The model is noAdaBins so the frames can be small (the AdaBins head needs
320x416 for its 129 mViT tokens): the head is the model's business, held
by the other files; the card runs the evaluate CLI with the AdaBins head
(`tests/test_torch_port_cuda.py`, `chip_smoke.py` phase 9 at B5).

Held: the metrics before rounding at rtol 1e-4 (the JAX module's `round` is
patched to see them; the rounded ones follow from them), the total invalid,
and every saved 16-bit PNG: the same names, and values within one count
(depth x 1000 or x 256 truncated to an integer, so a rounding difference can
move one pixel by one). A frame's prediction is resized to its GT's shape on
the host by `resize_bilinear_align_corners_np` on both sides, whose port is
also held alone. An orbax directory as `--checkpoint_path` is refused with
the converter's name.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(2)

NYU_HW, KITTI_HW = (96, 128), (96, 320)


def _tree(root, dataset, rng):
    if dataset == "nyu":
        scene = root / "bathroom_0001"
        scene.mkdir(parents=True)
        lines = []
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (*NYU_HW, 3), dtype=np.uint8)).save(
                scene / f"rgb_{i:05d}.jpg")
            depth = "missing" if i == 1 else f"{i:05d}"
            if i != 1:
                Image.fromarray(rng.integers(300, 9500, NYU_HW).astype(np.uint16)).save(
                    scene / f"sync_depth_{depth}.png")
            lines.append(f"/bathroom_0001/rgb_{i:05d}.jpg /bathroom_0001/sync_depth_{depth}.png "
                         "518.8579")
    else:
        drive = "2011_09_26/2011_09_26_drive_0002_sync"
        (root / drive / "image_02").mkdir(parents=True)
        (root / drive / "proj_depth").mkdir(parents=True)
        lines = []
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (*KITTI_HW, 3), dtype=np.uint8)).save(
                root / drive / "image_02" / f"{i:010d}.png")
            depth = rng.integers(256, 80 * 256, KITTI_HW).astype(np.uint16)
            depth[:, :20] = 0  # no return
            Image.fromarray(depth).save(root / drive / "proj_depth" / f"{i:010d}.png")
            lines.append(f"{drive}/image_02/{i:010d}.png {drive}/proj_depth/{i:010d}.png "
                         "721.5377")
    (root / "eval.txt").write_text("\n".join(lines) + "\n")


CASES = {
    "nyu": ["--encoder_name", "efficientnet-b1-noAdaBins"],
    "kitti": ["--dataset", "kitti", "--encoder_name", "efficientnet-b1-noAdaBins",
              "--max_depth", "80", "--max_depth_eval", "80", "--garg_crop"],
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    """Both evaluations of one case: the port's metrics (unrounded and as
    `evaluate` returns them), its invalid count, both sides' printed lines,
    JAX's unrounded metrics, and the two PNG directories."""
    from mde_tpu import evaluate as jax_evaluate
    from mde_tpu.config import EvalArgParser as JaxEvalArgParser, parse_cli as jax_parse_cli
    from mde_tpu_torch.config import EvalArgParser, parse_cli
    from mde_tpu_torch.evaluate import evaluate, run_evaluation
    from mde_tpu_torch.models import build_model

    name = request.param
    root = tmp_path_factory.mktemp(name)
    _tree(root / "data", name, np.random.default_rng(3))
    base = ["params/args_test_nyu.txt", *CASES[name],
            "--data_path_eval", str(root / "data"), "--gt_path_eval", str(root / "data"),
            "--filenames_file_eval", str(root / "data" / "eval.txt"),
            "--checkpoint_path", str(root / "model.pt")]
    args = parse_cli(EvalArgParser(), base + ["--device", "cpu", "--save_dir",
                                              str(root / "port")], mode="eval")
    torch.manual_seed(5)
    torch.save({"model": build_model(args).state_dict()}, root / "model.pt")

    vals, invalid = run_evaluation(args)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rounded = evaluate(args)

    jax_args = jax_parse_cli(JaxEvalArgParser(), base + ["--save_dir", str(root / "jax")],
                             mode="eval")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_evaluate, "round", lambda v, n: v, raising=False)
    jax_printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(jax_printed):
            jax_vals = jax_evaluate.evaluate(jax_args)
    finally:
        mp.undo()
    return dict(name=name, vals=vals, rounded=rounded, invalid=invalid, jax_vals=jax_vals,
                printed=printed.getvalue(), jax_printed=jax_printed.getvalue(),
                port_dir=root / "port", jax_dir=root / "jax")


def test_metrics_match_jax(case):
    assert case["vals"].keys() == case["jax_vals"].keys()
    for k, v in case["jax_vals"].items():
        assert np.isfinite(case["vals"][k]), k
        np.testing.assert_allclose(case["vals"][k], v, rtol=1e-4, err_msg=k)
    assert case["rounded"] == {k: round(v, 3) for k, v in case["vals"].items()}


def test_total_invalid_matches_jax(case):
    """The count, and the first printed line, as JAX prints it."""
    assert case["invalid"] == (1 if case["name"] == "nyu" else 0)
    line = f"Total invalid: {case['invalid']}"
    assert case["printed"].splitlines()[0] == line == case["jax_printed"].splitlines()[0]
    assert case["printed"].splitlines()[1] == f"Metrics: {case['rounded']}"


def test_saved_predictions_match_jax(case):
    names = sorted(os.listdir(case["jax_dir"]))
    assert sorted(os.listdir(case["port_dir"])) == names
    assert len(names) == (3 if case["name"] == "nyu" else 2)
    for name in names:
        want = np.asarray(Image.open(case["jax_dir"] / name))
        got = np.asarray(Image.open(case["port_dir"] / name))
        assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape, name
        assert np.abs(got.astype(np.int64) - want).max() <= 1, name
        assert got.max() > 0, name


def test_resize_np_matches_jax():
    """The host resize of the save path, equal to JAX's bit for bit: the
    eval shapes, an identity and the one-pixel edge cases."""
    from mde_tpu.ops.resize import resize_bilinear_align_corners_np as jax_resize_np
    from mde_tpu_torch.ops.resize import resize_bilinear_align_corners_np

    rng = np.random.default_rng(0)
    for shape, out in (((2, 160, 208, 1), (320, 416)), ((1, 48, 160, 1), (96, 320)),
                       ((1, 5, 7, 2), (5, 7)), ((1, 1, 9, 1), (4, 3))):
        x = rng.random(shape, dtype=np.float32) * 10
        got = resize_bilinear_align_corners_np(x, out)
        want = jax_resize_np(x, out)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_orbax_directory_is_refused(tmp_path):
    import types
    from mde_tpu_torch.evaluate import load_eval_model
    with pytest.raises(ValueError, match="orbax_to_pt.py"):
        load_eval_model(types.SimpleNamespace(checkpoint_path=str(tmp_path)), "cpu")
