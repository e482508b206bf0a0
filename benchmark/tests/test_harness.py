"""The benchmark's harness on the CPU: its parts found by name, a cell added
as files alone, deterministic traffic, the counts of work, the contract of
BENCHMARK.json, the refusal to run without a card, and the import boundary.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import cells, traffic
from benchmark.reference import plain, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_part_is_found_by_name(workload):
    cell = cells.resolve(workload)
    assert cell.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                       if w["name"] == workload)
    assert callable(cells.entry(cell).setup)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    assert (ROOT / cell.config["params_file"]).exists()
    assert cell.limits["control"] in ("fp8", "bf16")


def test_a_new_cell_is_taken_from_new_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((bench / "traffic" / "train-bs16.json").read_text())
    (bench / "traffic" / "train-bs8.json").write_text(json.dumps(dict(mix, batch=8)))
    shutil.copy(bench / "limits" / "adabins-b1-nyu.train-bs16.json",
                bench / "limits" / "adabins-b1-nyu.train-bs8.json")
    new = "adabins-b1-nyu.train-bs8"
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": new, "config": "adabins-b1-nyu", "traffic": "train-bs8",
                              "chips": 1, "why": "a smaller batch"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "adabins-b1-nyu.train-bs16" in m.get("workloads", []):
            m["workloads"].append(new)
    cell = cells.resolve(new, spec, bench_dir=bench)
    assert cell.traffic["batch"] == 8
    assert cells.entry(cell, bench_dir=bench).__file__.startswith(str(bench))
    assert [m["name"] for m in cell.end_to_end] == ["train_img_per_s", "setup_s"]
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"], bench_dir=bench))


def small_mix(**kw):
    mix = json.loads((BENCH / "traffic" / "train-bs16.json").read_text())
    return dict(mix, batch=2, height=48, width=64, pool=2, **kw)


def test_training_traffic_is_deterministic_in_the_seed():
    a = traffic.train_pool(small_mix(), True, 2 ** 31 + 5, "cpu")
    b = traffic.train_pool(small_mix(), True, 2 ** 31 + 5, "cpu")
    c = traffic.train_pool(small_mix(), True, 2 ** 31 + 6, "cpu")
    for x, y, z in zip(a, b, c):
        assert x.keys() == y.keys() == {"image", "depth", "semantics", "instance_labels",
                                        "instance_areas"}
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not torch.equal(x["depth"], z["depth"])
    depth = a[0]["depth"]
    valid = depth[depth > 0]
    assert 0.05 <= 1 - valid.numel() / depth.numel() <= 0.15
    assert valid.min() >= 0.5 and valid.max() <= 10.0
    assert torch.equal(valid, torch.round(valid * 1000) / 1000)
    labels, areas = a[0]["instance_labels"], a[0]["instance_areas"]
    assert ((labels == 100) == (areas == 0)).all()
    assert a[0]["semantics"].min() >= 0 and a[0]["semantics"].max() < 150


def test_operations_of_one_conv_match_a_hand_count():
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, device="meta")

    class Net(torch.nn.Module):
        def forward(self, image, cues=None):
            y = conv(image)
            return y.mean((2, 3)), y

    # 2 x N x Cout x H x W x Cin x k x k
    assert work.model_flops(Net(), (2, 8, 10, 12)) == 2 * 2 * 16 * 10 * 12 * 8 * 9


def test_a_training_step_counts_three_forwards_but_the_image_gradient():
    config = cells.resolve("adabins-b1-nyu.train-bs16").config
    model = plain.model(config).eval()
    forward = work.model_flops(model, (2, 3, 416, 544))
    stem = 2 * 2 * 32 * 3 * 9 * 208 * 272
    assert work.train_flops(model, (2, 3, 416, 544)) == 3 * forward - stem
    cues = {"semantics": (2, 25, 416, 544), "instance_labels": (2, 25, 416, 544),
            "instance_areas": (2, 4, 416, 544)}
    cue_model = plain.model(dict(config, use_semantics="glove-25d",
                                 use_instance_segmentation="ade20k_swin_human_sizes")).eval()
    assert work.train_flops(cue_model, (2, 3, 416, 544), cues) == 3 * work.model_flops(
        cue_model, (2, 3, 416, 544), cues)


def test_the_kernels_least_times_match_hand_counts():
    pixels, bins = 16 * 208 * 272, 256
    # bf16 head forward: 2 x 905,216 x 128 x 256 = 59.3 GFLOP at 989 T = 0.060 ms,
    # bytes 905,216 x (256 + 4) = 235 MB at 3.35 TB/s = 0.070 ms: bound by bytes
    assert work.head_fwd_s(pixels, bins, True) == pytest.approx(pixels * 260 / 3.35e12)
    # f32 serving head: 2 x 153,600 x 128 x 256 = 10.07 GFLOP at 67 T = 0.150 ms
    assert work.head_fwd_s(2 * 240 * 320, bins, False) == pytest.approx(
        2 * 153600 * 128 * 256 / 67e12)
    assert work.head_fwd_s(2 * 240 * 320, bins, False) * 1e3 == pytest.approx(0.150, abs=1e-3)
    # bf16 backward: 3 x 59.3 GFLOP at 989 T = 0.180 ms, operations
    assert work.head_bwd_s(pixels, bins, True) * 1e3 == pytest.approx(0.180, abs=1e-3)
    # chamfer: 6 x 256 x 3,620,864 valid pairs at 33.5 T instr/s = 0.166 ms
    valid = 16 * 416 * 544
    assert work.chamfer_s(bins, valid, valid, 16) * 1e3 == pytest.approx(0.166, abs=1e-3)


def test_reference_model_counts_the_published_forward():
    config = cells.resolve("adabins-b1-nyu.train-bs16").config
    flops = work.model_flops(plain.model(config).eval(), (1, 3, 416, 544))
    assert 115e9 < flops < 130e9  # 123.7 GFLOP an image by torch's counter


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(data) and set(c["reduced"]) == set(data["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", names))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    for root in (ROOT, tmp_path):
        if root == tmp_path:  # only BENCHMARK.json and the benchmark's files
            shutil.copytree(BENCH, root / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", root)
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", SPEC["workloads"][0]["name"],
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert "{" not in proc.stdout


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mde_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            tops |= {a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant)}
    return tops


def test_nothing_under_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        assert not imported_tops(path) & FORBIDDEN, path
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "mde_tpu_torch" not in imported_tops(path), path
    # whole top-level names: the port's name begins with the JAX package's
    assert not {"mde_tpu_torch"} & FORBIDDEN
