"""The port's kernel build (`mde_tpu_torch/kernels/build.py`) names each
library by a hash of its source, of every header in `csrc/` and of the nvcc
flags, so an edited header rebuilds the library and an unchanged tree loads
the one it has. No nvcc is needed: only the library's path is computed."""

import pytest

from mde_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (tmp_path / "common.cuh").write_text("constexpr int kWidth = 128;\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit,rebuilds", [
    (None, False),
    ("common.cuh", True),
    ("extra.h", True),
    ("kernel.cu", True),
    ("notes.txt", False),
], ids=["unchanged", "cuh_edited", "h_added", "source_edited", "other_file"])
def test_library_path_follows_sources_and_headers(csrc, edit, rebuilds):
    before = build.library_path("kernel.cu")
    assert before == build.library_path("kernel.cu")  # stable for one tree
    if edit is not None:
        path = csrc / edit
        path.write_text((path.read_text() if path.exists() else "") + "// edited\n")
    after = build.library_path("kernel.cu")
    assert (after != before) == rebuilds
    assert after.parent == build.BUILD_DIR and after.name.startswith("kernel_")
