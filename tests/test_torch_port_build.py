"""The port's build (`mde_tpu_torch/kernels/build.py`) names each library by
a hash of its source, of every header in `csrc/` and of the compiler's flags,
so an edited header rebuilds the library and an unchanged tree loads the one
it has. The nvcc route needs no nvcc here: only the library's path is
computed. The host route (g++, for `csrc/mdeaug.cpp`) builds here: a source
that compiles loads, one that does not raises with g++'s output."""

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


@pytest.fixture
def host_csrc(tmp_path, monkeypatch):
    (tmp_path / "lib.cpp").write_text('extern "C" int answer() { return 42; }\n')
    (tmp_path / "broken.cpp").write_text('extern "C" int answer() { return no_such_name; }\n')
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    return tmp_path


def test_host_library_path_follows_source_and_flags(host_csrc):
    """The host route hashes its source, the csrc headers and the g++ flags,
    and names its library apart from an nvcc build of the same source."""
    before = build.host_library_path("lib.cpp")
    assert before == build.host_library_path("lib.cpp")
    assert before != build.library_path("lib.cpp")  # nvcc's flags differ
    (host_csrc / "extra.h").write_text("// a header\n")
    after = build.host_library_path("lib.cpp")
    assert after != before and after.parent == build.BUILD_DIR
    assert after.name.startswith("lib_") and after.suffix == ".so"


def test_host_build_loads_and_keeps_its_log(host_csrc):
    lib = build.load_host("lib.cpp")
    assert lib.answer() == 42
    assert build.host_library_path("lib.cpp").with_suffix(".log").exists()


def test_failed_host_build_raises_with_the_compiler_output(host_csrc):
    """No library, no None: the caller gets g++'s error."""
    with pytest.raises(RuntimeError, match="no_such_name"):
        build.load_host("broken.cpp")
    assert not build.host_library_path("broken.cpp").exists()
