"""Build a source of `csrc/` and load it with ctypes: the CUDA kernels with
nvcc, the host library (`mdeaug.cpp`: image decoding and the augmentation)
with the host C++ compiler.

Each source is compiled on its own into a shared library with a plain C
interface at first use: a `.cu` source for sm_90a (Hopper) by nvcc
(`load`), a `.cpp` source by g++ with `-O3 -fPIC -shared -std=c++17
-pthread`, linked against zlib (`load_host`). The library lands in
`.build/mde_tpu_torch/` at the repository root, named by a hash of the
source, of every header in `csrc/` (`*.cuh`, `*.h`) and of the flags, so an
edited source or header is rebuilt and an unchanged tree is loaded as is;
the compiler's report (for nvcc, ptxas's registers, shared memory and
spills) is kept beside it as .log. A failed build raises with the
compiler's output. Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "mde_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
HOST_LIBS = ("-lz",)


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit that PyTorch finds (CUDA_HOME, PATH, or the
    toolkit's default prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str, flags=NVCC_FLAGS) -> Path:
    """Where the library built from csrc/<source> with `flags` lives."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    headers = sorted(p for pattern in ("*.cuh", "*.h") for p in CSRC_DIR.glob(pattern))
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def _build(source: str, compiler: str, flags, libs=()) -> ctypes.CDLL:
    so = library_path(source, flags + libs)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(CSRC_DIR / source), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def load(source: str) -> ctypes.CDLL:
    """Build the CUDA source csrc/<source> with nvcc if its library is
    missing, then load it."""
    return _build(source, nvcc_path(), NVCC_FLAGS)


def host_library_path(source: str) -> Path:
    """Where the library built from the host source csrc/<source> lives."""
    return library_path(source, HOST_FLAGS + HOST_LIBS)


def load_host(source: str) -> ctypes.CDLL:
    """Build the host C++ source csrc/<source> with g++ if its library is
    missing, then load it."""
    return _build(source, HOST_CXX, HOST_FLAGS, HOST_LIBS)
