"""Build a CUDA source of `csrc/` with nvcc and load it with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface, for sm_90a (Hopper), at first use. The library lands in
`.build/mde_tpu_torch/` at the repository root, named by a hash of the
source, of every header in `csrc/` (`*.cuh`, `*.h`) and of the flags, so an
edited source or header is rebuilt and an unchanged tree is loaded as is;
ptxas's report (registers, shared memory, spills) is kept beside it as .log.
Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit.
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


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit that PyTorch finds (CUDA_HOME, PATH, or the
    toolkit's default prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where the library built from csrc/<source> lives."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    headers = sorted(p for pattern in ("*.cuh", "*.h") for p in CSRC_DIR.glob(pattern))
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def load(source: str) -> ctypes.CDLL:
    """Build csrc/<source> if its library is missing, then load it."""
    so = library_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
