"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ONE plain ``nvcc`` call into one shared
library with an ``extern "C"`` interface, loaded with ``ctypes``. Nothing here
includes PyTorch's headers, so the build takes seconds, not the minutes of a
``torch.utils.cpp_extension`` build. The library lands in
``<repo>/build/gpmpc_tpu_torch/``, keyed by a hash of the sources and flags,
and is built at first use (``load()``), never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpmpc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)
BUILD_TIMEOUT_S = 240

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns the cudaError_t of its launch.
_SIGNATURES = {
    "gpmpc_cov_fwd_rows": (),
    "gpmpc_cov_fwd_f32": (_P,) * 8 + (_I,) + (_P,) * 2 + (_I,) * 4 + (_P,),
    "gpmpc_cov_bwd_row_f32": (_P,) * 10 + (_I,) + (_P,) * 3 + (_I,) * 4 + (_P,),
    "gpmpc_gram_f32": (_P,) * 4 + (_I,) * 3 + (_P,),
}


class BuildInfo:
    """What the last ``load()`` did: the library path, whether it compiled,
    the compile seconds and nvcc's output (ptxas register/spill report)."""

    path: Path | None = None
    compiled = False
    seconds = 0.0
    log = ""


_lib: ctypes.CDLL | None = None
info = BuildInfo()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): "
                       "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libgpmpc_kernels_{_key(nvcc)}.so"
    info.path = out
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    info.seconds = time.perf_counter() - t0
    info.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{info.log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    info.compiled = True
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
