"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (with the headers beside it) is compiled by its own
plain ``nvcc -c``, all started together, and the objects are linked by one
more ``nvcc`` into one shared library with an ``extern "C"`` interface,
loaded with ``ctypes``. Nothing here
includes PyTorch's headers, so the build takes seconds, not the minutes of a
``torch.utils.cpp_extension`` build. The library lands in
``<repo>/build/gpmpc_tpu_torch/``, keyed by a hash of the sources and flags,
and is built at first use (``load()``), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpmpc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)
BUILD_TIMEOUT_S = 240

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns the cudaError_t of its launch.
_SIGNATURES = {
    "gpmpc_cov_fwd_f32": (_P,) * 8 + (_I,) + (_P,) * 2 + (_I,) * 6 + (_P,),
    "gpmpc_cov_fwd_info": (_I,) * 5 + (_P,),
    "gpmpc_cov_bwd_f32": (_P,) * 10 + (_I,) + (_P,) * 3 + (_I,) * 5 + (_P,),
    "gpmpc_cov_bwd_info": (_I,) * 3 + (_P,),
    "gpmpc_cov_gik_f32": (_P,) * 6 + (_I,) + (_P,) + (_I,) * 6 + (_P,),
    "gpmpc_cov_gik_info": (_I,) * 6 + (_P,),
    "gpmpc_gram_f32": (_P,) * 4 + (_I,) * 6 + (_P,),
    "gpmpc_gram_info": (_I,) * 4 + (_P,),
    "gpmpc_empty_launch": (_I,) * 3 + (_P,),
    "gpmpc_df_fwd_f32": (_P,) * 15 + (_I,) + (_P,) * 2 + (_I,) * 8 + (_P,),
    "gpmpc_df_fwd_info": (_I,) * 5 + (_P,),
    "gpmpc_df_fwdres_max_bands": (_I,) * 5,
    "gpmpc_df_fwdres_f32": (_P,) * 15 + (_I,) + (_P,) * 3 + (_I,) * 5 + (_P,),
    "gpmpc_df_fwdres_info": (_I,) * 5 + (_P,),
    "gpmpc_df_bwd_f32": (_P,) * 17 + (_I,) + (_P,) * 2 + (_I,) * 3 + (_P,),
    "gpmpc_df_bwd_side_f32": (_P,) * 17 + (_I,) + (_P,) * 2 + (_I,) * 5 + (_P,),
    "gpmpc_df_mm_tile": (),
    "gpmpc_df_mm_full_f32": (_P,) * 19 + (_I,) * 4 + (_P, _I, _P),
    "gpmpc_df_mm_fwd_f32": (_P,) * 20 + (_I,) * 4 + (_P, _I, _P),
    "gpmpc_df_mm_full_info": (_I,) * 3 + (_P,),
    "gpmpc_df_mm_bwd_f32": (_P,) * 24 + (_I,) * 3 + (_P, _I, _P),
    "gpmpc_df_mm_bwd_info": (_I,) * 2 + (_P,),
    "gpmpc_df_mm_bwd_mean_f32": (_P,) * 18 + (_I,) * 3 + (_P, _I, _P),
    "gpmpc_df_mm_bwd_mean_info": (_I,) * 3 + (_P,),
    "gpmpc_df_mm_bwd_pair_f32": (_P,) * 21 + (_I,) * 3 + (_P, _I, _P),
    "gpmpc_df_mm_bwd_pair_info": (_I,) * 2 + (_P,),
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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    t0 = time.perf_counter()
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for obj, src in zip(objs, sources()))]
    logs, failed = [], None
    for cmd, proc in compiles:
        try:
            text, _ = proc.communicate(timeout=max(1.0, BUILD_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    if failed is None:
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode)
    info.seconds = time.perf_counter() - t0
    info.log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[1]}):\n{' '.join(failed[0])}\n{info.log}")
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


_LAUNCH_KEYS = ("registers", "spill_bytes", "threads", "blocks_per_sm", "grid", "sms", "dyn_smem")


def launch_info(name: str, *args: int, extra: tuple = ()) -> dict:
    """A kernel's launch on the current card from its ``<name>`` report
    function: registers and spill (local) bytes per thread, threads per
    block, resident blocks per SM (the occupancy calculator), grid blocks,
    SMs, dynamic shared memory bytes, the ``extra`` values the function
    appends, and waves (grid over SMs times blocks per SM)."""
    keys = _LAUNCH_KEYS + tuple(extra)
    info = (ctypes.c_int * len(keys))()
    check(getattr(load(), name)(*args, ctypes.addressof(info)), name)
    out = dict(zip(keys, list(info)))
    out["waves"] = out["grid"] / (out["sms"] * max(out["blocks_per_sm"], 1))
    return out


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: the kernels' launch plans
    size their grids with it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def empty_launch(blocks: int, threads: int, dependent: bool) -> None:
    """Launch a kernel that does nothing (csrc/launch_floor.cu) on the
    current stream, plainly or as a programmatic dependent of the launch
    before it: its device time per call is the launch floor."""
    stream = torch.cuda.current_stream().cuda_stream
    check(load().gpmpc_empty_launch(blocks, threads, int(dependent), stream), "empty_launch")


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
