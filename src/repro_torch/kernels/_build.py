"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` at first use, one ``nvcc -c`` per source, all started together,
then linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/kernels/<digest>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an unchanged tree
builds once. There is no fallback: without ``nvcc``, or when the build
fails, every call with CUDA tensors raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: SMs of an H100: the grid plans' default when no card is asked
H100_SMS = 132

#: dtype codes of csrc/common.cuh
DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_rmsnorm": [_I, _P, _P, _P, _I, _I, _F, _P],
    "repro_rmsnorm_backward": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _P],
    "repro_flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _F, _P],
    "repro_flash_attention_backward": [_I] + [_P] * 11 + [_I] * 10
                                      + [_F, _P],
    "repro_paged_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "repro_ssd_scan": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _P],
    "repro_ssd_scan_backward": [_I] + [_P] * 15 + [_I] * 7 + [_P],
}

#: where the CUDA toolkit is looked for when neither CUDA_HOME nor PATH
#: names an nvcc
CUDA_HOME_DEFAULT = "/usr/local/cuda"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when it was cached)
BUILD_SECONDS = 0.0


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path(CUDA_HOME_DEFAULT) / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found: repro_torch builds its CUDA kernels from "
        f"{CSRC} at first use; install the CUDA toolkit or set CUDA_HOME")


def build() -> Path:
    """Compile the kernels if this tree's library is not built yet; return
    the library's path. Raises with the compiler's output on failure."""
    global BUILD_SECONDS
    out_dir = BUILD_ROOT / digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    t0 = time.perf_counter()
    compiler = nvcc()
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    jobs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [compiler, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(obj) for _, obj, _ in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    try:
        os.replace(tmp, out_dir)     # atomic publish of the whole directory
    except OSError:
        # a concurrent build published first; its library is identical
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def build_log() -> str:
    """The compiler's output (``-Xptxas=-v``: registers, spills, shared
    memory per kernel) of this tree's build."""
    path = BUILD_ROOT / digest() / "build.log"
    return path.read_text() if path.is_file() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (or refused its
    arguments)."""
    if rc == 1000:
        raise ValueError(f"{kernel}: the kernel does not take these "
                         "arguments")
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {rc}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: no kernel for dtype {dtype}; "
                        f"expected one of {list(DTYPE_CODES)}")
    return DTYPE_CODES[dtype]
