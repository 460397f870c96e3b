"""Build the CUDA sources under `csrc/` into shared libraries, load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `intact_tpu_torch/_build/lib<name>_<hash>.so`, where the hash covers the
source and the flags: an edited source is rebuilt, an unchanged one is reused.
Nothing is compiled at import time; the first call that needs a library
builds it (`build_all` starts every missing build at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_attention", "fused_adam_rows", "w8a8_matmul")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_logs: dict[str, str] = {}  # name -> nvcc's register/shared-memory report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target


def _finish(name: str, proc: subprocess.Popen, tmp: Path, target: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    ptxas_logs[name] = out
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source, all at once."""
    with _lock:
        started = [(n, *_start(n)) for n in names if not _target(n).exists()]
        errors = []
        for name, proc, tmp, target in started:
            try:
                _finish(name, proc, tmp, target)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
