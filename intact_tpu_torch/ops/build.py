"""Build the C++ and CUDA sources into shared libraries, load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `intact_tpu_torch/_build/lib<name>_<hash>.so`, where the hash covers the
source and the flags: an edited source is rebuilt, an unchanged one is reused.
The host sources (`native/fastops.cpp`, `csrc/host/codec.cpp`) are built the
same way by g++ (`HOST_SOURCES`). Nothing is compiled at import time; the first
call that needs a library builds it (`build_all` starts every missing build at
once). A build writes a temporary file and renames it into place, so processes
that build one library at the same time never load half of it.
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
# host C++: (source, g++ flags). fastops keeps the JAX package's flags, so its
# output is bit-equal to intact_tpu.native's built on the same machine; the
# codec keeps IEEE float semantics (no FMA contraction), as its numpy versions
HOST_SOURCES = {
    "fastops": (PKG_DIR / "native" / "fastops.cpp", ("-O3", "-march=native", "-shared", "-fPIC")),
    "codec": (CSRC_DIR / "host" / "codec.cpp",
              ("-O3", "-march=native", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")),
}

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


def _compile(name: str) -> list[str]:
    """The compiler command for `name` without its output path."""
    if name in HOST_SOURCES:
        src, flags = HOST_SOURCES[name]
        return ["g++", *flags, str(src)]
    return [_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")]


def _host_cpu() -> bytes:
    """The host CPU's model and flags: -march=native builds differ per CPU."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    return "".join(l for l in lines if l.startswith(("model name", "flags")))[:4096].encode()


def _target(name: str) -> Path:
    if name in HOST_SOURCES:
        src_path, flags = HOST_SOURCES[name]
        src = src_path.read_bytes() + _host_cpu()
    else:
        src = (CSRC_DIR / f"{name}.cu").read_bytes()
        src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))  # shared headers
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = _compile(name) + ["-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target


def _finish(name: str, proc: subprocess.Popen, tmp: Path, target: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(_compile(name)[:1])} failed on {name} (exit {proc.returncode}):\n{out}")
    ptxas_logs[name] = out
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one compiler per source, all at once."""
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
    """The loaded library for csrc/<name>.cu (or a HOST_SOURCES entry), built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
