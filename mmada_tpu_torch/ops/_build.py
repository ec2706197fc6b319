"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and includes only the CUDA
headers, so it compiles in seconds: `nvcc` makes one shared library per
source, for `sm_90a`, into `_kernels_build/` inside the package (listed in
`.gitignore`). A library is rebuilt when the hash of its source, the shared
headers or the flags changes. Nothing is built or loaded at import time;
the first launch of a kernel builds it, or `build_all()` builds every source
at once, one nvcc process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_kernels_build"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libraries: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # name -> nvcc's output of the last build


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (or $CUDA_PATH, or the
    toolkit's default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA toolkit is "
        "needed to build mmada_tpu_torch's kernels"
    )


def sources() -> list[str]:
    """Kernel names: one per `csrc/*.cu`."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_source_hash(name)}.so")


def nvcc_command(name: str, out_path: str, nvcc: Optional[str] = None) -> list[str]:
    return [nvcc or "nvcc", *NVCC_FLAGS, "-o", out_path,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Optional[list[str]] = None) -> dict[str, float]:
    """Build every missing library in parallel; returns seconds per built
    name. Raises with nvcc's output if any build fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        procs[name] = (proc, tmp)
    seconds, failed = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it on first use."""
    lib = _libraries.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        _libraries[name] = lib
    return lib
