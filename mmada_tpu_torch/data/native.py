"""ctypes bindings of the native tar streamer (`native/tario.cc`).

Counterpart of `mmada_tpu/data/native.py`: `NativeTarReader` is the
accelerated backend of `data/webdataset.WebDatasetReader`; N C++ threads
stream tar shards and group samples off the GIL, and Python only decodes
and transforms. The library is built from `native/tario.cc` with `g++` (the
flags of `native/Makefile`) into the port's build directory
(`mmada_tpu_torch/_kernels_build/`, gitignored) on first use, under a name
that carries the source's hash; without `g++` or the source, `available()`
is False and the reader falls back to Python's `tarfile`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from typing import Iterator, Optional

from mmada_tpu_torch.ops._build import BUILD_DIR

logger = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "native", "tario.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")


class _EntryView(ctypes.Structure):
    _fields_ = [
        ("ext", ctypes.c_char_p),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("size", ctypes.c_uint64),
    ]


class _SampleView(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_char_p),
        ("entries", ctypes.POINTER(_EntryView)),
        ("num_entries", ctypes.c_uint64),
        ("owner", ctypes.c_void_p),
    ]


def library_path() -> Optional[str]:
    """Where the library of the current source lives; None without it."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libtario_{digest}.so")


def build() -> Optional[str]:
    """The library's path, built first if missing (into a temporary name,
    then renamed, so concurrent builds never load a half-written file);
    None where the source or `g++` is missing or the build fails."""
    path = library_path()
    if path is None or os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        logger.warning("tario: no C++ compiler on PATH; using Python tarfile")
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        logger.warning("tario build failed (exit %d): %s", proc.returncode, proc.stderr)
        return None
    os.replace(tmp, path)
    return path


_lib = None


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.tario_open.restype = ctypes.c_void_p
    lib.tario_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
    ]
    lib.tario_next.restype = ctypes.c_int32
    lib.tario_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_SampleView)]
    lib.tario_free_sample.restype = None
    lib.tario_free_sample.argtypes = [ctypes.POINTER(_SampleView)]
    lib.tario_stats.restype = None
    lib.tario_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tario_close.restype = None
    lib.tario_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


class NativeTarReader:
    """Iterate raw grouped samples: dicts {ext: bytes, '__key__': str}."""

    def __init__(self, shards: list[str], threads: int = 4,
                 capacity: int = 256, loop: bool = False):
        lib = load_library()
        if lib is None:
            raise RuntimeError("libtario unavailable (no g++ or no native/tario.cc)")
        self._lib = lib
        encoded = [s.encode() for s in shards]
        # kept alive while the C++ threads may read the paths
        self._paths = (ctypes.c_char_p * len(encoded))(*encoded)
        self._handle = lib.tario_open(self._paths, len(encoded), threads, capacity,
                                      1 if loop else 0)
        if not self._handle:
            raise RuntimeError("tario_open failed")

    def __iter__(self) -> Iterator[dict]:
        view = _SampleView()
        while True:
            rc = self._lib.tario_next(self._handle, ctypes.byref(view))
            if rc == 0:
                return
            if rc < 0:
                raise RuntimeError("tario_next error")
            sample = {"__key__": view.key.decode(errors="replace")}
            for i in range(view.num_entries):
                e = view.entries[i]
                sample[e.ext.decode()] = ctypes.string_at(e.data, e.size)
            self._lib.tario_free_sample(ctypes.byref(view))
            yield sample

    def stats(self) -> dict:
        s, bm, bs = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.tario_stats(self._handle, ctypes.byref(s), ctypes.byref(bm), ctypes.byref(bs))
        return {"samples": s.value, "bad_members": bm.value, "bad_shards": bs.value}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.tario_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
