"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into
``stereo_vo_tpu_torch/_build/lib<name>-<hash>.so``, a library with a plain C
interface loaded through ``ctypes``. The hash covers the source and the
compiler flags, so an edited source rebuilds and an unchanged one is reused.
Only ``csrc/`` of this package is read; nothing outside the package is
written. The sources target Hopper (``sm_90a``).

A source that also compiles as plain C++ (``csrc/pnp_hyp.cu``: its
arithmetic one item at a time on the host) builds with ``g++`` through
``load_host``, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# flags of one library on top of NVCC_FLAGS (hashed into its name only):
# ba_lm and pnp_hyp round each product and sum on its own, as torch's
# kernels do
EXTRA_FLAGS = {"ba_lm": ("--fmad=false",), "pnp_hyp": ("--fmad=false",)}

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}
# seconds each library took to build in this process (absent when reused)
build_seconds: dict = {}
# what ptxas reported for each library built in this process
build_log: dict = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _artifact(name: str, build_flags: tuple, tag: str = "") -> str:
    """``_build/lib<name><tag>-<hash>.so``, the hash over the source and the
    flags."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(build_flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}{tag}-{digest}.so")


def library_path(name: str) -> str:
    return _artifact(name, flags(name))


def _compile(compiler: str, build_flags: tuple, name: str, out: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``out`` (through a temporary file, so a
    library that exists is whole); returns what the compiler printed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(CSRC_DIR, name + ".cu")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler, *build_flags, "-o", tmp, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return (proc.stdout + proc.stderr).strip()


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; return
    the library path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    t0 = time.perf_counter()
    build_log[name] = _compile(find_nvcc(), flags(name), name, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def load_host(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built as plain C++ by ``g++`` (no nvcc, no device
    code: each product and sum rounded on its own) and loaded, reused while
    the source is unchanged."""
    with _lock:
        key = name + ":host"
        lib = _loaded.get(key)
        if lib is None:
            out = _artifact(name, HOST_FLAGS, "-host")
            if not os.path.exists(out):
                cxx = shutil.which("g++") or shutil.which("c++")
                if cxx is None:
                    raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
                _compile(cxx, HOST_FLAGS, name, out)
            lib = _loaded[key] = ctypes.CDLL(out)
        return lib
