"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own into a shared library for ``sm_90a``. All sources are compiled at once
(one ``nvcc`` process each), at first use, into ``kernels/_build/`` (listed
in ``.gitignore``). A library's file name carries a hash of its source, of
every header in ``csrc/`` (``*.cuh``, which the sources may include) and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.

No source includes PyTorch's headers: a plain C file builds in seconds,
where one that includes ``torch/extension.h`` takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}          # source name -> nvcc/ptxas output
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def lib_path(src: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in (src, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{src[:-3]}-{digest.hexdigest()[:16]}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source not yet built (in parallel) and load all of
    them; returns ``{source stem: CDLL}``. Raises with nvcc's output when a
    compile fails."""
    global build_seconds
    with _lock:
        if _libs and len(_libs) == len(_sources()):
            return dict(_libs)
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = None
        procs = []
        for src in _sources():
            out = lib_path(src)
            if os.path.isfile(out):
                continue
            nvcc = nvcc or _nvcc()
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in _sources():
            _libs[src[:-3]] = ctypes.CDLL(lib_path(src))
        build_seconds = time.perf_counter() - t0
        return dict(_libs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _libs.get(stem)
    if lib is None:
        lib = build_all()[stem]
    return lib
