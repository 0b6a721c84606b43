"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for `sm_90a` into a shared library at first use, then bound with
`ctypes`.  Libraries land in `unimoe_audio_torch/_build/` (listed in
`.gitignore`), keyed by a hash of the source, every local header it
includes (`#include "..."`, followed recursively) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing is compiled at
import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register and spill report) per source built by this
# process; '' when the library was already built.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_digest(src: str, flags=NVCC_FLAGS) -> str:
    """Hash of a source, the local headers it includes (recursively,
    resolved beside the including file) and the compiler flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(path[len(os.path.dirname(os.path.abspath(src))):].encode() + b"\0" + text)
        todo += [os.path.join(os.path.dirname(path), m.decode())
                 for m in _LOCAL_INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"{name}-{source_digest(src)}.so")
    build_logs[name] = ""
    if not os.path.isfile(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        build_logs[name] = proc.stdout
    _loaded[name] = ctypes.CDLL(lib)
    return _loaded[name]
