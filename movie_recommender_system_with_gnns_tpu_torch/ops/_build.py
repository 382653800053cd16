"""Build helper for the port's CUDA kernels: ``nvcc`` by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` builds at first use into ``<package>/build/`` (listed
in ``.gitignore``) as ``lib<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source rebuilds and a stale library is
never loaded. ``nvcc``'s output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside the library as ``.log``. A failed build raises with
``nvcc``'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build the port's kernels")
    return str(cand)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc`` per
    source, all started together; returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         tmp, out)
    errors = []
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{stderr}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LIBS[name] = lib
    return lib
