"""Build helper for the port's native code: a compiler run by hand into a
shared library with a plain C interface, loaded with ``ctypes``.

Two routes, one build directory:

  * ``csrc/<name>.cu``, the CUDA kernels, through ``nvcc`` for ``sm_90a``;
  * the host C++ sources named in :data:`HOST_SOURCES` (the graph runtime
    ``csrc/graphcore.cpp``, a byte-equal copy of the JAX package's
    ``native/graphcore.cpp``) through ``g++`` without ``-march=native``, so
    the library runs on whatever host loads it.

Every source lies inside the package (its package data), so an installed
port builds as a checkout does. Each source builds at first use into
``<package>/build/`` (listed in ``.gitignore``), or, where that cannot be
written (an install owned by another user), into a per-user cache,
``$XDG_CACHE_HOME`` or ``~/.cache``, under
``movie_recommender_system_with_gnns_tpu_torch/<hash of the package path>``;
as ``lib<name>-<hash>.so``, where the hash covers the source and the flags,
so an edited source rebuilds and a stale library is never loaded. Nothing is
written beside the sources. The compiler's output (for
``nvcc``, ``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``.log``. A failed build raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
#: host C++ libraries by name: source path (everything else is csrc/<name>.cu)
HOST_SOURCES: Dict[str, Path] = {
    "graphcore": CSRC / "graphcore.cpp",
}


def _writable(path: Path) -> bool:
    """Whether ``path`` is, or could be made, a directory this user writes."""
    while not path.exists():
        path = path.parent
    return path.is_dir() and os.access(path, os.W_OK | os.X_OK)


def choose_build_dir(preferred: Path) -> Path:
    """``preferred`` when it can be written, else the per-user cache."""
    if _writable(preferred):
        return preferred
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    key = hashlib.sha256(str(PACKAGE_DIR).encode()).hexdigest()[:16]
    return Path(cache) / PACKAGE_DIR.name / key


BUILD_DIR = choose_build_dir(PACKAGE_DIR / "build")

_LIBS: Dict[str, ctypes.CDLL] = {}

#: kernel launches by kernel name; each wrapper adds one where it launches its
#: kernel, and nowhere else. It counts the wrapper's calls on the host: a
#: launch recorded into a CUDA graph counts once, at its capture, and the
#: graph's replays count none. The ``graph.replay`` counter
#: (``utils/capture.py::StepGraph``, while tracing is on) counts the
#: replays: the launches counted at the capture, times ``graph.replay``,
#: are the launches the replays made
LAUNCHES: Counter = Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build the port's kernels")
    return str(cand)


def _host_compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no C++ compiler (g++, or $CXX) on PATH; it is "
                           "needed to build the port's host graph runtime")
    return found


def _recipe(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """(source, flags) of a library; the compiler is looked up only when a
    build is needed."""
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], HOST_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    """Where the library of ``name`` lives for the current source and flags."""
    source, flags = _recipe(name)
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one compiler
    process per source, all started together; returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        source, flags = _recipe(name)
        compiler = _host_compiler() if name in HOST_SOURCES else _nvcc()
        cmd: List[str] = [compiler, *flags, "-o", str(tmp), str(source)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         tmp, out)
    errors = []
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}: compiler exited {proc.returncode}\n{stderr}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _LIBS[name] = lib
    return lib
