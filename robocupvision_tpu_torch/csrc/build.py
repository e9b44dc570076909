"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``*.cu`` file under this directory has a plain C interface and is
compiled on its own by ``nvcc`` into a shared library under ``build/``
(listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>_<hash>.so <name>.cu

The file name carries a hash of the source, of every header (``*.cuh``)
beside it and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded. ``build_all``
starts one ``nvcc`` per source at once and waits for all of them; the
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
SOURCES = ("confusion.cu", "conv_chain.cu", "conv_block.cu",
           "legacy_jitter.cu", "seg_head.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def lib_path(source: str) -> Path:
    """The library of ``source``: its name hashes the source, every
    ``*.cuh`` header in SRC_DIR (name and text) and the flags."""
    h = hashlib.sha256((SRC_DIR / source).read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: library path}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s: lib_path(s) for s in sources}
    todo = {s: p for s, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = []
    for src, dst in todo.items():
        # compile to a private temporary name, then rename: a concurrent
        # build never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / src)]
        procs.append((src, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, dst, tmp, proc in procs:
        log, _ = proc.communicate()
        dst.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, dst)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[source]))
        _loaded[source] = lib
    return lib
