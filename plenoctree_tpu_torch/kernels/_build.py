"""Build the CUDA sources in `csrc/` with nvcc, at first use, and load them.
(`build_shared_library` also builds the host library of `native.py`.)

Each library is compiled from the repo's own sources into
`build/kernels/lib<name>-<hash>.so` (the hash covers the sources and the
flags, so an edited source never loads a stale build) and bound with
ctypes: a plain C interface, no PyTorch headers, so a build takes seconds.
`--fmad=false` turns off nvcc's implicit FMA contraction: a kernel fuses a
multiply-add only where its source says `fmaf`, so its rounding follows the
source and the plain PyTorch version can mirror it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS = {}  # one lock per library: different libraries build in parallel
_LIBS = {}
build_logs = {}  # name -> nvcc/ptxas output of the build done in this process


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def build_shared_library(compiler, flags, name, paths, build_dir):
    """Compile `paths` with `compiler flags` into build_dir/lib<name>-<hash>.so
    unless that file exists, and return its path. The hash covers the flags
    and the sources, so an edited source never loads a stale build; the
    library is written to a temporary name and renamed, so processes that
    build it at once each see a whole file. Returns (path, compiler output
    or None when the file was already built)."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        digest.update(Path(p).read_bytes())
    out = Path(build_dir) / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, paths)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed with code {res.returncode}:\n"
            f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load_library(name, sources):
    """Compile csrc/<sources> into one shared library (once) and load it.
    Calls for different names may run in parallel threads."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        out, log = build_shared_library(
            _nvcc(), NVCC_FLAGS, name, [CSRC / s for s in sources], BUILD_DIR)
        if log is not None:
            build_logs[name] = log
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
