"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/`` at the repository root, named by a hash of
the flags, the source and the shared headers ``csrc/*.cuh``, so an edited
source or header rebuilds and an unchanged one is reused.  Nothing is built when a module is imported: the first launch
builds, or ``build_all`` builds every source at once, one nvcc process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, the toolkit's default
    install location, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build on a "
            "machine with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the flags, the source and
    every shared header (``csrc/*.cuh``), so an edited header rebuilds every
    library instead of reusing a stale one."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return out, tmp, proc


def _finish(out: Path, tmp: Path, proc) -> str:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{stdout}{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)  # atomic: concurrent builds agree on one file
    return stdout + stderr


def build_all(names: Sequence[str] | None = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no current build, one nvcc per source in parallel.  Returns each built
    source's compiler output (ptxas register and spill report)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [_start(n) for n in names if not library_path(n).exists()]
    return {out.stem: _finish(out, tmp, proc) for out, tmp, proc in started}


def load(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    returns an int (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.presto_error_string.argtypes = [ctypes.c_int]
            lib.presto_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib
