"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/kernels/`` at
the repository root, and loaded with ``ctypes``.  The library's name
carries a hash of the source, the headers beside it and the flags, so an
edited source or header is rebuilt.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# nvcc runs started by :func:`build` in this process (the compile guard's
# global count, ``repro_torch.analysis.sanitize``).
compiles = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from source")


def toolkit_bin(tool: str) -> str:
    """A CUDA toolkit program beside ``nvcc`` (``cuobjdump``, ...)."""
    return str(Path(_nvcc()).parent / tool)


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def source_tag(name: str, csrc: Path = CSRC, defines=()) -> str:
    """The hash in a library's name: ``<name>.cu``, every header under
    ``csrc`` (a source may include any of them) and the flags, macro
    definitions included, so that an edited source or header is
    rebuilt."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def build(name: str, verbose: bool = False, defines=()) -> Path:
    """Compile ``csrc/<name>.cu`` if this source has not been built yet;
    returns the library's path.  ``defines`` ("NAME=VALUE" strings) become
    ``-D`` flags: one source, one library a set of them.  A failed build
    raises with nvcc's output.  With ``verbose`` the compiler's resource
    report (``-Xptxas -v``) is printed."""
    source = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"{name}_{source_tag(name, defines=defines)}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(defines), *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(source)]
    global compiles
    compiles += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str, defines=()) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with ``defines`` (built on
    first call)."""
    return ctypes.CDLL(str(build(name, defines=defines)))
