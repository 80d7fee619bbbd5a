"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root, in a file named after a hash
of the source and the flags — an edited source builds anew, an unchanged
one is loaded as it is.  Beside each library lies ``nvcc``'s output, with
``ptxas -v``'s registers and spills of every kernel (:func:`ptxas_report`).  :func:`build_all` starts one ``nvcc`` per source,
all at once, so the build takes as long as the slowest file.

Nothing here runs at import, so the module imports where there is no CUDA
toolkit (the CPU tests import every module of the package).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, else from ``PATH``, else from the toolkit
    PyTorch itself located; raises if there is none."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    from torch.utils.cpp_extension import CUDA_HOME as torch_cuda_home

    if torch_cuda_home and (Path(torch_cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(torch_cuda_home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the port's CUDA kernels are built from source")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is already built;
    returns (process or None, library path)."""
    src, lib = _target(name)
    if lib.is_file():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), lib


def _finish(name: str, started) -> Path:
    job, lib = started
    if job is not None:
        proc, tmp = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)
    return lib


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` each, all
    started together; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said of each kernel of ``csrc/<name>.cu`` when it
    was built (registers, shared memory, spills); empty if the library was
    built by an earlier process and its log is gone."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(_finish(name, _start(name))))
    return lib


@functools.cache
def entry(lib: str, name: str, n_ptrs: int, n_ints: int):
    """The C entry ``name`` of ``csrc/<lib>.cu``, typed once: (dtype code,
    n_ptrs pointers, n_ints ints, stream) -> cudaError_t."""
    fn = getattr(load(lib), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn

