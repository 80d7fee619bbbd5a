"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root, in a file named after a hash
of the source and the flags — an edited source builds anew, an unchanged
one is loaded as it is.  :func:`build_all` starts one ``nvcc`` per source,
all at once, so the build takes as long as the slowest file.

Nothing here runs at import, so the module imports where there is no CUDA
toolkit (the CPU tests import every module of the package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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
        os.replace(tmp, lib)
    return lib


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` each, all
    started together; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(_finish(name, _start(name))))
    return lib


def triton_cache_dir() -> None:
    """Keep Triton's compile cache inside the build directory, not in the
    user's home."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
