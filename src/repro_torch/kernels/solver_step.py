"""Wrapper of the fused CG-step kernel (``csrc/solver_step.cu``): the Krylov
loop's vector updates and both dot products in one launch.

Replaces ``repro.kernels.solver_step.fused_cg_update`` (``_cg_update_kernel``).
One pass computes

    x' = x + alpha·p,   r' = r - alpha·ap,   z' = minv ⊙ r'
    rz = <r', z'>,      rr = <r', r'>

What bounds it: device-memory bytes — it reads five vectors and writes
three for ~10 flops an element.  The TPU kernel accumulates both dots into
one output block that every grid step revisits, which is well defined only
on the TPU's sequential grid.  Here each block writes its pair of partial
sums, and the last block to finish (counted by an atomic ticket) sums them
in block order: one launch, no float atomics, the same bits on every launch
and on every stream.  ``alpha`` is read from a device tensor, so the solver
never waits on the host for it.  The CUDA source says more.

The grid is a function of n and the card's SM count only
(:func:`launch_grid`, with the kernel's constants from :func:`geometry`),
so the order of every sum is fixed.  Partials and dots come from the
caching allocator; the ticket is one int32 a (device, stream), zeroed when
it is made and reset by the kernel itself, so a call launches exactly one
device kernel.

For tensors on the CPU the wrapper runs the plain version
(``kernels.ref.cg_update_ref``); for CUDA tensors it checks what the kernel
takes, launches it on the current stream, raises on a launch error and adds
one to its ``launches`` count.  It never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import cg_update_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TICKETS: dict = {}              # (device index, stream handle) -> int32 (1,)


def launch_grid(n: int, sms: int, geometry: tuple[int, int, int]) -> int:
    """Blocks of a launch on ``n`` elements on a card of ``sms`` SMs:
    one a chunk of ``threads · elems`` elements, at most ``blocks_per_sm``
    an SM, at least one.  ``geometry`` is (threads a block, elements a
    thread per chunk, blocks an SM), the kernel's constants."""
    threads, elems, blocks_per_sm = geometry
    return max(1, min(-(-n // (threads * elems)), blocks_per_sm * sms))


@functools.cache
def geometry(lib: ctypes.CDLL) -> tuple[int, int, int]:
    """The kernel constants a library of ``csrc/solver_step.cu`` was built
    with: (threads a block, elements a thread per chunk, blocks an SM)."""
    out = (ctypes.c_int * 3)()
    lib.cg_update_geometry(out)
    return tuple(out)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The stream's ticket counter on ``device`` (made once, zeroed)."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def fused_cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                    ap: torch.Tensor, minv: torch.Tensor, alpha: torch.Tensor):
    """One fused pass: returns (x', r', z', rz, rr).

    x, r, p, ap are (n,) vectors of one dtype (fp32 or bf16 on the card),
    minv an fp32 (n,) vector, alpha an fp32 one-element tensor on the same
    device; rz and rr are fp32 0-d tensors."""
    if x.device.type == "cpu":
        return cg_update_ref(x, r, p, ap, minv, alpha)
    from .ops import check_cuda_device

    check_cuda_device(x.device)
    n = x.shape[0]
    for name, t in (("x", x), ("r", r), ("p", p), ("ap", ap)):
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) vector")
        if t.dtype != x.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} is {t.dtype}; the CG-step kernel takes "
                            f"x, r, p, ap of one dtype in "
                            f"{tuple(_DTYPE_CODE)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if minv.shape != (n,) or minv.dtype != torch.float32 \
            or not minv.is_contiguous() or minv.device != x.device:
        raise ValueError(f"minv must be a contiguous float32 ({n},) vector "
                         f"on {x.device}")
    if alpha.numel() != 1 or alpha.dtype != torch.float32 \
            or alpha.device != x.device:
        raise ValueError(f"alpha must be one float32 element on {x.device}")
    if n >= 2 ** 31:
        raise ValueError(f"n = {n} does not fit the kernel's int32 length")
    dev = x.device
    grid = launch_grid(n, _sm_count(dev.index),
                       geometry(build.load("solver_step")))
    stream = torch.cuda.current_stream(dev).cuda_stream
    xo, ro, zo = torch.empty_like(x), torch.empty_like(r), torch.empty_like(r)
    work = torch.empty(2 + 2 * grid, dtype=torch.float32, device=dev)
    dots, partials = work[:2], work[2:]
    fn = build.entry("solver_step", "cg_update", 12, 3)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), r.data_ptr(), p.data_ptr(),
             ap.data_ptr(), minv.data_ptr(), alpha.data_ptr(), xo.data_ptr(),
             ro.data_ptr(), zo.data_ptr(), partials.data_ptr(),
             dots.data_ptr(), _ticket(dev, stream).data_ptr(), n, grid,
             int(_aligned(x, r, p, ap, minv, xo, ro, zo)), stream)
    if err != 0:
        raise RuntimeError(f"cg_update launch failed: cudaError_t {err}")
    fused_cg_update.launches += 1
    return xo, ro, zo, dots[0], dots[1]


# one per call; each call is one device kernel
fused_cg_update.launches = 0
