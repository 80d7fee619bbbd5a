"""Fused CG step as a Triton kernel: the Krylov loop's vector updates in one
pass.

Replaces ``repro.kernels.solver_step.fused_cg_update`` (``_cg_update_kernel``).
One pass computes

    x' = x + alpha·p,   r' = r - alpha·ap,   z' = minv ⊙ r'
    rz = <r', z'>,      rr = <r', r'>

What bounds it: device-memory bytes — it reads five vectors and writes three
for ~10 flops per element.  Its design: each program streams one block of
the five vectors once, writes the three updated blocks and its two partial
dot products; a second single-program launch sums the partials in a fixed
order.  The TPU kernel instead accumulates both dots into one output block
that every grid step revisits, which is only well defined on the TPU's
sequential grid; here no block touches another's data, there are no float
atomics across blocks, and the result is deterministic.  ``alpha`` is read
from a device tensor, so the solver never waits on the host for it.

Triton is imported, and the kernels are compiled, at the first launch — the
CPU tests import this module on machines without Triton.  Tensors on the CPU
take the plain version (``kernels.ref.cg_update_ref``).
"""

import torch

from .ref import cg_update_ref

_BLOCK = 1024          # elements per program of the update pass
_SUM_BLOCK = 1024      # partials summed per step of the second pass

# ``triton.language``, bound by ``_kernels`` at the first launch; the kernel
# bodies resolve it as a module global when Triton compiles them
tl = None
_JIT: dict = {}


def _kernels():
    """Import Triton and define the two kernels (once)."""
    global tl
    if _JIT:
        return _JIT["update"], _JIT["sum"]
    from .build import triton_cache_dir

    triton_cache_dir()
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def cg_update(x_ptr, r_ptr, p_ptr, ap_ptr, minv_ptr, alpha_ptr, xo_ptr,
                  ro_ptr, zo_ptr, part_ptr, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        alpha = tl.load(alpha_ptr)
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        r = tl.load(r_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        p = tl.load(p_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        ap = tl.load(ap_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        minv = tl.load(minv_ptr + offs, mask=mask, other=0.0)
        xn = x + alpha * p
        rn = r - alpha * ap
        zn = minv * rn
        tl.store(xo_ptr + offs, xn.to(xo_ptr.dtype.element_ty), mask=mask)
        tl.store(ro_ptr + offs, rn.to(ro_ptr.dtype.element_ty), mask=mask)
        tl.store(zo_ptr + offs, zn.to(zo_ptr.dtype.element_ty), mask=mask)
        tl.store(part_ptr + 2 * pid, tl.sum(rn * zn, axis=0))
        tl.store(part_ptr + 2 * pid + 1, tl.sum(rn * rn, axis=0))

    @triton.jit
    def sum_partials(part_ptr, out_ptr, n_parts, BLOCK: tl.constexpr):
        acc_rz = tl.zeros([BLOCK], dtype=tl.float32)
        acc_rr = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, n_parts, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            mask = offs < n_parts
            acc_rz += tl.load(part_ptr + 2 * offs, mask=mask, other=0.0)
            acc_rr += tl.load(part_ptr + 2 * offs + 1, mask=mask, other=0.0)
        tl.store(out_ptr, tl.sum(acc_rz, axis=0))
        tl.store(out_ptr + 1, tl.sum(acc_rr, axis=0))

    _JIT["update"], _JIT["sum"] = cg_update, sum_partials
    return cg_update, sum_partials


_VEC_DTYPES = (torch.float32, torch.bfloat16)


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
        if t.dtype != x.dtype or t.dtype not in _VEC_DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the CG-step kernel takes "
                            f"x, r, p, ap of one dtype in {_VEC_DTYPES}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if minv.shape != (n,) or minv.dtype != torch.float32 \
            or not minv.is_contiguous() or minv.device != x.device:
        raise ValueError(f"minv must be a contiguous float32 ({n},) vector "
                         f"on {x.device}")
    if alpha.numel() != 1 or alpha.dtype != torch.float32 \
            or alpha.device != x.device:
        raise ValueError(f"alpha must be one float32 element on {x.device}")
    update, sum_partials = _kernels()
    grid = -(-n // _BLOCK)
    xo, ro, zo = torch.empty_like(x), torch.empty_like(r), torch.empty_like(r)
    partials = torch.empty((grid, 2), dtype=torch.float32, device=x.device)
    dots = torch.empty(2, dtype=torch.float32, device=x.device)
    update[(grid,)](x, r, p, ap, minv, alpha.reshape(1), xo, ro, zo,
                    partials, n, BLOCK=_BLOCK, num_warps=4)
    sum_partials[(1,)](partials, dots, grid, BLOCK=_SUM_BLOCK, num_warps=4)
    fused_cg_update.launches += 1
    return xo, ro, zo, dots[0], dots[1]


# one per call; each call runs two device kernels (update, sum_partials)
fused_cg_update.launches = 0
