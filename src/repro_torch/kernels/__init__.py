"""Hand-written Hopper kernels and their plain PyTorch versions.

ehyb_spmv.py   — wrappers of the EHYB SpMV kernels (CUDA C++,
                 ``csrc/ehyb_spmv.cu``): fused and ELL-only, uniform tiles
                 and packed staircase, and the standalone ER kernel
                 (``er``: ER rows -> per-slot partial sums).
ehyb_spmm.py   — wrappers of the EHYB SpMM kernels (CUDA C++,
                 ``csrc/ehyb_spmm.cu``): fused and ELL-only, uniform tiles
                 and packed staircase, K right-hand sides.
solver_step.py — wrapper of the fused CG step (CUDA C++,
                 ``csrc/solver_step.cu``): x', r', z' and both dots in one
                 launch, the cross-block sum finished by the last block.
ops.py         — container-level wrappers (original and permuted space),
                 the SpMV/SpMM routing, the unfused level
                 (``use_er_kernel=False``), ``ehyb_ell_only`` and the CUDA
                 capability check.
build.py       — builds ``csrc/*.cu`` with nvcc and loads it with ctypes.
ref.py         — the plain versions.
"""

from .ehyb_spmv import (ehyb_ell, ehyb_ell_packed, ehyb_fused,
                        ehyb_packed_fused, er)

__all__ = ["ehyb_ell", "ehyb_ell_packed", "ehyb_fused", "ehyb_packed_fused",
           "er"]
