"""Hand-written Hopper kernels and their plain PyTorch versions.

ehyb_spmv.py   — wrappers of the fused EHYB SpMV kernels (CUDA C++,
                 ``csrc/ehyb_spmv.cu``): uniform tiles and packed staircase.
solver_step.py — the fused CG step (Triton).
ops.py         — container-level wrappers (original and permuted space) and
                 the CUDA capability check.
build.py       — builds ``csrc/*.cu`` with nvcc and loads it with ctypes.
ref.py         — the plain versions.
"""
