"""The paper's primary contribution: EHYB — explicit-caching hybrid SpMV.

The port of ``repro.core``.  Pipeline (host-side preprocessing is numpy,
as the paper's CPU/METIS preprocessing is; every compute path is PyTorch):

    SparseCSR --make_partition--> Partition --build_ehyb--> EHYB
        --EHYBDevice.from_ehyb--> device tables --ehyb_spmv / kernels-->  y

The legacy one-call entry points (``spmv``, ``build_spmv``,
``cached_spmv_operator``, ``SpMVOperator``, ``csr_spmv``,
``ehyb_spmv_buckets``, ``solve``, ``precond_for``) are DeprecationWarning
shims over ``repro_torch.api``.
"""

from . import counters
from .matrices import (SUITE, SparseCSR, circuit, elasticity3d, from_coo,
                       poisson3d, poisson3d27, powerlaw, rmat, unstructured)
from .partition import (Partition, PartitionStrategy, available_strategies,
                        bfs_partition, choose_vec_size, get_strategy,
                        hub_partition, make_partition, mincut_partition,
                        natural_partition, register_strategy)
from .ehyb import (EHYB, EHYBBuckets, PackedEHYB, build_buckets,
                   build_ehyb, group_er_by_partition, pack_staircase)
from .spmv import (COODevice, EHYBBucketsDevice, EHYBDevice,
                   EHYBPackedDevice, ELLDevice, HYBDevice, SpMVOperator,
                   build_spmv, coo_spmv, csr_spmv, dense_spmv,
                   ehyb_buckets_spmv, ehyb_buckets_spmv_permuted, ehyb_spmv,
                   ehyb_spmv_buckets, ehyb_spmv_permuted, ell_spmv, hyb_spmv,
                   spmv)
from .solver import (PRECONDITIONERS, SolveResult, bicgstab, cg,
                     precond_for, precond_inv_diag, solve)

__all__ = [
    "SUITE", "SparseCSR", "circuit", "elasticity3d", "from_coo", "poisson3d",
    "poisson3d27", "powerlaw", "rmat", "unstructured",
    "Partition", "PartitionStrategy", "available_strategies",
    "bfs_partition", "choose_vec_size", "get_strategy", "hub_partition",
    "make_partition", "mincut_partition", "natural_partition",
    "register_strategy",
    "EHYB", "EHYBBuckets", "PackedEHYB", "build_buckets", "build_ehyb",
    "group_er_by_partition", "pack_staircase", "EHYBPackedDevice",
    "COODevice", "EHYBBucketsDevice", "EHYBDevice", "ELLDevice", "HYBDevice",
    "SpMVOperator", "build_spmv", "coo_spmv",
    "csr_spmv", "dense_spmv", "ehyb_buckets_spmv",
    "ehyb_buckets_spmv_permuted", "ehyb_spmv", "ehyb_spmv_buckets",
    "ehyb_spmv_permuted", "ell_spmv", "hyb_spmv", "spmv",
    "PRECONDITIONERS", "SolveResult", "bicgstab", "cg", "precond_for",
    "precond_inv_diag", "solve",
]
