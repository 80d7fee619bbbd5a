"""The gather-everything distributed SpMV — kept as the accounting baseline.

The port of ``repro.dist.allgather``: the ER part gathers the **entire**
permuted x per SpMV (``all_gather``) and reduce-scatters a full-length
partial y, so every iteration moves ``2 · n_pad · r`` words per device
however few columns the ER entries reference.  :class:`~repro_torch.dist.
ShardedOperator` replaces it with the compact halo exchange; this module
exists so that tests can hold ``HaloPlan.halo_words`` against the words
the old strategy moved on the same matrices.  Its arithmetic is plain
PyTorch, as the reference's is XLA.
"""

from __future__ import annotations

import torch

from ..core.spmv import EHYBDevice, _acc_dtype, _as_2d, _ehyb_ell_part


def build_allgather_spmv(dev: EHYBDevice, mesh, axis: str = "data",
                         space: str = "original"):
    """Distributed SpMV over ``mesh[axis]`` via full-x all-gather (baseline).

    ``dev`` is the whole container, the same on every rank; each rank
    applies its ``n_parts / n_dev`` partitions and ``1 / n_dev`` of the ER
    rows.  Requires ``n_parts % n_dev == 0`` (the halo-plan operator pads
    instead).  ``space="permuted"`` returns ``x_new -> y_new`` on the
    global permuted vectors, ``"original"`` ``x -> y``; both replicated on
    every rank."""
    import torch.distributed as dist

    from .operator import mesh_axis_info

    if space not in ("original", "permuted"):
        raise ValueError(f"unknown space {space!r}")
    group, n_dev, rank, _ = mesh_axis_info(mesh, axis)
    if dev.n_parts % n_dev:
        raise ValueError(f"n_parts {dev.n_parts} must divide devices {n_dev}")
    ppd = dev.n_parts // n_dev
    er_rows = dev.er_vals.shape[0]
    per = -(-er_rows // n_dev)
    er_lo, er_hi = min(rank * per, er_rows), min((rank + 1) * per, er_rows)
    parts = slice(rank * ppd, (rank + 1) * ppd)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    loc = ppd * dev.vec_size

    def spmv_permuted(x_new: torch.Tensor) -> torch.Tensor:
        x2, squeeze = _as_2d(x_new)
        r = x2.shape[1]
        acc = _acc_dtype(x2.dtype)
        x_loc = x2[rank * loc: (rank + 1) * loc].contiguous()
        y = _ehyb_ell_part(dev.ell_vals[parts], dev.ell_cols[parts],
                           x_loc.reshape(ppd, dev.vec_size, r)).reshape(
                               loc, r)
        # the upper bound this module exists to measure: the full x
        # gathered, a full-length partial y reduce-scattered
        x_full = x2.new_empty((dev.n_pad, r))
        gather(x_full, x_loc, group=group)
        cols = dev.er_cols[er_lo:er_hi].to(torch.int64)
        g = x_full.index_select(0, cols.reshape(-1)).reshape(
            *cols.shape, r).to(acc)
        y_er = torch.einsum("ew,ewr->er", dev.er_vals[er_lo:er_hi].to(acc), g)
        y_sc = torch.zeros((dev.n_pad, r), dtype=acc, device=x2.device)
        y_sc.index_add_(0, dev.er_row_idx[er_lo:er_hi].to(torch.int64), y_er)
        part = y_sc.new_empty((loc, r))
        scatter(part, y_sc, group=group)
        y_loc = (y + part).to(x2.dtype)
        out = x2.new_empty((dev.n_pad, r))
        gather(out, y_loc.contiguous(), group=group)
        return out[:, 0] if squeeze else out

    if space == "permuted":
        return spmv_permuted

    def spmv(x: torch.Tensor) -> torch.Tensor:
        x2, squeeze = _as_2d(x)
        xpad = torch.cat([x2, x2.new_zeros((dev.n_pad - dev.n, x2.shape[1]))])
        y_new = spmv_permuted(xpad[dev.perm])
        y = y_new[dev.inv_perm[: dev.n]]
        return y[:, 0] if squeeze else y

    return spmv
