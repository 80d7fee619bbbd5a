"""Roofline terms of one device's step, on an H100 (no card needed).

The port of ``repro.roofline.analysis``.  Terms, per device:

    compute_s    = matmul flops / PEAK_FLOPS
    memory_s     = matmul operand + result bytes / HBM_BW
    collective_s = Σ over collectives of max(operand, result) bytes / the
                   rate of the link its group crosses

``roofline.op_cost`` counts the flops and bytes of one rank's step (the
SPMD program every rank runs), so the counts are per device already, as
the reference's ``cost_analysis`` of the partitioned module is.

The constants are the NVIDIA H100 SXM5 data sheet's (H100 Tensor Core GPU
datasheet, 2023): 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at
900 GB/s a GPU in both directions (450 GB/s a direction), and one
ConnectX-7 adapter of 400 Gb/s (50 GB/s) a GPU for the network between
8-GPU nodes (the DGX H100 layout).  A collective is priced at NVLink's rate
when all the ranks of its group lie in one node — rank blocks of
``GPUS_PER_NODE``, the order ``init_device_mesh`` lays ranks out in — and
at the network's rate otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM5, per GPU (H100 Tensor Core GPU datasheet)
PEAK_FLOPS = 989.4e12        # dense bf16
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s a direction (NVLink 4: 900 GB/s total)
NETWORK_BW = 50e9            # bytes/s: one ConnectX-7, 400 Gb/s, a GPU
GPUS_PER_NODE = 8

# the reference's name for the collective rate, for callers that take one
ICI_BW = NVLINK_BW


def link_of(ranks) -> str:
    """``"nvlink"`` when every rank of a group lies in one node of
    ``GPUS_PER_NODE`` consecutive ranks, else ``"network"``."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return "nvlink" if len(nodes) <= 1 else "network"


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device matmul flops
    hbm_bytes: float             # per-device matmul bytes
    coll_bytes: float            # per-device collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0     # 6·N·D (or 2·N·D inference), whole step
    useful_ratio: float = 0.0    # model_flops / (flops × chips)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             *, chips: int, model_flops: float = 0.0,
             coll_by_link: Optional[dict] = None) -> RooflineTerms:
    """The terms of one device.  ``coll_by_link`` (``{"nvlink": bytes,
    "network": bytes}``, summing to ``coll_bytes``) prices each part at
    its link's rate; without it every byte goes at NVLink's."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    if coll_by_link is None:
        collective_s = coll_bytes / NVLINK_BW
    else:
        collective_s = (coll_by_link.get("nvlink", 0.0) / NVLINK_BW
                        + coll_by_link.get("network", 0.0) / NETWORK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = (model_flops / (flops * chips)) if flops else 0.0
    return RooflineTerms(flops=flops, hbm_bytes=hbm_bytes,
                         coll_bytes=coll_bytes, compute_s=compute_s,
                         memory_s=memory_s, collective_s=collective_s,
                         dominant=dominant, model_flops=model_flops,
                         useful_ratio=useful)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference forward), N_active for MoE
# ---------------------------------------------------------------------------

def _leaves_with_names(tree, name=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_names(v, k)
    else:
        yield name, tree


def count_params(params_tree, *, active_only=False, cfg=None) -> float:
    """Elements of every leaf of a tree of tensors (fake or real) or
    shapes; an expert leaf (``we_*``) scaled by top_k / E when
    ``active_only``."""
    total = 0.0
    for name, leaf in _leaves_with_names(params_tree):
        n = 1.0
        for d in (leaf.shape if hasattr(leaf, "shape") else leaf):
            n *= d
        if active_only and cfg is not None and name.startswith("we_"):
            n *= cfg.top_k / cfg.n_experts
        total += n
    return total


def model_flops_for(cfg, shape, params_tree) -> float:
    n_active = count_params(params_tree, active_only=True, cfg=cfg)
    d_tokens = shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * d_tokens


__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NETWORK_BW", "ICI_BW",
           "GPUS_PER_NODE", "RooflineTerms", "roofline", "link_of",
           "count_params", "model_flops_for"]
