"""Roofline analysis of one device's step, without a card: the port of
``repro.roofline``.

* :mod:`repro_torch.roofline.analysis` — the H100 roofline terms
  (compute, memory, collective priced by link), ``count_params`` and
  ``model_flops_for``;
* :mod:`repro_torch.roofline.op_cost` — the counterpart of ``hlo_cost``:
  a dispatch mode that counts one rank's flops, bytes, collective bytes
  and peak live bytes (``count``, ``OpCost``);
* :mod:`repro_torch.roofline.summarize` — the dry run's records as the
  roofline tables (``python -m repro_torch.roofline.summarize``).
"""

from .analysis import (HBM_BW, ICI_BW, NETWORK_BW, NVLINK_BW, PEAK_FLOPS,
                       RooflineTerms, count_params, model_flops_for,
                       roofline)
from .op_cost import collective_bytes

__all__ = ["HBM_BW", "ICI_BW", "NETWORK_BW", "NVLINK_BW", "PEAK_FLOPS",
           "RooflineTerms", "collective_bytes", "count_params",
           "model_flops_for", "roofline"]
