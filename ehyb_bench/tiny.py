"""Cells of the manifest cut to a size a CPU test holds: the same files,
generator and traffic, on a small grid."""

from __future__ import annotations

import dataclasses

from ehyb_bench import harness

TINY_PARAMS = {"hpcg27": {"nx": 8, "ny": 8, "nz": 8},
               "q1_elasticity": {"ne": 5}}


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.resolve(harness.load_manifest(), workload)
    config = {k: v for k, v in cell.config.items() if k not in ("n", "nnz")}
    config["params"] = dict(config["params"],
                            **TINY_PARAMS[config["generator"]])
    return dataclasses.replace(cell, config=config)
