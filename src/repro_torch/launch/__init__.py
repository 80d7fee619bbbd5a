"""Launch layer: the production mesh, the sharding rules, and the dry-run,
train and serve entry points (``python -m repro_torch.launch.dryrun``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``).  The port of ``repro.launch``; importing it
touches no process group."""

from .mesh import axis_size, batch_axes, make_host_mesh, make_production_mesh
from .sharding import (batch_shardings, make_shard_act, param_shardings,
                       state_shardings, train_state_shardings)

__all__ = ["axis_size", "batch_axes", "make_host_mesh",
           "make_production_mesh", "batch_shardings", "make_shard_act",
           "param_shardings", "state_shardings", "train_state_shardings"]
