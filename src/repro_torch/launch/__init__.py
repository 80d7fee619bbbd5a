"""Launch layer: training and serving from the command line
(``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``).

The reference's ``dryrun``, ``mesh`` and ``sharding`` (a device mesh, the
state's shardings and XLA programs lowered for 512 devices) are not ported
yet (ROADMAP Queue 1 item 11)."""
