"""Launch layer: serving from the command line
(``python -m repro_torch.launch.serve``).

The reference's ``dryrun``, ``mesh``, ``sharding`` and ``train`` entry points
are not ported yet (ROADMAP Queue 1 item 9)."""
