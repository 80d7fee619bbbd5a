"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``cg_solver`` and ``serve_lm``."""
