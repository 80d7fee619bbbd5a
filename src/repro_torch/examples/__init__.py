"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart``, ``cg_solver``, ``serve_lm``, ``train_lm`` and
``sparse_ffn_lm``."""
