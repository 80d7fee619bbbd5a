"""The synthetic token pipeline.  The port of ``repro.data``."""

from .pipeline import SyntheticTokenDataset, make_batch_specs

__all__ = ["SyntheticTokenDataset", "make_batch_specs"]
