"""Format registry and pattern hashes (the autotuner itself is not ported)."""
