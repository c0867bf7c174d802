"""Run utilities: generator seeds, metrics logging, checkpoints."""
