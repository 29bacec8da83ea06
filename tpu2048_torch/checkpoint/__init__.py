"""Parameter files and full loop-state checkpoints."""
