"""Parameter files."""
