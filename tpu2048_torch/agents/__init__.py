"""Agent configurations."""
