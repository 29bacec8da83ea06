"""Batched evaluation."""
