"""Shared utilities: device selection, the training watchdog and the
numerical debug check."""
