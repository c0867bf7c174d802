"""Attention over the sequence axis (single device so far)."""
