"""Aggregation of client updates (the ported subset of the reference's
resilience layer)."""
