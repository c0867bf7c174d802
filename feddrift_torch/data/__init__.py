"""Drift datasets of the port (numpy; bitwise equal to the reference)."""
