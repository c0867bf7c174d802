"""Serving read path of the port."""
