"""Serving helpers of the port (typed admission so far)."""
