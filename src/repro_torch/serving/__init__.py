"""Serving helpers of the port: typed admission and the KV page pool."""
