"""Distributed training: strategies, mixing and transport (port of
``repro.core``)."""
