"""Deterministic, step-indexed data for training (copied from ``repro/data``)."""
