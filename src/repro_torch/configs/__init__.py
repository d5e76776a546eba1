"""Config registry of the port: ``get_config(name)`` / ``get_smoke_config``.

Only the configurations the port serves are here; each module exposes
``config()`` (full size) and ``smoke_config()`` (reduced, CPU-runnable).
"""
from __future__ import annotations

import dataclasses
import importlib

PORTED_CONFIGS = ("flowformer_lm", "flowformer_lra", "flowformer_timeseries",
                  "flowformer_vision", "mamba2_1p3b")


def _module(name: str):
    name = name.replace("-", "_")
    if name not in PORTED_CONFIGS:
        raise ValueError(f"config {name!r} is not ported yet; "
                         f"ported: {PORTED_CONFIGS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str):
    return _module(name).smoke_config()
