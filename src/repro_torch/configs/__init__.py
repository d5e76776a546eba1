"""Config registry of the port: ``get_config(name)`` / ``get_smoke_config``.

Only the configurations the port serves are here; each module exposes
``config()`` (full size) and ``smoke_config()`` (reduced, CPU-runnable).
"""
from __future__ import annotations

import dataclasses
import importlib

PORTED_CONFIGS = ("deepseek_coder_33b", "deepseek_v2_lite_16b",
                  "flowformer_dt", "flowformer_lm", "flowformer_lra",
                  "flowformer_timeseries", "flowformer_vision", "granite_8b",
                  "granite_moe_3b_a800m", "mamba2_1p3b", "nemotron_4_15b",
                  "nemotron_4_340b", "qwen2_vl_72b", "recurrentgemma_9b",
                  "whisper_small")


def _module(name: str):
    # the reference's canonical names: "granite-8b", "mamba2-1.3b", ...
    name = name.replace("-", "_").replace(".", "p")
    if name not in PORTED_CONFIGS:
        raise ValueError(f"config {name!r} is not ported yet; "
                         f"ported: {PORTED_CONFIGS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str):
    return _module(name).smoke_config()
