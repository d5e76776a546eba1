"""LayerNorm / RMSNorm with fp32 statistics whatever the activation dtype."""
from __future__ import annotations

import torch


def norm_init(d: int, kind: str = "rmsnorm") -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32)
    return p


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"]
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)
