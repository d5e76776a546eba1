"""Feed-forward blocks: squared-ReLU (Nemotron), SwiGLU (llama), GELU/ReLU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distribution.act_sharding import constrain_ffn_hidden
from repro_torch.layers.linear import dense, dense_init

ACTS = ("squared_relu", "swiglu", "gelu", "relu")


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, act: str) -> dict:
    """``w_in`` and ``w_out``, and for swiglu ``w_gate``, drawn in that
    order as the reference draws them."""
    if act not in ACTS:
        raise ValueError(act)
    p = {"w_in": dense_init(gen, d_model, d_ff),
         "w_out": dense_init(gen, d_ff, d_model)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff)
    return p


def ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = constrain_ffn_hidden(dense(params["w_in"], x))
    if act == "swiglu":
        h = F.silu(constrain_ffn_hidden(dense(params["w_gate"], x))) * h
    elif act == "squared_relu":
        h = torch.square(F.relu(h))
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    elif act == "relu":
        h = F.relu(h)
    else:
        raise ValueError(act)
    return dense(params["w_out"], h)
