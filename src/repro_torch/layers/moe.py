"""Mixture-of-Experts FFN: top-k token-choice routing and shared experts.

The counterpart of ``repro/layers/moe.py``, the same gather-based capacity
dispatch: after token-choice top-k routing each expert gathers its top-C
tokens by routing weight (C the capacity), one batched (E, C, d) product
a projection runs every expert at once, and the experts' rows are combined
back per token.  Tokens past an expert's capacity are dropped (their gate
weight never enters the combine), as in GShard and Switch;
``capacity_factor >= n_experts / top_k`` makes the dispatch exact (no
drops), which the tests use to hold it to ``moe_dense_ref``.

The combine runs in a fixed order, so two calls on the same inputs are
bitwise equal on every device: a float ``index_add_`` on CUDA sums through
atomics, in whatever order they land.  Each token has at most ``top_k``
(expert, slot) entries, so the combine gathers those rows and sums them in
expert order, in the activation dtype as the reference's scatter-add of
the rows does.  The routing, the gathers and the batched products are
plain PyTorch (``torch.topk``, ``torch.bmm``), as the reference's are plain
XLA outside any Pallas kernel.

``torch.topk`` and ``jax.lax.top_k`` may order ties differently among an
expert's zero-weight capacity slots; those slots carry weight 0, so only
the outputs are comparable, not the indices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.layers.ffn import ffn, ffn_init
from repro_torch.layers.linear import dense_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             mcfg: MoEConfig) -> dict:
    """The router (d, E), the experts' FFN leaves stacked on a leading E
    axis (``w_in`` (E, d, f), ``w_out`` (E, f, d), and ``w_gate`` for
    swiglu), as the reference's ``vmap`` of ``ffn_init`` stacks them, and
    where the config has them the shared experts: one FFN of width
    ``f * n_shared``."""
    fe = mcfg.d_ff_expert or d_ff
    each = [ffn_init(gen, d_model, fe, act) for _ in range(mcfg.n_experts)]
    experts = {name: {"w": torch.stack([e[name]["w"] for e in each])}
               for name in each[0]}
    p = {"router": dense_init(gen, d_model, mcfg.n_experts),
         "experts": experts}
    if mcfg.n_shared:
        p["shared"] = ffn_init(gen, d_model, fe * mcfg.n_shared, act)
    return p


def _expert_ffn(experts: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (E, C, d) -> (E, C, d): one batched product a projection, each
    accumulated in fp32 and rounded to x's dtype once."""
    def bmm(a, w):
        return torch.bmm(a, w.to(a.dtype))

    h = bmm(x, experts["w_in"]["w"])
    if act == "swiglu":
        h = F.silu(bmm(x, experts["w_gate"]["w"])) * h
    elif act == "squared_relu":
        h = torch.square(F.relu(h))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    elif act == "relu":
        h = F.relu(h)
    else:
        raise ValueError(act)
    return bmm(h, experts["w_out"]["w"])


def router_jitter(gen: torch.Generator, shape, jitter: float,
                  device=None) -> torch.Tensor:
    """The reference's additive router-logit jitter: ``jitter`` times a
    standard normal of ``shape``, drawn from ``gen``
    (an explicit generator, never the global one) on ``gen``'s device and
    moved to ``device``."""
    noise = torch.randn(shape, generator=gen, device=gen.device)
    return jitter * noise.to(device if device is not None else gen.device)


def route(params: dict, xt: torch.Tensor, mcfg: MoEConfig, *,
          gen: torch.Generator | None = None):
    """Token-choice routing of the flat tokens xt (T, d): the router's
    fp32 softmax ``probs`` (T, E), plus ``mcfg.router_jitter`` times a
    normal draw from ``gen`` where both are set, and the top-k ``gates``
    (T, k, renormalized to sum 1) and expert ids ``idx`` (T, k)."""
    # the products of activation-dtype values, summed in fp32
    w = params["router"]["w"].to(xt.dtype)
    logits = torch.matmul(xt.float(), w.float())
    if gen is not None and mcfg.router_jitter > 0:
        logits = logits + router_jitter(gen, logits.shape, mcfg.router_jitter,
                                        logits.device)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def capacity(t: int, mcfg: MoEConfig) -> int:
    """Tokens an expert takes of a call's t tokens: ``min(t, max(8,
    int(cf t k / E)))``, cf the capacity factor (1.25 where unset)."""
    cf = mcfg.capacity_factor or 1.25
    return min(t, max(8, int(cf * t * mcfg.top_k / mcfg.n_experts)))


def _combine(contrib: torch.Tensor, tok_idx: torch.Tensor,
             idx: torch.Tensor, t: int) -> torch.Tensor:
    """Sum each token's rows of ``contrib`` (E, C, d) in expert order.

    ``tok_idx`` (E, C) is each expert's slot -> token; ``idx`` (T, k) each
    token's chosen experts.  A token that an expert kept sits in one of its
    slots; a dropped one in none, and contributes nothing.  A token never
    takes a slot of an expert it did not choose with a non-zero weight, so
    its chosen experts' slots are all its rows."""
    e, c, d = contrib.shape
    dev = contrib.device
    slot = torch.full((e, t), -1, dtype=torch.long, device=dev)
    slot.scatter_(1, tok_idx, torch.arange(c, device=dev).expand(e, c))
    experts = torch.sort(idx, dim=-1).values  # (T, k) in expert order
    tokens = torch.arange(t, device=dev)[:, None]
    s = slot[experts, tokens]  # (T, k)
    rows = contrib.reshape(e * c, d)[(experts * c + s.clamp(min=0))]
    rows = torch.where((s >= 0)[..., None], rows, torch.zeros_like(rows))
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    return out


def moe(params: dict, x: torch.Tensor, act: str, mcfg: MoEConfig, *,
        gen: torch.Generator | None = None):
    """x: (B, N, d) -> (out (B, N, d) in x's dtype, aux loss fp32 scalar).

    Token-choice top-k over the router's fp32 softmax, the gates
    renormalized; the Switch load-balancing loss ``E sum(me ce)
    aux_loss_coef`` (me the mean router probability, ce the share of
    routed slots of each expert); each expert's top-``capacity`` tokens by
    routing weight through the batched FFN; each token's rows weighted by
    its gates and combined in expert order; the shared experts added.
    ``gen`` draws the router jitter where the config has one."""
    b, n, d = x.shape
    t = b * n
    e = mcfg.n_experts
    xt = x.reshape(t, d)
    probs, gates, idx = route(params, xt, mcfg, gen=gen)

    me = probs.mean(dim=0)
    routed = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    routed.scatter_(1, idx, 1.0)
    ce = routed.mean(dim=0) / mcfg.top_k
    aux = e * torch.sum(me * ce) * mcfg.aux_loss_coef

    # token -> expert weights, zero but at the chosen experts
    w_te = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    w_te.scatter_(1, idx, gates)
    wv, tok_idx = torch.topk(w_te.t(), capacity(t, mcfg), dim=-1)  # (E, C)
    xe = xt[tok_idx.reshape(-1)].reshape(e, -1, d)
    ye = _expert_ffn(params["experts"], xe, act)
    contrib = ye * wv[..., None].to(ye.dtype)
    out = _combine(contrib, tok_idx, idx, t)
    if mcfg.n_shared:
        out = out + ffn(params["shared"], xt, act).to(out.dtype)
    return out.reshape(b, n, d).to(x.dtype), aux


def moe_dense_ref(params: dict, x: torch.Tensor, act: str,
                  mcfg: MoEConfig) -> torch.Tensor:
    """The exact dense yardstick (tests only): every token through every
    expert, weighted by its renormalized gates."""
    b, n, d = x.shape
    xt = x.reshape(b * n, d)
    _, gates, idx = route(params, xt, mcfg)
    w_te = torch.zeros((xt.shape[0], mcfg.n_experts), dtype=torch.float32,
                       device=x.device)
    w_te.scatter_(1, idx, gates)
    ye = _expert_ffn(params["experts"],
                     xt[None].expand(mcfg.n_experts, *xt.shape).contiguous(),
                     act)  # (E, T, d)
    out = torch.einsum("te,etd->td", w_te.to(ye.dtype), ye)
    if mcfg.n_shared:
        out = out + ffn(params["shared"], xt, act).to(out.dtype)
    return out.reshape(b, n, d).to(x.dtype)
