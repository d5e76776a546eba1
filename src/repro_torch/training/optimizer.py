"""AdamW and Adafactor on fp32 master parameters, the counterpart of
``repro/training/optimizer.py``.

The reference computes on its own layout, where the layers of a scanned
stack are stacked along a leading axis (``repro/models/lm.py:91-101``):
layers ``r * period + j`` for ``r < n_rep`` form one (n_rep, ...) leaf per
pattern position ``j``, when ``cfg.scan_layers`` and ``n_rep > 1``; the
tail layers, the tables and ``final_norm`` keep their own shape.  The port
keeps layers unstacked, so:

  * AdamW's state trees mirror the parameter tree, and its weight decay
    applies to the leaves ``decay_mask`` marks: every leaf with ``ndim >=
    2`` in the stacked layout, so the per-layer norm scales and biases,
    (n_rep, d) there, are decayed while ``final_norm`` is not;
  * Adafactor factors and clips each leaf of the stacked layout
    (``stack_layers``): a per-layer norm scale is one (n_rep, d) leaf, so
    it is factored and its column moment is a mean over the layers; a
    (n_rep, d, f) weight takes one RMS clip over all its layers; MoE
    experts stack as (n_rep, E, d, f).  Its ``vr`` and ``vc`` stay in that
    layout, leaf for leaf the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.utils import global_norm, tree_leaves, tree_map


def _stacking(cfg: ModelConfig | None) -> tuple[int, int]:
    """(period, n_rep) of the reference's stacked layers; n_rep is 0 where
    it keeps a plain list of blocks."""
    if cfg is None:
        return 0, 0
    period = len(cfg.pattern)
    n_rep = cfg.n_layers // period
    return period, n_rep if cfg.scan_layers and n_rep > 1 else 0


def _stack(group: list):
    if isinstance(group[0], dict):
        return {k: _stack([g[k] for g in group]) for k in group[0]}
    return torch.stack(group)


def stack_layers(tree: dict, cfg: ModelConfig | None) -> dict:
    """An LM tree (``embed``, ``blocks``, ``final_norm``, ``head``) in the
    reference's layout: ``blocks`` becomes ``scan``, one stacked dict per
    pattern position, and ``tail``, the layers past the last whole period.
    The tree itself where the reference keeps a list of blocks (or
    ``cfg`` is None)."""
    period, n_rep = _stacking(cfg)
    if not n_rep:
        return tree
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out["scan"] = [_stack([v[r * period + j] for r in range(n_rep)])
                           for j in range(period)]
            out["tail"] = list(v[n_rep * period:])
        else:
            out[k] = v
    return out


def unstack_layers(tree: dict, cfg: ModelConfig | None) -> dict:
    """The inverse of ``stack_layers``: the port's list of blocks, each
    layer's leaves views of the stacked ones."""
    period, n_rep = _stacking(cfg)
    if not n_rep:
        return tree
    out = {}
    for k, v in tree.items():
        if k == "scan":
            out["blocks"] = [tree_map(lambda x, r=r: x[r], v[j])
                             for r in range(n_rep) for j in range(period)
                             ] + list(tree["tail"])
        elif k != "tail":
            out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    m: dict
    v: dict
    step: int


def adamw_init(master) -> AdamWState:
    def zeros(t):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), t)

    return AdamWState(m=zeros(master), v=zeros(master), step=0)


def decay_mask(params: dict, cfg: ModelConfig) -> dict:
    """True for every leaf the reference decays: its ndim is >= 2 in the
    reference's layout.  With ``cfg.scan_layers`` and more than one
    repetition of ``cfg.pattern`` the reference stacks the first
    ``n_rep * len(pattern)`` layers, so every leaf of those layers counts
    as >= 2-D there; the tail layers, the final norm and the tables keep
    their own ndim."""
    mask = tree_map(lambda x: x.ndim >= 2, params)
    period, n_rep = _stacking(cfg)
    if n_rep:
        for i in range(n_rep * period):
            mask["blocks"][i] = tree_map(lambda x: True, params["blocks"][i])
    return mask


def adamw_update(grads, opt: AdamWState, master, lr, cfg: AdamWConfig =
                 AdamWConfig(), decay=None):
    """One AdamW step on fp32 master params.  ``decay`` is a tree of bools
    (default: ``ndim >= 2`` of each leaf; ``decay_mask`` gives the
    reference's rule).  Returns (new_master, state, stats)."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    step = opt.step + 1
    t = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** t
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** t
    if decay is None:
        decay = tree_map(lambda x: x.ndim >= 2, master)

    def upd(g, m, v, p, dec):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and dec:
            update = update + cfg.weight_decay * p
        return p - lr * update, m, v

    leaves = zip(*(tree_leaves(x) for x in (grads, opt.m, opt.v, master,
                                            decay)))
    results = [upd(*leaf) for leaf in leaves]

    def rebuild(i):
        it = iter([r[i] for r in results])
        return tree_map(lambda _: next(it), master)

    return (rebuild(0), AdamWState(rebuild(1), rebuild(2), step),
            {"grad_norm": gnorm})


# ---------------------------------------------------------------------------
# Adafactor (factored second moment: sublinear optimizer memory; Shazeer &
# Stern 2018)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


class AdafactorState(NamedTuple):
    vr: dict  # row second moment (the whole moment for < 2-D leaves)
    vc: dict  # column second moment (a 0-d zero for < 2-D leaves)
    step: int


def adafactor_init(master, layout: ModelConfig | None = None
                   ) -> AdafactorState:
    """Zero moments for ``master`` in the stacked layout of ``layout`` (the
    LM's config; None for a tree the reference never stacks), on
    ``master``'s device (the layout is worked out on meta tensors; a meta
    ``master`` counts the state's size from shapes alone)."""
    device = tree_leaves(master)[0].device

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    shapes = stack_layers(tree_map(lambda x: x.to("meta"), master), layout)
    vr = tree_map(lambda x: zeros(x.shape[:-1] if x.ndim >= 2 else x.shape),
                  shapes)
    vc = tree_map(lambda x: zeros(x.shape[:-2] + x.shape[-1:]
                                  if x.ndim >= 2 else ()), shapes)
    return AdafactorState(vr=vr, vc=vc, step=0)


def adafactor_update(grads, opt: AdafactorState, master, lr,
                     cfg: AdafactorConfig = AdafactorConfig(),
                     layout: ModelConfig | None = None):
    """One Adafactor step on fp32 master params, each leaf of ``layout``'s
    stacked layout factored, clipped and decayed as one (as
    ``adafactor_init`` laid out ``opt``).  No gradient clipping;
    ``grad_norm`` is that of the unscaled gradients.  Returns
    (new_master, state, stats)."""
    step = opt.step + 1
    beta = 1.0 - torch.tensor(float(step), dtype=torch.float32) ** -cfg.decay

    def upd(g, vr, vc, p):
        g = g.float()
        g2 = g.square() + cfg.eps
        if p.ndim >= 2:
            vr = beta * vr + (1 - beta) * g2.mean(dim=-1)
            vc = beta * vc + (1 - beta) * g2.mean(dim=-2)
            rfac = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True).clamp(
                min=cfg.eps))
            update = g * rfac[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            vr = beta * vr + (1 - beta) * g2
            update = g * torch.rsqrt(vr)
        rms = torch.sqrt(update.square().mean() + 1e-12)
        update = update / (rms / cfg.clip_threshold).clamp(min=1.0)
        if cfg.weight_decay and p.ndim >= 2:
            update = update + cfg.weight_decay * p
        return p - lr * update, vr, vc

    stacked = stack_layers(master, layout)
    leaves = zip(*(tree_leaves(x) for x in (stack_layers(grads, layout),
                                            opt.vr, opt.vc, stacked)))
    results = [upd(*leaf) for leaf in leaves]

    def rebuild(i):
        it = iter([r[i] for r in results])
        return tree_map(lambda _: next(it), stacked)

    return (unstack_layers(rebuild(0), layout),
            AdafactorState(rebuild(1), rebuild(2), step),
            {"grad_norm": global_norm(grads)})
