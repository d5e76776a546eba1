"""AdamW on fp32 master parameters, the counterpart of
``repro/training/optimizer.py`` (Adafactor is not ported yet).

State trees mirror the parameter tree.  Weight decay applies to the
leaves ``decay_mask`` marks: the reference decays every leaf with
``ndim >= 2`` *in its own layout*, where the layers of a scanned stack are
stacked along a leading axis (``repro/models/lm.py:91-101``).  So its
per-layer norm scales and biases, (n_rep, d) there, are decayed while
``final_norm`` is not.  The port keeps layers unstacked, so the mask
reproduces the stacked layout's rule rather than the leaves' own ndim.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.utils import global_norm, tree_leaves, tree_map


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
    period = len(cfg.pattern)
    n_rep = cfg.n_layers // period
    if cfg.scan_layers and n_rep > 1:
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
