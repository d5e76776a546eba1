"""Carry a JAX parameter tree across to the port, and back.

``params_from_numpy`` takes the reference's param pytree with numpy
leaves (the caller converts, e.g. ``jax.tree.map(np.asarray, params)``;
this module imports nothing of JAX) and builds the port's parameter dict:

  * ``tree["scan"]`` holds one stacked dict per pattern position, with a
    leading ``n_rep`` axis (``repro/models/lm.py:91-101``); it is
    unstacked in layer order as ``_blocks_list`` does, then
    ``tree["tail"]`` follows;
  * ``tree["blocks"]`` (the ``scan_layers=False`` / n_rep <= 1 layout) is
    taken as it is;
  * the untied ``head`` is carried; dense weights stay (d_in, d_out).

``params_to_numpy`` is the inverse, restacking into the reference's layout
by the rule ``repro.models.lm.init`` uses.  The softmax baseline has the
same leaves (``wq``, ``wk``, ``wv``, ``wo`` per attention block), so both
directions carry it unchanged.

``flow_pool_from_numpy`` carries a reference ``serving.quant.QuantizedPool``
of a FlowState (given as its numpy ``payload`` and ``scale`` trees, e.g.
``jax.tree.map(np.asarray, pool.payload)``) into the port's
``QuantizedPool``, so a test can feed both sides the same int8 pool.
``kv_pool_from_numpy`` does the same for the softmax caches: a reference
``KVCache`` or ``PagedKVCache`` (given as its numpy (k, v, pos) leaves,
with ``scale`` leaves for an int8 ``QuantizedPool`` of one).  A paged
pool of P pages gains the port's trash page (zeros) at index P.

A classifier tree (``repro/models/classifier.py``: ``embed`` or
``in_proj``, a list of ``blocks``, ``final_norm`` and a dense ``head``
with a bias) is never stacked, whatever ``cfg.scan_layers`` says, so both
directions carry it as it is.  The tree itself tells the two apart: only a
classifier has ``in_proj`` or a dense ``head``.

A vision tree (``repro/models/vision.py``: ``patch_embed``, a list of
``stages`` each holding a Python list of ``blocks`` and, but for the last,
a ``merge``, then ``final_norm`` and a dense ``classifier`` with a bias) is
never stacked either; its ``patch_embed`` tells it apart, and both
directions carry it as it is, its stages' block counts checked against
``cfg.stage_layers``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.attention.recurrent import FlowState
from repro_torch.config import ModelConfig
from repro_torch.layers.attention import KVCache
from repro_torch.serving.paged import PagedKVCache
from repro_torch.serving.quant import QuantizedPool, spec_of
from repro_torch.utils import tree_map


def _blocks_of(tree: dict, cfg: ModelConfig) -> list:
    if "blocks" in tree:
        return list(tree["blocks"])
    stacked = tree["scan"]
    n_rep = np.shape(next(iter(_leaves(stacked[0]))))[0]
    blocks = [tree_map(lambda x, r=r: x[r], stacked[j])
              for r in range(n_rep) for j in range(len(cfg.pattern))]
    return blocks + list(tree.get("tail", []))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def is_classifier(tree: dict) -> bool:
    """True for a classifier's parameter tree (its head is dense)."""
    return "in_proj" in tree or "w" in tree.get("head", {})


def is_vision(tree: dict) -> bool:
    """True for the hierarchical vision model's parameter tree."""
    return "patch_embed" in tree


def _as_tensor(x):
    return torch.from_numpy(np.array(x, copy=True))


def params_from_numpy(tree: dict, cfg: ModelConfig) -> dict:
    """The port's parameter dict (CPU tensors) from a numpy param tree."""
    if is_vision(tree):
        layers = tuple(len(st["blocks"]) for st in tree["stages"])
        if layers != tuple(cfg.stage_layers):
            raise ValueError(f"tree has stages of {layers} blocks, cfg "
                             f"{tuple(cfg.stage_layers)}")
        return tree_map(_as_tensor, dict(tree))
    if is_classifier(tree):
        if len(tree["blocks"]) != cfg.n_layers:
            raise ValueError(f"tree has {len(tree['blocks'])} blocks, cfg "
                             f"{cfg.n_layers}")
        return tree_map(_as_tensor, dict(tree))
    blocks = _blocks_of(tree, cfg)
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"tree has {len(blocks)} blocks, cfg {cfg.n_layers}")
    p = {"embed": tree["embed"], "blocks": blocks,
         "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        p["head"] = tree["head"]
    return tree_map(_as_tensor, p)


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The reference's param tree layout with numpy leaves."""
    p = tree_map(lambda x: x.detach().cpu().numpy(), params)
    if is_classifier(p) or is_vision(p):
        return p
    out = {"embed": p["embed"]}
    period = len(cfg.pattern)
    n_rep, tail = divmod(cfg.n_layers, period)
    if cfg.scan_layers and n_rep > 1:
        blocks = p["blocks"]
        out["scan"] = []
        for j in range(period):
            group = [blocks[r * period + j] for r in range(n_rep)]
            out["scan"].append(_stack(group))
        out["tail"] = blocks[n_rep * period:]
    else:
        out["blocks"] = p["blocks"]
    out["final_norm"] = p["final_norm"]
    if "head" in p:
        out["head"] = p["head"]
    return out


def _stack(group: list):
    first = group[0]
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in group]) for k in first}
    return np.stack(group)


def flow_pool_from_numpy(payload, scale, state_dtype: str = "int8", *,
                         device="cpu") -> QuantizedPool:
    """The port's ``QuantizedPool`` of a reference FlowState pool.

    ``payload`` and ``scale`` are FlowState-shaped sequences of numpy
    arrays (fields t, q_sum, k_sum, ko_sum, qi_sum, z, s, as both packages
    order them); the recipe is the serving one (head granularity, ``z``
    exempt), as ``repro.serving.quant.maybe_quantize`` builds it.  Values
    are copied bit for bit.
    """
    def state(tree):
        return FlowState(*(_as_tensor(x).to(device) for x in tree))

    return QuantizedPool(state(payload), state(scale), spec_of(state_dtype),
                         "head", ("z",))


def kv_pool_from_numpy(payload, scale=None, state_dtype: str = "int8", *,
                       paged: bool = False, device="cpu"):
    """The port's ``KVCache`` (or, with ``paged``, ``PagedKVCache``) of a
    reference softmax cache, given as its numpy (k, v, pos) leaves; with
    ``scale`` (the reference ``QuantizedPool``'s scale leaves, same
    layout) a ``QuantizedPool`` of it with the serving recipe (token
    granularity).  A paged pool's k and v (and their scales) get the
    trash page, zeros, appended at index P.  Values are copied bit for
    bit."""
    def cache(tree):
        k, v, pos = (_as_tensor(x).to(device) for x in tree)
        if not paged:
            return KVCache(k, v, pos)
        trash = lambda x: torch.cat([x, torch.zeros_like(x[:1])])  # noqa: E731
        return PagedKVCache(trash(k), trash(v), pos)

    if scale is None:
        return cache(payload)
    return QuantizedPool(cache(payload), cache(scale), spec_of(state_dtype),
                         "token")
