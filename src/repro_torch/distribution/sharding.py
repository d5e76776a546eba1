"""Partition rules: the parameter, optimizer and batch specs, and their
placement on a single controller.

The counterpart of ``repro/distribution/sharding.py``.  Axis convention
(``launch/mesh.py``):

    pod    -- outer data parallelism across pods (multi-pod mesh only)
    data   -- data parallelism within a pod
    model  -- tensor, expert and sequence parallelism

A spec is a plain tuple with one entry a dimension: None (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product, row-major).  ``_RULES``, ``param_spec``, ``dp_axes``,
``zero1_spec`` and ``batch_spec`` are the reference's, read off
``mesh.shape`` alone, so any object with a ``shape`` dict serves.

The reference computes its specs on its own parameter layout, where the
layers of a scanned stack are one (n_rep, ...) leaf a pattern position
(``repro/models/lm.py:91-101``); the rules then apply to the stacked
shapes.  ``tree_param_specs`` and ``tree_zero1_specs`` take the LM's
config as ``layout`` and return the specs of ``optimizer.stack_layers``'s
tree, leaf for leaf the reference's (the leaf paths joined as the
reference joins them: ``scan/0/attn/wq/w``).

``to_shardings`` becomes ``place(tree, specs, mesh)``: each leaf split
along its sharded dimensions into per-position pieces on their
positions' devices (views of the leaf where a position's device is the
leaf's; positions that hold the same piece on one device share it), and
``gather(placed)``, which joins them back; the round trip is bitwise.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import torch

from repro_torch.distribution.mesh import Mesh, axis_tuple
from repro_torch.training.optimizer import stack_layers
from repro_torch.utils import tree_map

# (regex on "path/leaf", spec) -- the first match wins
_RULES: list[tuple[str, tuple]] = [
    # attention
    (r"attn.*/w[qkv]/w$", (None, "model")),
    (r"attn.*/wo/w$", ("model", None)),
    (r"attn.*/(kv_up|q_up|q_down)/w$", (None, "model")),
    (r"attn.*/kv_down/w$", (None, None)),
    # ffn
    (r"(ffn|shared)/w_(in|gate)/w$", (None, "model")),
    (r"(ffn|shared)/w_out/w$", ("model", None)),
    # moe (leading expert axis)
    (r"experts/w_(in|gate)/w$", ("model", None, None)),
    (r"experts/w_out/w$", ("model", None, None)),
    (r"router/w$", (None, None)),
    # embeddings
    (r"(embed|head|enc_pos|embed_t)/table$", ("model", None)),
    # rg-lru (width-major)
    (r"rglru/w_(x|gate)/w$", (None, "model")),
    (r"rglru/w_out/w$", ("model", None)),
    (r"rglru/conv_w$", (None, "model")),
    (r"rglru/conv_b$", ("model",)),
    (r"rglru/gate_[ax]$", ("model", None, None)),
    (r"rglru/lam$", ("model",)),
    # ssd (head-major)
    (r"ssd/in_(z|x)/w$", (None, "model")),
    (r"ssd/in_(b|c)/w$", (None, None)),
    (r"ssd/in_dt/w$", (None, "model")),
    (r"ssd/conv_x_w$", (None, "model")),
    (r"ssd/(a_log|dt_bias|d_skip)$", ("model",)),
    (r"ssd/norm/scale$", ("model",)),
    (r"ssd/out_proj/w$", ("model", None)),
    # vision / decision extras
    (r"(patch_embed|merge|classifier|action_head|embed_rtg|embed_state"
     r"|embed_action)/w$", (None, None)),
]


def param_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The spec of one parameter; replicated where no rule matches."""
    model_size = mesh.shape.get("model", 1)
    for pat, spec in _RULES:
        if re.search(pat, path):
            # only sharded dims that divide evenly; else replicate them
            dims = list(spec) + [None] * (len(shape) - len(spec))
            return tuple(d if (d is None or shape[i] % model_size == 0)
                         else None for i, d in enumerate(dims[:len(shape)]))
    return (None,) * len(shape)


def leaf_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs of a dict/list tree, the path joined as the
    reference's ``tree_flatten_with_path`` keys are: ``a/b/0/c``."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, join(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, join(i))]
    return [(prefix, tree)]


def spec_leaves(tree, specs) -> list:
    """``(path, leaf, spec)`` of every leaf of ``tree`` (``specs`` has its
    structure with a spec tuple at each leaf)."""
    out = []
    _zip_map(lambda x, s: out.append(s), tree, specs)
    return [(p, x, s) for (p, x), s in zip(leaf_paths(tree), out)]


def _spec_tree(params, layout, fn):
    """``fn(path, shape)`` at every leaf of ``stack_layers(params,
    layout)``, in that tree's structure."""
    stacked = stack_layers(tree_map(lambda x: x.to("meta"), params), layout)
    specs = iter([fn(path, tuple(leaf.shape))
                  for path, leaf in leaf_paths(stacked)])
    return _rebuild(stacked, specs)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def tree_param_specs(params, mesh, layout=None):
    """The spec of every leaf of ``stack_layers(params, layout)`` (the
    reference's layout where ``layout`` is the LM's config; the tree as it
    is where ``layout`` is None)."""
    return _spec_tree(params, layout,
                      lambda path, shape: param_spec(path, shape, mesh))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh``: ``pod`` and ``data``, those it
    has."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def zero1_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """``spec`` with ZeRO-1 sharding over the dp axes added on the first
    unsharded dimension they divide."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    if dp_size == 1:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, d in enumerate(dims[:len(shape)]):
        if d is None and shape[i] % dp_size == 0 and shape[i] > 0:
            dims[i] = dp if len(dp) > 1 else dp[0]
            return tuple(dims[:len(shape)])
    return spec  # nothing divisible: stay dp-replicated


def tree_zero1_specs(params, mesh, layout=None):
    """``tree_param_specs`` with ``zero1_spec`` applied to every leaf."""
    return _spec_tree(params, layout, lambda path, shape: zero1_spec(
        param_spec(path, shape, mesh), shape, mesh))


def batch_spec(mesh, batch_size: int, *, seq_sharded: bool = False) -> tuple:
    """The spec of a (B, N, ...) batch: B over the dp axes where they
    divide it, N over ``model`` with ``seq_sharded``."""
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    baxis: Any = None
    if dp and batch_size % dp_size == 0 and batch_size >= dp_size:
        baxis = dp if len(dp) > 1 else dp[0]
    return (baxis, "model" if seq_sharded else None)


# ---------------------------------------------------------------------------
# Placement on a single controller (the counterpart of ``to_shardings``)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class Placed:
    """One leaf split by ``spec`` over ``mesh``: ``pieces[i]`` is the piece
    held by the ``i``-th position (row-major over ``mesh.axis_names``)."""

    spec: tuple
    mesh: Mesh
    shape: tuple
    pieces: list

    def _index(self, coord: dict) -> tuple:
        """The piece's index along every dimension of the spec."""
        out = []
        for entry in self.spec:
            r = 0
            for a in axis_tuple(entry):
                r = r * self.mesh.shape[a] + coord[a]
            out.append(r)
        return tuple(out)


def _place_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> Placed:
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    counts = [mesh.axes_size(e) for e in spec]
    for d, n in enumerate(counts):
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} not divisible by "
                             f"the {n}-way spec entry {spec[d]!r}")
    placed = Placed(spec, mesh, tuple(x.shape), [])
    made = {}
    for coord in mesh.coords():
        dev = mesh.device_at(coord)
        key = (placed._index(coord), dev)
        if key not in made:
            piece = x
            for d, (n, r) in enumerate(zip(counts, key[0])):
                if n > 1:
                    piece = piece.narrow(d, r * (x.shape[d] // n),
                                         x.shape[d] // n)
            made[key] = piece.to(dev)
        placed.pieces.append(made[key])
    return placed


def _gather_leaf(p: Placed) -> torch.Tensor:
    counts = [p.mesh.axes_size(e) for e in p.spec]
    pieces = {}
    for coord, piece in zip(p.mesh.coords(), p.pieces):
        pieces.setdefault(p._index(coord), piece)
    dev = p.pieces[0].device

    def join(prefix):
        d = len(prefix)
        if d == len(counts):
            return pieces[prefix].to(dev)
        parts = [join(prefix + (j,)) for j in range(counts[d])]
        return parts[0] if counts[d] == 1 else torch.cat(parts, dim=d)

    return join(())


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def place(tree, specs, mesh: Mesh):
    """Every tensor leaf of ``tree`` split by its spec (``specs`` has the
    tree's structure with a spec at each leaf) into a ``Placed``."""
    return _zip_map(lambda x, s: _place_leaf(x, s, mesh), tree, specs)


def gather(placed):
    """The whole tensors of a ``place``d tree, on the first position's
    device: the inverse of ``place``, bitwise."""
    return tree_map(_gather_leaf, placed)
