"""Opt-in activation sharding constraints, on a single controller.

The counterpart of ``repro/distribution/act_sharding.py``.  There, an
active policy pins the residual stream to (batch over the dp axes,
sequence replicated or split, features replicated) with
``with_sharding_constraint`` at block boundaries, the FFN hidden to
(batch, sequence, "model") and per-head activations to (batch, "model",
None, None).

The port's sharded steps split the batch (and, for sequence-parallel
prefill, the sequence) themselves before a position runs, and run each
position's layers on whole feature and head dimensions, so there is no
layout to pin: under an active policy the ``constrain_*`` functions
return their input unchanged.  They check what the reference's
constraint would need: every axis the spec names exists in the mesh, and
the axes placed on a dimension the controller does not split (the FFN
hidden and the heads over ``model``) divide it; they raise otherwise.  As
in the reference, heads that ``model`` does not divide are left alone.
The batch and sequence entries were split (and checked) when the step
split its inputs, so only their names are checked here.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.distribution.mesh import axis_tuple

_STATE = threading.local()


def _current():
    return getattr(_STATE, "residual", None)


@contextlib.contextmanager
def activation_sharding(residual_spec: tuple, mesh):
    """Enable the activation constraints within the block.

    ``residual_spec``'s leading entries give the (batch, seq) placement;
    the derived specs:
      residual    (B, N, d)     -> (batch, seq, None)
      ffn hidden  (B, N, f)     -> (batch, seq, "model")
      heads       (B, H, N, D)  -> (batch, "model", seq, None)
    """
    prev = _current()
    _STATE.residual = (tuple(residual_spec), mesh)
    try:
        yield
    finally:
        _STATE.residual = prev


def _constrain(x: torch.Tensor, dims: list, split: tuple) -> torch.Tensor:
    """Check ``dims`` (one spec entry a dimension of ``x``) against the
    mesh; the dimensions in ``split`` were split by the sharded step."""
    _, mesh = _current()
    dims = dims[:x.ndim] + [None] * (x.ndim - len(dims))
    for i, entry in enumerate(dims):
        names = axis_tuple(entry)
        for a in names:
            if a not in mesh.shape:
                raise ValueError(f"activation spec names axis {a!r}, not in "
                                 f"the mesh (axes: {tuple(mesh.shape)})")
        size = 1
        for a in names:
            size *= mesh.shape[a]
        if i not in split and x.shape[i] % size:
            raise ValueError(f"dim {i} of an activation {tuple(x.shape)} is "
                             f"not divisible by the {size}-way {entry!r}")
    return x


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Check a (B, N, d) residual activation; its input unchanged, and a
    no-op when no policy is active."""
    cur = _current()
    if cur is None:
        return x
    spec, _ = cur
    return _constrain(x, list(spec), split=(0, 1))


def constrain_ffn_hidden(x: torch.Tensor) -> torch.Tensor:
    """Check a (B, N, f) FFN hidden activation: the hidden dim over
    "model" (hidden TP and sequence SP both want "model": TP wins)."""
    cur = _current()
    if cur is None:
        return x
    spec, _ = cur
    batch_axis = spec[0] if len(spec) else None
    seq_axis = spec[1] if len(spec) > 1 else None
    if seq_axis == "model":
        seq_axis = None
    return _constrain(x, [batch_axis, seq_axis, "model"], split=(0, 1))


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """Check a (B, H, N, D) per-head activation: heads over "model"."""
    cur = _current()
    if cur is None:
        return x
    spec, mesh = cur
    batch_axis = spec[0] if len(spec) else None
    if x.shape[1] % mesh.shape.get("model", 1):
        return x  # kv heads the axis does not divide: left alone
    return _constrain(x, [batch_axis, "model", None, None], split=(0,))
