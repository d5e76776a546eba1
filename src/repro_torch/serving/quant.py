"""Quantized serving state pools: low-bit payload + fp32 scales.

The counterpart of ``repro/serving/quant.py``.  Slots per device are the
capacity currency at serving scale, and the Worker's slot-batched state
pools are what cap them.  ``ExecutionPlan.state_dtype`` (distinct from
the activation dtype) makes a pool int8 (or fp8 ``e4m3`` where the
platform supports it):

  * ``QuantSpec``      -- a named low-bit format (payload dtype + qmax).
  * ``QuantizedPool``  -- the low-bit ``payload`` (the original state's
    container type, so the Worker's install scatters recurse over it
    unchanged) plus a ``scale`` tree of per-(slot, head) fp32 scales of
    the same container type.  Constant-size states (FlowState) are
    rewritten whole every step and requantize with a fresh amax.
  * ``quantize_state`` / ``dequantize_state`` / ``quantize_like`` -- the
    boundary conversions (packed-prefill install).
  * ``pool_bytes``     -- device bytes of a cache tree, the paged pools'
    trash pages counted apart (``trash_bytes``).

Positional caches (the softmax branch's ``KVCache`` and ``PagedKVCache``)
quantize per token: each appended K/V row gets its own scale once and is
never re-rounded; their ``pos`` leaves stay raw int32.

``QuantTraj`` carries a speculative verify window's fp32 trajectory
beside the pool's recipe, so rollback gathers the accepted boundary
first and quantizes once.  Capability gating lives with the registries:
``Backend.quant_capable`` and ``Mixer.quant_capable`` consult
:func:`platform_support`, so resolution rejects fp8 off the TPU by name
rather than emulating it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "QuantSpec", "QuantizedPool", "QUANT_DTYPES", "STATE_DTYPES", "spec_of",
    "platform_support", "state_dtype_of", "quantize_leaf", "quantize_state",
    "dequantize_state", "quantize_like", "maybe_quantize", "pool_bytes",
    "trash_bytes", "QuantTraj",
]

_FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

#: state_dtype values that produce a ``QuantizedPool``
QUANT_DTYPES = ("int8", "fp8")
#: every accepted ``ExecutionPlan.state_dtype`` / ``--state-dtype`` value
STATE_DTYPES = ("bf16", "fp32") + QUANT_DTYPES

_EPS = 1e-12  # amax floor: all-zero groups get a tiny (not inf) scale


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A low-bit storage format: payload dtype plus its max magnitude."""

    name: str

    @property
    def qmax(self) -> float:
        return 127.0 if self.name == "int8" else 448.0  # e4m3 finite max

    @property
    def dtype(self) -> torch.dtype:
        if self.name == "int8":
            return torch.int8
        if _FP8_DTYPE is None:  # pragma: no cover - old torch
            raise ValueError("fp8 state pools need torch.float8_e4m3fn")
        return _FP8_DTYPE


def spec_of(name: str) -> QuantSpec:
    if name not in QUANT_DTYPES:
        raise ValueError(f"unknown quantized state dtype {name!r}; "
                         f"expected one of {QUANT_DTYPES}")
    return QuantSpec(name)


def platform_support(dtype: str, platform: str | None) -> tuple[bool, str]:
    """(ok, reason) -- can ``platform`` serve ``dtype`` state pools?

    int8 pools work everywhere.  fp8 ``e4m3`` is gated to the TPU, as in
    the reference: on ``cuda`` and ``cpu`` the named rejection tells the
    caller to pick int8 instead of silently emulating.
    """
    if dtype == "int8":
        return True, "int8 payload + fp32 scales"
    if dtype == "fp8":
        if _FP8_DTYPE is None:  # pragma: no cover - old torch
            return False, ("fp8 state pools need torch.float8_e4m3fn "
                           "(torch too old)")
        if platform != "tpu":
            return False, (f"fp8 e4m3 state pools are TPU-only (platform="
                           f"{platform}); use int8 here")
        return True, "fp8 e4m3 payload + fp32 scales"
    return False, (f"unknown quantized state dtype {dtype!r}; expected one "
                   f"of {QUANT_DTYPES}")


def state_dtype_of(plan) -> str | None:
    """The plan's state-pool dtype, or None (plan-less callers included);
    a ``BoundExecutor`` answers for the plan it binds."""
    plan = getattr(plan, "plan", plan)
    return getattr(plan, "state_dtype", None) if plan is not None else None


# ---------------------------------------------------------------------------
# Leaf-level quantization
# ---------------------------------------------------------------------------
def _scale_axes(x: torch.Tensor, granularity: str) -> tuple[int, ...]:
    """Axes the amax reduces over (the kept prefix indexes the scale).

    ``head``:  keep (slot, head) -- axes [0, 1] of an ndim>=3 leaf, just
               the slot axis of a 2-D leaf.
    ``token``: keep everything but the feature axis.
    """
    kept = x.ndim - 1 if granularity == "token" else (2 if x.ndim >= 3 else 1)
    return tuple(range(kept, x.ndim))


def _quantizable(x: torch.Tensor) -> bool:
    return x.is_floating_point() and x.ndim >= 2


def _unit_scale(x: torch.Tensor) -> torch.Tensor:
    """Placeholder scale for exempt/integer leaves; keeps axis 0 (the slot
    axis) so the Worker's slot scatters stay shape-correct."""
    return torch.ones(x.shape[:1] + (1,) * (x.ndim - 1), dtype=torch.float32,
                      device=x.device)


def quantize_leaf(x: torch.Tensor, spec: QuantSpec, granularity: str = "head"):
    """Quantize one tensor; returns ``(payload, fp32 scale)``.

    ``scale = max(amax, 1e-12) / qmax`` per kept-axis group, ``x / scale``
    by true division, clipped; int8 rounds half to even (``torch.round``,
    as ``jnp.rint``), fp8 is a clipped cast.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=_scale_axes(x, granularity), keepdim=True)
    # a tensor divisor: a CUDA tensor divided by a Python float is
    # multiplied by its reciprocal, which rounds differently
    scale = amax.clamp(min=_EPS) / torch.full_like(amax, spec.qmax)
    y = (xf / scale).clamp(-spec.qmax, spec.qmax)
    if spec.name == "int8":
        y = torch.round(y)
    return y.to(spec.dtype), scale


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------
class QuantizedPool:
    """A state pool stored low-bit: ``payload`` + per-group fp32 ``scale``.

    Both trees share the original state's container type (a FlowState),
    so code that scatters the state leafwise -- the Worker's
    ``_install_layer`` -- applies to payload and scale alike.
    """

    __slots__ = ("payload", "scale", "spec", "granularity", "exempt")

    def __init__(self, payload, scale, spec: QuantSpec, granularity: str,
                 exempt: tuple[str, ...] = ()):
        self.payload = payload
        self.scale = scale
        self.spec = spec
        self.granularity = granularity
        self.exempt = tuple(exempt)

    def with_state(self, payload, scale) -> "QuantizedPool":
        """Same recipe, new payload/scale trees."""
        return QuantizedPool(payload, scale, self.spec, self.granularity,
                             self.exempt)

    def __repr__(self):  # pragma: no cover - debugging sugar
        return (f"QuantizedPool({type(self.payload).__name__}, "
                f"{self.spec.name}, per-{self.granularity})")


def _rebuild(like, parts):
    """A tuple or NamedTuple of ``like``'s type holding ``parts``."""
    return type(like)(*parts) if hasattr(like, "_fields") else type(like)(parts)


def _map(fn, *trees):
    """``fn`` over the tensors of same-shaped trees (tensors, tuples,
    NamedTuples, lists)."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return _rebuild(trees[0], [_map(fn, *kids) for kids in zip(*trees)])


def _unzip(fn, tree):
    """Apply ``fn`` (tensor -> pair) to every tensor of ``tree``; return
    the tree of first and the tree of second members."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    pairs = [_unzip(fn, v) for v in tree]
    return (_rebuild(tree, [p[0] for p in pairs]),
            _rebuild(tree, [p[1] for p in pairs]))


def _quantize_tree(tree, spec, granularity, skip: bool):
    """Quantize every eligible leaf of ``tree``; return (payload, scale)."""
    return _unzip(lambda x: quantize_leaf(x, spec, granularity)
                  if (not skip and _quantizable(x)) else (x, _unit_scale(x)),
                  tree)


def quantize_state(state, spec: QuantSpec, *, granularity: str = "head",
                   exempt: tuple[str, ...] = ()) -> QuantizedPool:
    """Wrap a full-precision state in a :class:`QuantizedPool`.

    ``exempt`` names top-level NamedTuple fields stored raw (the FlowState
    normalizer ``z``); integer leaves (step counters) always pass through.
    Names absent from ``state``'s fields are ignored.
    """
    fields = getattr(type(state), "_fields", None)
    if fields is not None:
        ex = frozenset(exempt)
        parts = [_quantize_tree(child, spec, granularity, name in ex)
                 for name, child in zip(fields, state)]
        payload = type(state)(*[p for p, _ in parts])
        scale = type(state)(*[s for _, s in parts])
    else:
        payload, scale = _quantize_tree(state, spec, granularity, False)
    return QuantizedPool(payload, scale, spec, granularity, tuple(exempt))


def dequantize_state(pool: QuantizedPool):
    """Back to full precision: quantized leaves become fp32, rest pass."""
    qdtype = pool.spec.dtype
    return _map(lambda p, s: p.float() * s if p.dtype == qdtype else p,
                pool.payload, pool.scale)


def quantize_like(pool: QuantizedPool, state) -> QuantizedPool:
    """Quantize a fresh full-precision state with ``pool``'s recipe (the
    packed-prefill install boundary: fresh amax-tracked scales)."""
    return quantize_state(state, pool.spec, granularity=pool.granularity,
                          exempt=pool.exempt)


#: positional caches append per-token rows; everything else is a
#: constant-size state rewritten whole each step
_POSITIONAL = ("KVCache", "PagedKVCache", "MLACache")


def maybe_quantize(state: Any, plan) -> Any:
    """Pool-ify ``state`` iff the plan asks for a quantized state dtype.

    Positional caches get per-token scales, constant-size states
    per-(slot, head) scales.  The FlowState normalizer ``z`` stays raw
    fp32: it is a running sum of exp() competition weights that every
    decode divides by.
    """
    sd = state_dtype_of(plan)
    if sd not in QUANT_DTYPES:
        return state
    name = type(state).__name__
    return quantize_state(
        state, spec_of(sd),
        granularity="token" if name in _POSITIONAL else "head",
        exempt=("z",) if name == "FlowState" else ())


def _leaves(tree, trash: bool = False):
    """The tensors of a cache tree; a paged pool's trash page (its last
    page) is yielded only with ``trash``, and then nothing else is."""
    if isinstance(tree, QuantizedPool):
        yield from _leaves(tree.payload, trash)
        yield from _leaves(tree.scale, trash)
    elif type(tree).__name__ == "PagedKVCache":
        if trash:
            yield tree.k[-1:]
            yield tree.v[-1:]
        else:
            yield from (tree.k[:-1], tree.v[:-1], tree.pos)
    elif isinstance(tree, torch.Tensor):
        if not trash:
            yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, trash)


def pool_bytes(tree) -> int:
    """Total device bytes of a cache tree (pools count payload + scales),
    less the paged pools' trash pages, so that a paged pool of P pages
    counts what the reference's does."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def trash_bytes(tree) -> int:
    """Device bytes of the paged pools' trash pages in a cache tree."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree, True))


class QuantTraj:
    """A full-precision verify trajectory plus the pool recipe to return to.

    Flow verify runs the window in fp32 (``pipeline.causal_verify``
    dequantizes the carried pool once), and the trajectory of
    per-position boundary states stays fp32, so speculative rollback
    gathers the accepted boundary first and quantizes once: quantizing
    every position would round k states to throw k - 1 away.
    """

    __slots__ = ("traj", "spec", "granularity", "exempt")

    def __init__(self, traj, spec: QuantSpec, granularity: str,
                 exempt: tuple[str, ...] = ()):
        self.traj = traj
        self.spec = spec
        self.granularity = granularity
        self.exempt = tuple(exempt)

    def quantize(self, state) -> QuantizedPool:
        """Quantize a gathered boundary state back into pool form."""
        return quantize_state(state, self.spec, granularity=self.granularity,
                              exempt=self.exempt)
