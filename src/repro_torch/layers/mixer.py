"""SequenceMixer protocol: one layer-level state API per mixer kind.

The counterpart of ``repro/layers/mixer.py``, reduced to the ops this
slice calls.  A sequence mixer sits between ``norm1`` and the residual add
of a decoder block and exposes

    init_params(gen, cfg)                          parameter dict
    forward(params, x, cfg, positions, plan)       full sequence
    state_init(cfg, batch, max_len, device,        decode state, on the card
               dtype, plan)                        unless ``device`` says
                                                   otherwise; caches that
                                                   follow the activations
                                                   take ``dtype``
    prefill(params, x, cfg, max_len, lengths, ...) prompt -> (out, state);
                                                   ``lengths`` (B,) packs
                                                   right-padded prompts
                                                   with per-row boundary
                                                   states
    decode_step(params, x, state, cfg, ...)        one token on the state;
                                                   ``page_table`` maps
                                                   slots to pool pages
    verify_step(params, x, state, cfg, ...)        n drafted tokens -> per-
                                                   position outputs + the
                                                   pending state
    select_verified(pending, accepted, n, cfg)     accept-prefix rollback

``plan`` is an ``ExecutionPlan`` or a ``BoundExecutor`` bound once.
``resolve_mixers(cfg, plan, platform)`` gives the mixer of each layer from
``cfg.block_kind`` and enforces the plan's demands with the reference's
rejection contract: a packed plan demands ``packable``, a paged plan
``paged_capable``, a training plan (``needs_grad``) ``differentiable``,
a speculative plan (``speculate_k``) ``verify_capable`` and a quantized
``state_dtype`` ``quant_capable`` of every layer's mixer,
and a refusal raises ``MixerResolutionError`` naming each missing
capability in the mixer's own words (``.rejections`` carries them
structured).  The paged spec is a model option: ``resolve_mixers``
strips it from the layers that cannot page (``_narrow_layer_plan``), so
a flow or SSD stack given ``paged=`` serves unpaged, while
``resolve_mixer`` binds one kind to the plan as given and so refuses a
paged plan for a kind that cannot page.  ``stack_capabilities`` gives
the whole stack's verdict per capability.  ``block_ffn``
says whether a layer of the kind has an FFN sublayer after the mixer.
The built-in kinds register on import of their layer modules
(``layers/attention.py`` registers ``attn``, ``layers/ssd.py`` ``ssd``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.attention.recurrent import gather_boundary
from repro_torch.config import ModelConfig
from repro_torch.serving.quant import QUANT_DTYPES, state_dtype_of


def _over(fn, *trees):
    """``fn`` over the tensors of same-shaped state trees (tensors, tuples,
    NamedTuples)."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    parts = [_over(fn, *kids) for kids in zip(*trees)]
    like = trees[0]
    return type(like)(*parts) if hasattr(like, "_fields") else type(like)(parts)


def select_from_trajectory(pending, accepted: torch.Tensor):
    """Gather one boundary per batch row from a trajectory state tree.

    Every tensor of ``pending`` carries a window-position axis at index 1
    (``(B, n, ...)``); ``accepted`` (B,) int selects, per row, the state
    after consuming ``accepted + 1`` window tokens: the generic
    accept-prefix rollback of constant-size states, a gather and never a
    recompute.
    """
    return _over(lambda leaf: gather_boundary(leaf, accepted), pending)


def stack_trajectory(states: list):
    """Stack same-shaped state trees along a new window axis at index 1."""
    return _over(lambda *leaves: torch.stack(leaves, dim=1), *states)


class Mixer:
    """One sequence-mixer kind behind the canonical layer-level ops."""

    kind: str = "?"
    params_field: str = "?"
    block_ffn: bool = True

    def packable(self, cfg: ModelConfig):
        """(ok, reason): can one right-padded prefill return per-row
        boundary states?"""
        return True, "per-row boundary states from one padded call"

    def paged_capable(self, cfg: ModelConfig):
        """(ok, reason): can the decode cache live in the paged KV pool?"""
        return False, "constant-size decode state (nothing to page)"

    def differentiable(self, cfg: ModelConfig, platform: str):
        """(ok, reason): can a training step differentiate the forward on
        ``platform``?"""
        return True, "natively differentiable"

    def verify_capable(self, cfg: ModelConfig):
        """(ok, reason): can the decode state score a drafted window and
        roll back to the accepted prefix (speculative decoding)?  True by
        default: any kind with ``decode_step`` gets the sequential-decode
        verify with trajectory rollback; kinds whose caches destroy
        history (overwriting ring buffers) decline."""
        return True, "trajectory rollback over sequential decode"

    def quant_capable(self, cfg: ModelConfig, platform: str, dtype: str):
        """(ok, reason): can the decode state live in a quantized pool
        (``serving.quant.QuantizedPool``, ``ExecutionPlan.state_dtype``)?
        The default declines, so resolution rejects with a named reason
        instead of a kind silently dequantizing a pool it does not
        understand."""
        return False, (f"no quantized-state decode path (would silently "
                       f"dequantize the {dtype} pool)")

    def init_params(self, gen, cfg: ModelConfig) -> dict:
        raise NotImplementedError(f"{self.kind} does not provide init_params")

    def forward(self, params, x, cfg: ModelConfig, *, positions=None,
                plan=None):
        raise NotImplementedError(f"{self.kind} does not provide forward")

    def state_init(self, cfg: ModelConfig, batch: int, max_len: int, *,
                   device="cuda", dtype=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide state_init")

    def prefill(self, params, x, cfg: ModelConfig, max_len: int, *,
                positions=None, lengths=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide prefill")

    def decode_step(self, params, x, state, cfg: ModelConfig, *,
                    positions=None, page_table=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide decode_step")

    def verify_step(self, params, x, state, cfg: ModelConfig, *,
                    positions=None, page_table=None, plan=None):
        """Score a drafted window of n tokens; return (out, pending).

        ``x`` is (B, n, width): the last committed token then the drafted
        candidates.  ``out`` (B, n, width) matches what n sequential
        ``decode_step`` calls produce; ``pending`` is what
        ``select_verified`` needs to roll the state to any accepted
        prefix.  The default is those n sequential steps with every
        intermediate state stacked along axis 1 into a trajectory: right
        for a constant-size state whose decode returns a new state (the
        SSD state); a kind whose decode updates its state in place
        overrides it (the flow branch verifies in one pass instead).
        """
        out, states = self.decode_window(params, x, state, cfg,
                                         positions=positions,
                                         page_table=page_table, plan=plan)
        return out, stack_trajectory(states)

    def decode_window(self, params, x, state, cfg: ModelConfig, *,
                      positions=None, page_table=None, plan=None):
        """``decode_step`` over each of the window's n positions in turn;
        returns (out (B, n, width), [the state after each position])."""
        outs, states = [], []
        st = state
        for j in range(x.shape[1]):
            pos_j = None if positions is None else positions[:, j:j + 1]
            y, st = self.decode_step(params, x[:, j:j + 1], st, cfg,
                                     positions=pos_j, page_table=page_table,
                                     plan=plan)
            outs.append(y)
            states.append(st)
        return torch.cat(outs, dim=1), states

    def select_verified(self, pending, accepted, n: int, cfg: ModelConfig,
                        *, plan=None):
        """Roll the pending verify state to the accepted prefix.

        ``accepted`` (B,) int in [0, n - 1]: the index of each row's last
        consumed window token (``accepted + 1`` tokens advance).  The
        default pairs with the default ``verify_step``: a trajectory
        gather.
        """
        return select_from_trajectory(pending, accepted)


_REGISTRY: dict[str, Mixer] = {}


def register_mixer(kind: str, impl: Mixer) -> Mixer:
    if kind in _REGISTRY:
        raise ValueError(f"mixer kind {kind!r} already registered")
    impl.kind = kind
    _REGISTRY[kind] = impl
    return impl


def get_mixer(kind: str) -> Mixer:
    import repro_torch.layers.attention  # noqa: F401  registers attn
    import repro_torch.layers.ssd  # noqa: F401  registers ssd

    try:
        return _REGISTRY[kind]
    except KeyError:
        raise NotImplementedError(
            f"mixer kind {kind!r} is not ported yet; ported: "
            f"{tuple(sorted(_REGISTRY))}") from None


class MixerResolutionError(ValueError):
    """A mixer cannot satisfy the plan; ``rejections`` is
    ``((kind, capability, reason), ...)``."""

    def __init__(self, message: str, rejections=()):
        """Store the message plus the per-capability rejections."""
        super().__init__(message)
        self.rejections = tuple(rejections)


def _quant_dtype_of(plan) -> str | None:
    """The plan's quantized state dtype, or None for full-precision pools
    (bf16/fp32 state dtypes are storage choices, not quantization)."""
    sd = state_dtype_of(plan)
    return sd if sd in QUANT_DTYPES else None


def _plan_of(plan):
    """The ``ExecutionPlan`` of a plan or of a ``BoundExecutor``."""
    return getattr(plan, "plan", plan)


def _check_demands(mixer: Mixer, cfg: ModelConfig, plan, platform):
    """Raise unless ``mixer`` meets ``plan``'s demands.  Of the reference's
    plan demands (``repro/layers/mixer.py::_plan_demands``) this port's
    plan carries five: ``packed`` demands ``packable``, ``paged``
    ``paged_capable``, ``needs_grad`` ``differentiable``, ``speculate_k``
    ``verify_capable`` and a quantized state dtype ``quant_capable``."""
    if plan is None:
        return
    plan = _plan_of(plan)
    demands = []
    if plan.packed:
        demands.append(("packable", mixer.packable(cfg)))
    if plan.paged is not None:
        demands.append(("paged_capable", mixer.paged_capable(cfg)))
    if plan.needs_grad:
        demands.append(("differentiable", mixer.differentiable(cfg, platform)))
    if plan.speculate_k:
        demands.append(("verify_capable", mixer.verify_capable(cfg)))
    qd = _quant_dtype_of(plan)
    if qd is not None:
        demands.append(("quant_capable",
                        mixer.quant_capable(cfg, platform, qd)))
    rejections = [(mixer.kind, cap, why)
                  for cap, (ok, why) in demands if not ok]
    if rejections:
        raise MixerResolutionError(
            f"mixer {mixer.kind!r} cannot satisfy {plan.describe()}:\n  "
            + "\n  ".join(f"missing {cap}: {why}"
                          for _, cap, why in rejections), rejections)


def _narrow_layer_plan(mixer: Mixer, cfg: ModelConfig, plan):
    """The model-level plan narrowed to one layer: the paged-pool spec
    binds only layers that can page, so it is stripped (not rejected)
    from the others; ``packed``, ``needs_grad`` and the state dtype are
    whole-stack demands and stay.  A ``BoundExecutor`` whose plan needs no
    narrowing is returned as it is."""
    inner = _plan_of(plan)
    if inner is not None and inner.paged is not None \
            and not mixer.paged_capable(cfg)[0]:
        return dataclasses.replace(inner, paged=None)
    return plan


def resolve_mixer(kind: str, cfg: ModelConfig, plan=None,
                  platform: str | None = None) -> Mixer:
    """The ``Mixer`` of ``kind`` bound to ``plan`` as given: every demand
    it cannot meet raises ``MixerResolutionError`` with its reason (a
    paged plan bound to ``ssd`` reports ``paged_capable: constant-size
    decode state (nothing to page)``)."""
    mixer = get_mixer(kind)
    _check_demands(mixer, cfg, plan, platform)
    return mixer


def resolve_mixers(cfg: ModelConfig, plan=None,
                   platform: str | None = None) -> tuple:
    """The ``Mixer`` of each layer of ``cfg`` (indexable by layer id);
    with ``plan``, each layer's mixer must meet the plan narrowed to it
    (``_narrow_layer_plan``) on ``platform`` ("cuda" or "cpu")."""
    mixers = tuple(get_mixer(cfg.block_kind(i)) for i in range(cfg.n_layers))
    for mx in dict.fromkeys(mixers):
        _check_demands(mx, cfg, _narrow_layer_plan(mx, cfg, plan), platform)
    return mixers


def _capability(mixer: Mixer, cap: str, cfg: ModelConfig, platform: str):
    if cap == "differentiable":
        return mixer.differentiable(cfg, platform)
    if cap == "quant_capable":
        return mixer.quant_capable(cfg, platform, "int8")
    return getattr(mixer, cap)(cfg)


def stack_capabilities(cfg: ModelConfig, platform: str = "cuda") -> dict:
    """The whole stack's verdict per capability, ``{cap: (ok, kind,
    reason)}``: ``packable``, ``differentiable``, ``verify_capable``
    (speculative decoding is all or nothing across a stack) and
    ``quant_capable`` (judged at int8) when every layer has it,
    ``paged_capable`` when at least one layer has it (is a page pool worth
    allocating).  Each verdict carries the first offending (or
    supporting) kind's reason."""
    kinds = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
    verdicts = {}
    for cap, agg in (("packable", all), ("paged_capable", any),
                     ("differentiable", all), ("verify_capable", all),
                     ("quant_capable", all)):
        rows = [(k, *_capability(get_mixer(k), cap, cfg, platform))
                for k in kinds]
        ok = agg(r[1] for r in rows)
        pick = next((r for r in rows if r[1] != (agg is all)), rows[0])
        verdicts[cap] = (ok, pick[0], pick[2])
    return verdicts
