"""SequenceMixer protocol: one layer-level state API per mixer kind.

The counterpart of ``repro/layers/mixer.py``, reduced to the ops this
slice calls.  A sequence mixer sits between ``norm1`` and the residual add
of a decoder block and exposes

    init_params(gen, cfg)                          parameter dict
    forward(params, x, cfg, positions, plan)       full sequence
    state_init(cfg, batch, max_len, device, plan)  decode state
    prefill(params, x, cfg, max_len, lengths, ...) prompt -> (out, state);
                                                   ``lengths`` (B,) packs
                                                   right-padded prompts
                                                   with per-row boundary
                                                   states
    decode_step(params, x, state, cfg, ...)        one token on the state

``plan`` is an ``ExecutionPlan`` or a ``BoundExecutor`` bound once.
``resolve_mixers(cfg)`` gives the mixer of each layer from
``cfg.block_kind``; the built-in kinds register on import of their layer
modules (``layers/attention.py`` registers ``attn``).
"""
from __future__ import annotations

from repro_torch.config import ModelConfig


class Mixer:
    """One sequence-mixer kind behind the canonical layer-level ops."""

    kind: str = "?"
    params_field: str = "?"

    def init_params(self, gen, cfg: ModelConfig) -> dict:
        raise NotImplementedError(f"{self.kind} does not provide init_params")

    def forward(self, params, x, cfg: ModelConfig, *, positions=None,
                plan=None):
        raise NotImplementedError(f"{self.kind} does not provide forward")

    def state_init(self, cfg: ModelConfig, batch: int, max_len: int, *,
                   device=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide state_init")

    def prefill(self, params, x, cfg: ModelConfig, max_len: int, *,
                positions=None, lengths=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide prefill")

    def decode_step(self, params, x, state, cfg: ModelConfig, *,
                    positions=None, plan=None):
        raise NotImplementedError(f"{self.kind} does not provide decode_step")


_REGISTRY: dict[str, Mixer] = {}


def register_mixer(kind: str, impl: Mixer) -> Mixer:
    if kind in _REGISTRY:
        raise ValueError(f"mixer kind {kind!r} already registered")
    impl.kind = kind
    _REGISTRY[kind] = impl
    return impl


def get_mixer(kind: str) -> Mixer:
    import repro_torch.layers.attention  # noqa: F401  registers attn

    try:
        return _REGISTRY[kind]
    except KeyError:
        raise NotImplementedError(
            f"mixer kind {kind!r} is not ported yet; ported: "
            f"{tuple(sorted(_REGISTRY))}") from None


def resolve_mixers(cfg: ModelConfig) -> tuple:
    """The ``Mixer`` of each layer of ``cfg`` (indexable by layer id)."""
    return tuple(get_mixer(cfg.block_kind(i)) for i in range(cfg.n_layers))
