"""The training and serving steps, the counterpart of
``repro/launch/steps.py``.

The attention shapes of a training step, the build-time check that every
layer's mixer and the attention backend are differentiable, and the
distribution plan (``RunPlan``: replicated or ZeRO-sharded compute
params, the microbatch, activation constraints); the steps over a
mesh (``build_train_step``, ``build_prefill_step`` with sequence-parallel
prefill, ``build_decode_step``); and the encoder-decoder's steps
(``model_loss_fn``, ``prefill_step``, ``decode_step``) as plain
functions of (params, batch).

Each ``build_*_step`` makes one attention ``ExecutionPlan`` when it is
called (the gradient need of the train step, the ``ShardSpec`` of
sequence-parallel prefill) and the registry resolves it: they decide
distribution, never which kernel runs the attention.  A mesh is the port's
``distribution.mesh.Mesh``, run from one process: the train step runs
each data-parallel position in turn (``training.train_state.
shard_train_step``), and sequence-parallel prefill runs the
``cp_causal`` glue over the ``model`` axis, whose shard-local causal dot
is K5a on a GPU.  The LM family only: the encoder-decoder's steps stay
the one-device functions below.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import attention
from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.distribution.act_sharding import activation_sharding
from repro_torch.distribution.sharding import (batch_spec, dp_axes,
                                               tree_param_specs,
                                               tree_zero1_specs)
from repro_torch.layers.attention import executor_of, flow_cfg_of, plan_of
from repro_torch.layers.mixer import resolve_mixers
from repro_torch.training.train_state import (TrainConfig, init_train_state,
                                              place_state, shard_train_step)
from repro_torch.utils import tree_map


def _encdec(cfg: ModelConfig):
    """``models.encdec``, after checking that ``cfg`` is an
    encoder-decoder."""
    from repro_torch.models import encdec

    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: the step builders here serve the "
                         f"encoder-decoder, not family {cfg.family!r}")
    return encdec


def model_loss_fn(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """``loss_fn(params, batch)`` of the encoder-decoder in ``dtype``, its
    attention bound once from ``plan``."""
    encdec = _encdec(cfg)
    return functools.partial(encdec.loss_fn, cfg=cfg, dtype=dtype,
                             plan=encdec.executors(cfg, plan))


def training_shapes(cfg: ModelConfig, shape: ShapeSpec) -> attention.ShapeInfo:
    """Static attention shapes of one training step (for plan resolution):
    with MLA, q and k nope + rope wide and v its own width, one kv head a
    query head."""
    if cfg.mla is not None:
        d = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        dv, hq, hkv = cfg.mla.v_head_dim, cfg.n_heads, cfg.n_heads
    else:
        d = dv = cfg.dim_head
        hq, hkv = cfg.n_heads, cfg.kv_heads
    return attention.ShapeInfo(b=max(1, shape.global_batch), hq=hq, hkv=hkv,
                               n=shape.seq_len, m=shape.seq_len, d=d, dv=dv)


def check_flow_trainable(cfg: ModelConfig, shape: ShapeSpec, platform: str,
                         xplan: attention.ExecutionPlan | None = None):
    """The flow attention backend a training step will differentiate on
    ``platform``, or None for a stack without attention layers and for the
    softmax and linear branches, which resolve no flow backend (as in the
    reference): softmax attention is plain PyTorch, and the linear
    branch's causal dot runs K5a and K5b on a CUDA tensor
    (``layers.attention._linear_kernel``).

    In the reference's order: first every layer's mixer is resolved for
    gradients (``MixerResolutionError`` names a mixer that cannot
    differentiate); then, only where some layer is an attention layer, the
    flow backend is resolved for training, raising ``ResolutionError``
    with every backend's reason when none is differentiable (a
    forward-only pin, for instance).  A hybrid stack's "local" slots are
    attention layers in flow mode; in softmax mode they are local rings,
    differentiated in plain PyTorch.  An attention-free stack (an SSD
    stack) resolves no backend: the reference resolves an unused
    ``xla_cumsum`` there, and the port has no such floor -- on the card no
    kernel takes the attention shape such a config implies.
    """
    xplan = xplan if xplan is not None else plan_of(cfg, needs_grad=True)
    resolve_mixers(cfg, xplan, platform)
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    # a hybrid stack's "local" slots are flow attention in flow mode only
    if "attn" not in kinds and not ("local" in kinds
                                    and cfg.attention.kind == "flow"):
        return None
    if cfg.attention.kind != "flow":
        return None

    def resolve(causal):
        plan = attention.ExecutionPlan(flow=flow_cfg_of(cfg, causal=causal),
                                       packed=xplan.packed,
                                       needs_grad=xplan.needs_grad)
        return attention.resolve_for_training(
            plan, training_shapes(cfg, shape), platform)

    be = resolve(True)
    if cfg.family == "encdec":  # the encoder side trains non-causally too
        resolve(False)
    return be


def _dp_spec_axis(dp):
    """The spec entry of a mesh's dp axes: an axis tuple, a single axis
    name, or None (replicated) where the mesh has none."""
    return tuple(dp) if len(dp) > 1 else (dp[0] if dp else None)


def _platform(mesh) -> str:
    return mesh.devices.flat[0].type


def _require_lm(cfg: ModelConfig):
    if cfg.family != "lm":
        raise ValueError(f"{cfg.name}: the steps over a mesh serve the LM "
                         f"family, not {cfg.family!r} (the encoder-decoder "
                         "runs model_loss_fn / prefill_step / decode_step "
                         "on one device)")


@dataclasses.dataclass(frozen=True)
class RunPlan:
    """Distribution plan for one (arch x shape x mesh) cell."""

    param_mode: str = "replicated"  # replicated (dp) | fsdp (zero-sharded)
    microbatch: int = 0
    optimizer: str = "adamw"
    fused_vg: bool = False    # one value-and-grad pass, not two forwards
    act_shard: bool = False   # constrain residuals to (dp, None, None)

    @staticmethod
    def choose(cfg: ModelConfig, shape: ShapeSpec, mesh) -> "RunPlan":
        """The reference's rule, read off ``mesh.shape``: fsdp above ~4 GB
        of bf16 parameters a ``model`` position, and a microbatch that
        keeps each dp position's tokens within 131,072 (32,768 above 5e10
        parameters)."""
        n_params = cfg.param_count()
        model_par = mesh.shape.get("model", 1)
        bf16_per_chip = 2 * n_params / model_par
        param_mode = "fsdp" if bf16_per_chip > 4e9 else "replicated"
        microbatch = 0
        if shape.kind == "train":
            dp = 1
            for a in dp_axes(mesh):
                dp *= mesh.shape[a]
            per_dp_batch = max(1, shape.global_batch // dp)
            tokens = per_dp_batch * shape.seq_len
            budget = 32768 if n_params > 5e10 else 131072
            while tokens > budget and per_dp_batch > 1:
                per_dp_batch //= 2
                tokens = per_dp_batch * shape.seq_len
            microbatch = per_dp_batch * dp
            if microbatch >= shape.global_batch:
                microbatch = 0
        return RunPlan(param_mode=param_mode, microbatch=microbatch)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def train_config(plan: RunPlan, train_overrides: dict | None = None
                 ) -> TrainConfig:
    """The step's ``TrainConfig``: ``plan``'s microbatch, optimizer and
    value-and-grad pass, then ``train_overrides``."""
    tcfg = TrainConfig(microbatch=plan.microbatch, optimizer=plan.optimizer,
                       fused_value_grad=plan.fused_vg)
    return dataclasses.replace(tcfg, **(train_overrides or {}))


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     plan: RunPlan | None = None,
                     train_overrides: dict | None = None):
    """Returns (step, init_state, batch_specs, plan).

    ``step(state, batch) -> (state, metrics)`` over ``mesh``;
    ``init_state(params)`` makes the optimizer state of the fp32
    ``params`` (whole, the port's layout) and places the ``TrainState``
    as ZeRO-1 pieces on the mesh (``train_state.gather_state`` takes it
    back).  ``train_overrides`` replaces fields of the ``TrainConfig``
    (``compute_dtype`` included: the loss runs in it).
    """
    _require_lm(cfg)
    from repro_torch.models import lm

    plan = plan or RunPlan.choose(cfg, shape, mesh)
    platform = _platform(mesh)
    # ONE attention plan for the whole step, built here: a forward-only
    # pin fails now, with every backend's reason
    xplan = plan_of(cfg, needs_grad=True)
    check_flow_trainable(cfg, shape, platform, xplan)
    tcfg = train_config(plan, train_overrides)
    dp = _dp_spec_axis(dp_axes(mesh))
    loss = functools.partial(lm.loss_fn, cfg=cfg, dtype=tcfg.compute_dtype,
                             plan=executor_of(cfg, xplan))
    # either param_mode computes with the master's pieces cast and then
    # gathered: the cast commutes with the gather
    step = shard_train_step(
        loss, tcfg, mesh, layout=cfg,
        act_spec=(dp, None, None) if plan.act_shard else None)
    first = mesh.devices.flat[0]

    def init_state(params):
        master = tree_map(lambda x: x.detach().to(first, torch.float32),
                          params)
        return place_state(init_train_state(master, tcfg, cfg), mesh, cfg)

    baxis = batch_spec(mesh, shape.global_batch)[0]
    batch_specs = {"inputs": (baxis, None), "targets": (baxis, None)}
    if cfg.rope == "mrope":
        batch_specs["positions"] = (baxis, None, None)
    return step, init_state, batch_specs, plan


# ---------------------------------------------------------------------------
# Serve steps (prefill / decode)
# ---------------------------------------------------------------------------
def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       plan: RunPlan | None = None, *,
                       seq_shard: bool = False, dtype=torch.bfloat16):
    """The prefill serve step over ``mesh``: ``step(params, batch) ->
    (last-token logits, caches)`` of ``batch["inputs"]``.  Returns (step,
    param_specs, batch_specs, plan).

    ``seq_shard`` makes prefill sequence-parallel: one sharded
    ``ExecutionPlan`` (``ShardSpec(axis="model", batch_axis=<dp axes>)``)
    binds ``cp_causal`` for every flow layer, which splits the sequence
    over ``model`` inside the attention.  A shape the glue cannot shard
    (N not divisible) falls back to the unsharded plan, with one printed
    line.  The other layers are position-wise and run on whole tensors.
    """
    _require_lm(cfg)
    from repro_torch.models import lm

    plan = plan or RunPlan.choose(cfg, shape, mesh)
    pspecs = tree_zero1_specs if plan.param_mode == "fsdp" \
        else tree_param_specs
    dp = dp_axes(mesh)
    xplan = None
    if seq_shard and cfg.attention.kind == "flow":
        shard = attention.ShardSpec(axis="model", mesh=mesh,
                                    batch_axis=_dp_spec_axis(dp))
        cand = plan_of(cfg, shard=shard)
        try:
            # validate the op this step runs (prefill forces the
            # strict-causal serving competition)
            attention.BoundExecutor(cand).backend(
                "prefill", training_shapes(cfg, shape), _platform(mesh))
            xplan = cand
        except attention.ResolutionError as err:
            print(f"[steps] seq-shard plan fell back to the unsharded plan: "
                  f"{err.rejections[-1] if err.rejections else err}")

    def base_prefill(params, batch):
        return lm.prefill(params, batch["inputs"], cfg, shape.seq_len,
                          dtype=dtype, plan=xplan)

    if plan.act_shard or seq_shard:
        res_spec = (_dp_spec_axis(dp), "model" if seq_shard else None, None)

        def step(params, batch):
            with activation_sharding(res_spec, mesh):
                return base_prefill(params, batch)
    else:
        step = base_prefill
    bspec = batch_spec(mesh, shape.global_batch, seq_sharded=seq_shard)
    return step, (lambda params: pspecs(params, mesh, cfg)), \
        {"inputs": bspec}, plan


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      plan: RunPlan | None = None, *, dtype=torch.bfloat16):
    """The one-token decode serve step over ``mesh``: ``step(params,
    batch) -> (logits, caches)`` of ``batch["token"]``,
    ``batch["caches"]`` and ``batch["pos"]``.  Returns (step, param_specs,
    batch_specs, plan).

    The attention plan has no shard (one position has no sequence axis;
    the O(d^2) state is batch-led), and the batch goes over the dp axes.
    The dp positions' rows share no collective, so the single controller
    runs them as the one joined batch.
    """
    _require_lm(cfg)
    from repro_torch.models import lm

    plan = plan or RunPlan.choose(cfg, shape, mesh)
    xplan = plan_of(cfg)
    pspecs = tree_zero1_specs if plan.param_mode == "fsdp" \
        else tree_param_specs

    def step(params, batch):
        return lm.decode(params, batch["token"], batch["caches"], cfg,
                         batch["pos"], dtype=dtype, plan=xplan)

    baxis = batch_spec(mesh, shape.global_batch)[0]
    return step, (lambda params: pspecs(params, mesh, cfg)), \
        {"token": (baxis, None), "caches": (baxis,), "pos": ()}, plan


def prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """The serve step that consumes the inputs: ``encdec.encode`` of
    ``batch["frames"]``, which returns the memory."""
    encdec = _encdec(cfg)
    ex = encdec.executors(cfg, plan)

    def step(params, batch):
        return encdec.encode(params, batch["frames"], cfg, dtype=dtype,
                             plan=ex)
    return step


def decode_step(cfg: ModelConfig, *, dtype=torch.bfloat16, plan=None):
    """The one-token serve step: ``encdec.decode_step`` of
    ``batch["token"]`` on ``batch["memory"]``, ``batch["caches"]`` and
    ``batch["pos"]``, returning (logits, caches)."""
    encdec = _encdec(cfg)
    ex = encdec.executors(cfg, plan)

    def step(params, batch):
        return encdec.decode_step(params, batch["token"], batch["memory"],
                                  batch["caches"], cfg, batch["pos"],
                                  dtype=dtype, plan=ex)
    return step
