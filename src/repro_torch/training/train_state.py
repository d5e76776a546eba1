"""TrainConfig, TrainState and the train steps, the counterpart of
``repro/training/train_state.py``.

``make_train_step`` is the step on one device.  It casts the fp32 master
parameters to ``compute_dtype`` (bf16 by default), differentiates the
loss with respect to the cast parameters, casts the gradients to fp32
and runs the optimizer (AdamW, or Adafactor in the reference's stacked
layout) on the master.  With ``microbatch`` the batch is split and the
fp32 gradients accumulated, as the reference's scan over microbatches
does.

``shard_train_step`` is the step over a mesh (``distribution.mesh``).
The reference jits the step with ZeRO-1 in/out shardings and lets GSPMD
place the collectives.  The port runs it from one process: the fp32
master and the optimizer moments live as ZeRO-1 pieces
(``distribution.sharding.tree_zero1_specs``, in the reference's stacked
layout; ``place_state``); each data-parallel position runs the loss and
gradient above, microbatches included, on its slice of the batch, in
rank order; the gradients are averaged over the dp axes in rank order
(``distribution.collectives.psum``); the master and the moments are
gathered whole, still stacked, for the update, whose arithmetic is the
one-device code, so Adafactor's factored statistics see the whole
stacked leaf; and the result is placed again.  Positions along
``model`` would hold replicas of the same gradients, so they run nothing
of their own.  A caller keeps the placed state across steps:
``launch.train.train`` gathers it only for its result, and a checkpoint
saves and restores ``Placed`` leaves whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.distribution.act_sharding import activation_sharding
from repro_torch.distribution.collectives import psum
from repro_torch.distribution.sharding import (Placed, batch_spec, dp_axes,
                                               gather, leaf_paths, param_spec,
                                               place, tree_zero1_specs,
                                               zero1_spec)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import schedule as sched_lib
from repro_torch.training.optimizer import stack_layers, unstack_layers
from repro_torch.utils import tree_cast, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | invsqrt | constant
    microbatch: int = 0  # 0 = no accumulation (single microbatch)
    grad_clip: float = 1.0
    weight_decay: float = 0.1
    compute_dtype: Any = torch.bfloat16
    # one value-and-grad pass; False adds the reference's separate
    # metrics forward
    fused_value_grad: bool = False


class TrainState(NamedTuple):
    master: dict  # fp32 params
    opt: Any  # optimizer state
    step: int


def init_train_state(params_fp32: dict, tcfg: TrainConfig,
                     layout=None) -> TrainState:
    """``layout`` is the LM's config, whose stacked layout Adafactor's
    moments take (``optimizer.adafactor_init``); AdamW ignores it."""
    if tcfg.optimizer == "adamw":
        opt = opt_lib.adamw_init(params_fp32)
    elif tcfg.optimizer == "adafactor":
        opt = opt_lib.adafactor_init(params_fp32, layout)
    else:
        raise ValueError(tcfg.optimizer)
    return TrainState(master=params_fp32, opt=opt, step=0)


def _lr(step, tcfg: TrainConfig) -> torch.Tensor:
    if tcfg.schedule == "cosine":
        return sched_lib.warmup_cosine(step, peak_lr=tcfg.peak_lr,
                                       warmup=tcfg.warmup,
                                       total=tcfg.total_steps)
    if tcfg.schedule == "invsqrt":
        return sched_lib.warmup_invsqrt(step, peak_lr=tcfg.peak_lr,
                                        warmup=tcfg.warmup)
    return sched_lib.constant(step, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup)


def _tree_add(a, b):
    it = iter([x + y for x, y in zip(tree_leaves(a), tree_leaves(b))])
    return tree_map(lambda _: next(it), a)


def _grads_fn(loss_fn: Callable, tcfg: TrainConfig):
    """``(params, batch) -> (metrics, fp32 grads)`` of the compute-dtype
    ``params``: the step's loss and gradient, microbatches included."""
    def value_and_grad(params, mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter([g.float() for g in grads])
        return metrics, tree_map(lambda _: next(it), params)

    def detached(metrics):
        return {k: v.detach() for k, v in metrics.items()}

    def grads_fn(params, batch: dict):
        first = next(iter(batch.values()))  # every leaf leads with the batch
        n_micro = tcfg.microbatch and max(1, first.shape[0] // tcfg.microbatch)
        if n_micro and n_micro > 1:
            mbs = [{k: v.chunk(n_micro)[i] for k, v in batch.items()}
                   for i in range(n_micro)]
            grads, stack = None, []
            for mb in mbs:
                metrics, g = value_and_grad(params, mb)
                stack.append(detached(metrics))
                grads = g if grads is None else _tree_add(grads, g)
            grads = tree_map(lambda g: g / n_micro, grads)
            if tcfg.fused_value_grad:
                metrics = {k: torch.stack([m[k] for m in stack]).mean()
                           for k in stack[0]}
            else:
                with torch.no_grad():
                    metrics = detached(loss_fn(params, mbs[0])[1])
        else:
            if tcfg.fused_value_grad:
                metrics, grads = value_and_grad(params, batch)
            else:
                with torch.no_grad():
                    metrics = loss_fn(params, batch)[1]
                _, grads = value_and_grad(params, batch)
            metrics = detached(metrics)
        return metrics, grads

    return grads_fn


def _update_fn(tcfg: TrainConfig, layout):
    """``(state, grads, decay) -> (master, opt, stats, lr)``: the
    optimizer step on whole fp32 leaves."""
    adamw_cfg = opt_lib.AdamWConfig(grad_clip=tcfg.grad_clip,
                                    weight_decay=tcfg.weight_decay)

    def update(state: TrainState, grads, decay):
        lr = _lr(state.step, tcfg)
        if tcfg.optimizer == "adamw":
            master, opt, stats = opt_lib.adamw_update(
                grads, state.opt, state.master, lr, adamw_cfg, decay)
        else:
            master, opt, stats = opt_lib.adafactor_update(
                grads, state.opt, state.master, lr,
                opt_lib.AdafactorConfig(weight_decay=tcfg.weight_decay),
                layout)
        return master, opt, stats, lr

    return update


def _compute_params(master, dtype):
    return tree_map(lambda x: x.detach().requires_grad_(True),
                    tree_cast(master, dtype))


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, *, decay=None,
                    layout=None):
    """Build the train step: (state, batch) -> (state, metrics).

    ``loss_fn(params, batch) -> (loss, metrics)`` takes the parameters in
    ``compute_dtype``; ``decay`` is the weight-decay mask for
    ``adamw_update`` (``optimizer.decay_mask``), ``layout`` the LM config
    whose stacked layout ``adafactor_update`` computes on (as
    ``init_train_state`` was given it).  Metrics are detached tensors:
    reading one is the step's only host synchronization.
    """
    grads_fn = _grads_fn(loss_fn, tcfg)
    update = _update_fn(tcfg, layout)

    def train_step(state: TrainState, batch: dict):
        params = _compute_params(state.master, tcfg.compute_dtype)
        metrics, grads = grads_fn(params, batch)
        master, opt, stats, lr = update(state, grads, decay)
        metrics = {**metrics, **stats, "lr": lr}
        return TrainState(master, opt, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# The step over a mesh
# ---------------------------------------------------------------------------
def _opt_leaf_specs(opt_tree, params_stacked, mesh):
    """Specs for one optimizer-state field (in the stacked layout): a
    leaf shaped like its parameter takes the parameter's ZeRO-1 spec, a
    factored Adafactor moment is replicated."""
    flat_p = leaf_paths(params_stacked)
    flat_o = leaf_paths(opt_tree)
    specs = []
    for (_, oleaf), (path, pleaf) in zip(flat_o, flat_p):
        if tuple(oleaf.shape) == tuple(pleaf.shape):
            specs.append(zero1_spec(param_spec(path, tuple(pleaf.shape), mesh),
                                    tuple(pleaf.shape), mesh))
        else:  # factored Adafactor rows / columns, or a 0-d placeholder
            specs.append((None,) * oleaf.ndim)
    it = iter(specs)
    return tree_map(lambda _: next(it), opt_tree)


def _place_stacked(state: TrainState, mesh, specs=None) -> TrainState:
    """``state``, already in the stacked layout, as ZeRO-1 pieces over
    ``mesh``; ``specs`` (the master's ``tree_zero1_specs``) is computed
    when None."""
    if specs is None:
        specs = tree_zero1_specs(state.master, mesh)
    master = place(state.master, specs, mesh)
    opt = state.opt
    if isinstance(opt, opt_lib.AdamWState):
        opt = opt_lib.AdamWState(place(opt.m, specs, mesh),
                                 place(opt.v, specs, mesh), opt.step)
    else:
        shapes = tree_map(lambda x: x.to("meta"), state.master)
        opt = opt_lib.AdafactorState(
            place(opt.vr, _opt_leaf_specs(opt.vr, shapes, mesh), mesh),
            place(opt.vc, _opt_leaf_specs(opt.vc, shapes, mesh), mesh),
            opt.step)
    return TrainState(master, opt, state.step)


def _gather_stacked(state: TrainState) -> TrainState:
    """The inverse of ``_place_stacked``: whole leaves, stacked."""
    opt = state.opt
    if isinstance(opt, opt_lib.AdamWState):
        opt = opt_lib.AdamWState(gather(opt.m), gather(opt.v), opt.step)
    else:
        opt = opt_lib.AdafactorState(gather(opt.vr), gather(opt.vc),
                                     opt.step)
    return TrainState(gather(state.master), opt, state.step)


def place_state(state: TrainState, mesh, layout=None) -> TrainState:
    """``state`` (whole tensors, the port's layout) as ZeRO-1 pieces over
    ``mesh``: the master and AdamW's moments by ``tree_zero1_specs`` in
    the stacked layout of ``layout``, Adafactor's moments (stacked
    already) by ``_opt_leaf_specs``."""
    opt = state.opt
    if isinstance(opt, opt_lib.AdamWState):
        opt = opt_lib.AdamWState(stack_layers(opt.m, layout),
                                 stack_layers(opt.v, layout), opt.step)
    return _place_stacked(TrainState(stack_layers(state.master, layout), opt,
                                     state.step), mesh)


def gather_state(state: TrainState, layout=None) -> TrainState:
    """The inverse of ``place_state``: whole tensors in the port's
    layout, bitwise."""
    whole = _gather_stacked(state)
    opt = whole.opt
    if isinstance(opt, opt_lib.AdamWState):
        opt = opt_lib.AdamWState(unstack_layers(opt.m, layout),
                                 unstack_layers(opt.v, layout), opt.step)
    return TrainState(unstack_layers(whole.master, layout), opt, state.step)


def _dp_slices(batch: dict, n_micro: int, dp: int) -> list:
    """Each dp position's rows: every microbatch split over the positions,
    as the reference's reshape of a dp-sharded batch into microbatches
    gives them (contiguous slices without microbatches)."""
    out = []
    for p in range(dp):
        piece = {}
        for k, x in batch.items():
            mbs = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
            piece[k] = mbs.chunk(dp, dim=1)[p].reshape(-1, *x.shape[1:])
        out.append(piece)
    return out


def shard_train_step(loss_fn: Callable, tcfg: TrainConfig, mesh, *,
                     layout=None, act_spec: tuple | None = None):
    """The train step over ``mesh``: (placed state, batch) -> (placed
    state, metrics), ``place_state``'s state in and out.

    The compute parameters are the master's ZeRO-1 pieces cast to the
    compute dtype, then gathered (the reference's ZeRO-sharded compute
    params; the cast commutes with the gather, so a replicated plan gets
    the same parameters).  The update runs on the gathered whole leaves
    in the stacked layout of ``layout``, where AdamW's default decay
    rule (``ndim >= 2``) is the reference's and Adafactor factors each
    stacked leaf, and its result is placed again.  ``act_spec``
    activates ``activation_sharding`` with that residual spec around
    each position's loss.  Metrics are averaged over the dp positions in
    rank order, ``tokens`` summed.
    """
    dp_axes_ = dp_axes(mesh)
    dp = mesh.axes_size(dp_axes_)
    update = _update_fn(tcfg, None)  # the leaves come stacked
    coords = mesh.coords(dp_axes_)
    specs = {}

    def grads_fn_for(n_pos):
        micro = tcfg.microbatch // n_pos if tcfg.microbatch else 0
        return _grads_fn(loss_fn, dataclasses.replace(tcfg, microbatch=micro))

    def run(fn, params, batch):
        if act_spec is None:
            return fn(params, batch)
        with activation_sharding(act_spec, mesh):
            return fn(params, batch)

    def train_step(state: TrainState, batch: dict):
        compute = unstack_layers(gather(tree_map(
            lambda p: Placed(p.spec, p.mesh, p.shape,
                             [x.to(tcfg.compute_dtype) for x in p.pieces]),
            state.master)), layout)
        first = next(iter(batch.values()))
        b = first.shape[0]
        n_micro = tcfg.microbatch and max(1, b // tcfg.microbatch)
        n_micro = n_micro or 1
        # a batch the dp axes do not divide is replicated (batch_spec)
        n_pos = dp if batch_spec(mesh, b)[0] is not None and \
            b % (n_micro * dp) == 0 else 1
        grads_fn = grads_fn_for(n_pos)
        metrics, grads = [], []
        for coord, piece in zip(coords, _dp_slices(batch, n_micro, n_pos)):
            dev = mesh.device_at(coord)
            params = tree_map(lambda x: x.detach().to(dev).requires_grad_(True),
                              compute)
            m, g = run(grads_fn, params,
                       {k: v.to(dev) for k, v in piece.items()})
            metrics.append(m)
            grads.append(g)
        del compute, params
        if n_pos > 1:
            flat = [tree_leaves(g) for g in grads]
            summed = [psum([f[j] for f in flat], mesh, dp_axes_,
                           over=dp_axes_)[0] for j in range(len(flat[0]))]
            it = iter([s / n_pos for s in summed])
            mean_grads = tree_map(lambda _: next(it), grads[0])
            metrics = {k: (psum([m[k] for m in metrics], mesh, dp_axes_,
                                over=dp_axes_)[0]
                           / (1 if k == "tokens" else n_pos))
                       for k in metrics[0]}
            del flat, summed
        else:
            mean_grads, metrics = grads[0], metrics[0]
        del grads
        mean_grads = stack_layers(mean_grads, layout)
        master, opt, stats, lr = update(_gather_stacked(state), mean_grads,
                                        None)
        new = TrainState(master, opt, state.step + 1)
        if "z" not in specs:
            specs["z"] = tree_zero1_specs(master, mesh)
        return (_place_stacked(new, mesh, specs["z"]),
                {**metrics, **stats, "lr": lr})

    return train_step
