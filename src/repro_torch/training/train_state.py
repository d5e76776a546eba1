"""TrainConfig, TrainState and the train step, the counterpart of
``repro/training/train_state.py`` on one device.

The step casts the fp32 master parameters to ``compute_dtype`` (bf16 by
default), differentiates the loss with respect to the cast parameters,
casts the gradients to fp32 and runs the optimizer (AdamW, or Adafactor
in the reference's stacked layout) on the master.  With
``microbatch`` the batch is split and the fp32 gradients accumulated, as
the reference's scan over microbatches does.  Sharding the step over a
mesh (``shard_train_step``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.training import optimizer as opt_lib
from repro_torch.training import schedule as sched_lib
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
    adamw_cfg = opt_lib.AdamWConfig(grad_clip=tcfg.grad_clip,
                                    weight_decay=tcfg.weight_decay)

    def value_and_grad(params, mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter([g.float() for g in grads])
        return metrics, tree_map(lambda _: next(it), params)

    def detached(metrics):
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict):
        params = tree_map(lambda x: x.detach().requires_grad_(True),
                          tree_cast(state.master, tcfg.compute_dtype))
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

        lr = _lr(state.step, tcfg)
        if tcfg.optimizer == "adamw":
            new_master, new_opt, stats = opt_lib.adamw_update(
                grads, state.opt, state.master, lr, adamw_cfg, decay)
        else:
            new_master, new_opt, stats = opt_lib.adafactor_update(
                grads, state.opt, state.master, lr,
                opt_lib.AdafactorConfig(weight_decay=tcfg.weight_decay),
                layout)
        metrics = {**metrics, **stats, "lr": lr}
        return TrainState(new_master, new_opt, state.step + 1), metrics

    return train_step
