"""Train and evaluate the encoder classifier on one device.

    python -m repro_torch.launch.classify                  # full width, GPU
    python -m repro_torch.launch.classify --smoke --device cpu

The counterpart of ``benchmarks/common.py::train_eval_classifier`` (lines
33-83) for the port: the same numpy batch draw, warmup-cosine schedule,
AdamW (``weight_decay=0.01, grad_clip=1.0``, decaying every leaf with
ndim >= 2, as the reference's ``adamw_update`` does with no mask) and
eval loop.  The gradients are taken with respect to the fp32 master
parameters, which the forward casts to ``dtype`` at each use, as the
reference's loss does.  Attention is non-causal and resolved once, for
gradients: on a GPU every attention forward runs kernel K6 and every
attention backward K7b.  ``main`` trains ``flowformer_lra`` on
``listops`` (the LRA ListOps stand-in) with random weights from a seed.
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.attention import ShapeInfo, resolve_for_training
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import PAD, listops
from repro_torch.layers.attention import executor_of, plan_of
from repro_torch.models import classifier
from repro_torch.training.train_state import (TrainConfig, init_train_state,
                                              make_train_step)
from repro_torch.utils import resolve_device, tree_leaves, tree_map

# Examples per evaluation batch, as the reference's loop fixes it
# (``benchmarks/common.py:71``).
EVAL_BATCH = 64


def _batch(data: dict, idx, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(dev)
            for k, v in data.items()}


def make_classifier_step(cfg: ModelConfig, *, steps: int, lr: float = 1e-3,
                         dtype=torch.bfloat16):
    """The reference's classifier training step (``benchmarks/common.py:
    39-59``): loss and gradients w.r.t. the fp32 master parameters, then
    AdamW at ``warmup_cosine(peak_lr=lr, warmup=max(steps // 20, 5),
    total=steps)``.  Attention is bound once, for gradients.  Returns
    ``(step_fn, tcfg)``: ``step_fn(state, batch) -> (state, metrics)`` on a
    ``init_train_state(params, tcfg)`` state."""
    tcfg = TrainConfig(peak_lr=lr, warmup=max(steps // 20, 5),
                       total_steps=steps, weight_decay=0.01, grad_clip=1.0,
                       compute_dtype=torch.float32, fused_value_grad=True)
    xplan = plan_of(cfg, causal=False, needs_grad=True)
    loss = functools.partial(classifier.loss_fn, cfg=cfg, dtype=dtype,
                             plan=executor_of(cfg, xplan, causal=False))
    return make_train_step(loss, tcfg), tcfg


def train_eval_classifier(cfg: ModelConfig, train_data: dict, eval_data: dict,
                          *, n_classes: int, steps: int, batch: int,
                          in_dim: int = 0, lr: float = 1e-3, seed: int = 0,
                          log_every: int = 0, device="cuda",
                          dtype=torch.bfloat16,
                          params: dict | None = None) -> dict:
    """Train ``steps`` steps of ``batch`` examples drawn from ``train_data``
    ({"inputs", "labels", "mask" optional} numpy arrays), then evaluate on
    ``eval_data`` in batches of ``EVAL_BATCH``.

    ``params`` (fp32, any device) replaces the random init from ``seed``.
    Returns {"acc", "loss" (eval), "train_time_s", "steps_per_s"} as the
    reference does, plus "history" (per-step training losses), "step_s"
    (per-step wall seconds) and "eval_s" (the evaluation's wall seconds).
    """
    dev = resolve_device(device)
    if params is None:
        params = classifier.init(cfg, torch.Generator().manual_seed(seed),
                                 n_classes=n_classes, in_dim=in_dim,
                                 device=dev)
    params = tree_map(lambda x: x.detach().to(dev, torch.float32), params)
    n, seq = train_data["inputs"].shape[:2]
    xplan = plan_of(cfg, causal=False, needs_grad=True)
    be = resolve_for_training(xplan, ShapeInfo(
        b=batch, hq=cfg.n_heads, hkv=cfg.kv_heads, n=seq, m=seq,
        d=cfg.dim_head, dv=cfg.dim_head), dev.type)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[classify] {cfg.name}: {n_params:,} params on {dev}, "
          f"{str(dtype)[6:]} compute; attention {xplan.describe()} -> "
          f"{be.name}")

    step_fn, tcfg = make_classifier_step(cfg, steps=steps, lr=lr, dtype=dtype)
    state = init_train_state(params, tcfg)
    rng = np.random.default_rng(seed)
    history, step_s = [], []
    t_start = time.perf_counter()
    for s in range(steps):
        bt = _batch(train_data, rng.integers(0, n, batch), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, bt)
        history.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if log_every and s % log_every == 0:
            print(f"    step {s} loss={history[-1]:.3f}")
    train_time = time.perf_counter() - t_start

    ex_eval = executor_of(cfg, plan_of(cfg, causal=False), causal=False)
    t_eval = time.perf_counter()
    ne = len(eval_data["inputs"])
    accs, losses = [], []
    with torch.no_grad():
        for i in range(0, ne, EVAL_BATCH):
            bt = _batch(eval_data, slice(i, i + EVAL_BATCH), dev)
            _, m = classifier.loss_fn(state.master, bt, cfg, dtype=dtype,
                                      plan=ex_eval)
            nb = len(bt["inputs"])
            accs.append(float(m["acc"]) * nb)
            losses.append(float(m["loss"]) * nb)
    return {
        "acc": sum(accs) / ne,
        "loss": sum(losses) / ne,
        "train_time_s": round(train_time, 2),
        "steps_per_s": round(steps / train_time, 2),
        "history": history,
        "step_s": step_s,
        "eval_s": time.perf_counter() - t_eval,
    }


def listops_data(n_train: int, n_eval: int, *, seq: int, seed: int = 0):
    """ListOps train and eval splits, masked by ``!= PAD`` for pooling."""
    xs, ys = listops(seed, n_train + n_eval, seq=seq)
    mask = (xs != PAD).astype(np.float32)
    split = lambda sl: {"inputs": xs[sl], "labels": ys[sl],  # noqa: E731
                        "mask": mask[sl]}
    return split(slice(0, n_train)), split(slice(n_train, None))


def main():
    ap = argparse.ArgumentParser(
        description="Train and evaluate the flow-attention encoder "
        "classifier on synthetic ListOps (random weights from --seed).")
    ap.add_argument("--arch", default="flowformer-lra")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, 8 x 256 tokens by default")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    steps = args.steps or (5 if args.smoke else 20)
    batch = args.batch or (8 if args.smoke else 32)
    seq = args.seq or (256 if args.smoke else cfg.max_seq_len)
    train_data, eval_data = listops_data(args.n_train, args.n_eval, seq=seq,
                                         seed=args.seed)
    out = train_eval_classifier(cfg, train_data, eval_data, n_classes=10,
                                steps=steps, batch=batch, seed=args.seed,
                                log_every=1, device=args.device)
    print(f"[classify] done: eval acc={out['acc']:.4f} loss={out['loss']:.4f} "
          f"({out['train_time_s']} s training)")


if __name__ == "__main__":
    main()
