"""Train and evaluate the encoder classifiers on one device.

    python -m repro_torch.launch.classify                  # full width, GPU
    python -m repro_torch.launch.classify --smoke --device cpu
    python -m repro_torch.launch.classify --arch flowformer-vision
    python -m repro_torch.launch.classify --arch flowformer-timeseries

The counterpart of ``benchmarks/common.py::train_eval_classifier`` (lines
33-83) for the port: the same numpy batch draw, warmup-cosine schedule,
AdamW (``weight_decay=0.01, grad_clip=1.0``, decaying every leaf with
ndim >= 2, as the reference's ``adamw_update`` does with no mask) and
eval loop, for any model given by its ``init`` and ``loss_fn`` (by default
the encoder classifier).  The gradients are taken with respect to the fp32
master parameters, which the forward casts to ``dtype`` at each use, as
the reference's loss does.  Attention is non-causal and resolved once, for
gradients, at each attention shape of the model: on a GPU every attention
forward runs kernel K6 and every attention backward K7b.

``main`` trains, with random weights from a seed, one of three tasks:
``flowformer-lra`` on ``listops`` (the LRA ListOps stand-in), as before;
``flowformer-timeseries`` on ``timeseries`` (the UEA stand-in, ``--dims``
features into the classifier's ``in_proj``, 6 classes), as
``benchmarks/timeseries_table6.py`` does; ``flowformer-vision`` on
``pixel_images(channels=3)`` at ``--size`` (the ImageNet stand-in), as
``benchmarks/vision_table5.py`` does.
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
from repro_torch.data.synthetic import PAD, listops, pixel_images, timeseries
from repro_torch.layers.attention import executor_of, plan_of
from repro_torch.models import classifier, vision
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
                         dtype=torch.bfloat16, loss_fn=None):
    """The reference's classifier training step (``benchmarks/common.py:
    39-59``): loss and gradients w.r.t. the fp32 master parameters, then
    AdamW at ``warmup_cosine(peak_lr=lr, warmup=max(steps // 20, 5),
    total=steps)``.  Attention is bound once, for gradients.  ``loss_fn``
    (params, batch, cfg, *, dtype, plan) is the model's, by default the
    encoder classifier's.  Returns ``(step_fn, tcfg)``: ``step_fn(state,
    batch) -> (state, metrics)`` on a ``init_train_state(params, tcfg)``
    state."""
    tcfg = TrainConfig(peak_lr=lr, warmup=max(steps // 20, 5),
                       total_steps=steps, weight_decay=0.01, grad_clip=1.0,
                       compute_dtype=torch.float32, fused_value_grad=True)
    xplan = plan_of(cfg, causal=False, needs_grad=True)
    loss = functools.partial(loss_fn or classifier.loss_fn, cfg=cfg,
                             dtype=dtype,
                             plan=executor_of(cfg, xplan, causal=False))
    return make_train_step(loss, tcfg), tcfg


def train_eval_classifier(cfg: ModelConfig, train_data: dict, eval_data: dict,
                          *, n_classes: int | None = None, steps: int,
                          batch: int,
                          in_dim: int = 0, lr: float = 1e-3, seed: int = 0,
                          log_every: int = 0, device="cuda",
                          dtype=torch.bfloat16,
                          params: dict | None = None, init_fn=None,
                          loss_fn=None, attn_shapes=None) -> dict:
    """Train ``steps`` steps of ``batch`` examples drawn from ``train_data``
    (numpy arrays: {"inputs", "labels", "mask" optional} for the encoder
    classifier), then evaluate on ``eval_data`` in batches of
    ``EVAL_BATCH``.

    The model is the encoder classifier (``n_classes`` and ``in_dim`` for
    its init) unless ``init_fn`` (generator, device) -> params and
    ``loss_fn`` (params, batch, cfg, *, dtype, plan) give another, as the
    reference's harness takes them; ``attn_shapes`` (a list of
    ``ShapeInfo``) are then its attention calls' shapes, each resolved once
    for gradients before the first step.  ``params`` (fp32, any device)
    replaces the random init from ``seed``.  Returns {"acc", "loss"
    (eval), "train_time_s", "steps_per_s"} as the reference does, plus
    "history" (per-step training losses), "step_s" (per-step wall
    seconds), "eval_s" (the evaluation's wall seconds) and "backends"
    (the backend bound at each attention shape).
    """
    dev = resolve_device(device)
    if init_fn is None:
        if n_classes is None:
            raise TypeError("the encoder classifier needs n_classes")
        init_fn = functools.partial(classifier.init, cfg, n_classes=n_classes,
                                    in_dim=in_dim)
        seq = train_data["inputs"].shape[1]
        attn_shapes = attn_shapes or [ShapeInfo(
            b=batch, hq=cfg.n_heads, hkv=cfg.kv_heads, n=seq, m=seq,
            d=cfg.dim_head, dv=cfg.dim_head)]
    if params is None:
        params = init_fn(torch.Generator().manual_seed(seed), device=dev)
    params = tree_map(lambda x: x.detach().to(dev, torch.float32), params)
    n = len(train_data["labels"])
    xplan = plan_of(cfg, causal=False, needs_grad=True)
    attn_shapes = attn_shapes or []
    bound = [resolve_for_training(xplan, shapes, dev.type).name
             for shapes in attn_shapes]
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[classify] {cfg.name}: {n_params:,} params on {dev}, "
          f"{str(dtype)[6:]} compute; attention {xplan.describe()} -> "
          + ", ".join(f"{name} (N={s.n}, D={s.d})"
                      for name, s in zip(bound, attn_shapes)))

    loss_fn = loss_fn or classifier.loss_fn
    step_fn, tcfg = make_classifier_step(cfg, steps=steps, lr=lr, dtype=dtype,
                                         loss_fn=loss_fn)
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
    ne = len(eval_data["labels"])
    accs, losses = [], []
    with torch.no_grad():
        for i in range(0, ne, EVAL_BATCH):
            bt = _batch(eval_data, slice(i, i + EVAL_BATCH), dev)
            _, m = loss_fn(state.master, bt, cfg, dtype=dtype, plan=ex_eval)
            nb = len(bt["labels"])
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
        "backends": bound,
    }


def listops_data(n_train: int, n_eval: int, *, seq: int, seed: int = 0):
    """ListOps train and eval splits, masked by ``!= PAD`` for pooling."""
    xs, ys = listops(seed, n_train + n_eval, seq=seq)
    mask = (xs != PAD).astype(np.float32)
    split = lambda sl: {"inputs": xs[sl], "labels": ys[sl],  # noqa: E731
                        "mask": mask[sl]}
    return split(slice(0, n_train)), split(slice(n_train, None))


def timeseries_data(n_train: int, n_eval: int, *, length: int, dims: int,
                    n_classes: int, seed: int = 0):
    """UEA-style train and eval splits of ``dims``-dimensional series."""
    xs, ys = timeseries(seed, n_train + n_eval, length=length, dims=dims,
                        n_classes=n_classes)
    split = lambda sl: {"inputs": xs[sl], "labels": ys[sl]}  # noqa: E731
    return split(slice(0, n_train)), split(slice(n_train, None))


def vision_data(n_train: int, n_eval: int, *, size: int, n_classes: int,
                seed: int = 0):
    """ImageNet stand-in splits: (size, size, 3) textures in [0, 1]."""
    xs, ys = pixel_images(seed, n_train + n_eval, size=size,
                          n_classes=n_classes, channels=3)
    split = lambda sl: {"images": xs[sl], "labels": ys[sl]}  # noqa: E731
    return split(slice(0, n_train)), split(slice(n_train, None))


#: the time-series task's classes (``timeseries_table6.py``'s freqmix6)
TS_CLASSES = 6


def run(arch: str = "flowformer-lra", *, smoke: bool = False,
        steps: int | None = None, batch: int | None = None,
        seq: int | None = None, size: int | None = None, dims: int = 8,
        n_train: int = 512, n_eval: int = 64, seed: int = 0,
        log_every: int = 1, device="cuda") -> dict:
    """One task of ``main``: its config (full width, or ``smoke``), its
    synthetic data from ``seed`` and ``train_eval_classifier``.  ``seq`` is
    the LRA tokens or the series' length, ``size`` the images' side; the
    defaults are the full run's (``smoke``: 5 steps of a small batch)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    steps = steps or (5 if smoke else 20)
    name = arch.replace("_", "-")
    if name == "flowformer-vision":
        size = size or (32 if smoke else 224)
        batch = batch or (8 if smoke else 64)
        train_data, eval_data = vision_data(n_train, n_eval, size=size,
                                            n_classes=cfg.n_classes, seed=seed)
        return train_eval_classifier(
            cfg, train_data, eval_data, steps=steps, batch=batch, seed=seed,
            log_every=log_every, device=dev,
            init_fn=functools.partial(vision.init, cfg),
            loss_fn=vision.loss_fn,
            attn_shapes=vision.attention_shapes(cfg, batch, size))
    if name == "flowformer-timeseries":
        seq = seq or (96 if smoke else 512)
        batch = batch or (8 if smoke else 32)
        train_data, eval_data = timeseries_data(
            n_train, n_eval, length=seq, dims=dims, n_classes=TS_CLASSES,
            seed=seed)
        return train_eval_classifier(
            cfg, train_data, eval_data, n_classes=TS_CLASSES, in_dim=dims,
            steps=steps, batch=batch, seed=seed, log_every=log_every,
            device=dev)
    batch = batch or (8 if smoke else 32)
    seq = seq or (256 if smoke else cfg.max_seq_len)
    train_data, eval_data = listops_data(n_train, n_eval, seq=seq, seed=seed)
    return train_eval_classifier(cfg, train_data, eval_data, n_classes=10,
                                 steps=steps, batch=batch, seed=seed,
                                 log_every=log_every, device=dev)


def main():
    ap = argparse.ArgumentParser(
        description="Train and evaluate a flow-attention encoder "
        "classifier (random weights from --seed): flowformer-lra on "
        "synthetic ListOps, flowformer-timeseries on UEA-style series, "
        "flowformer-vision on ImageNet-style textures.")
    ap.add_argument("--arch", default="flowformer-lra",
                    choices=("flowformer-lra", "flowformer-timeseries",
                             "flowformer-vision"))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and batch (LRA 8 x 256 tokens, "
                    "series 8 x 96, images 8 x 32 x 32)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None,
                    help="LRA tokens or series length")
    ap.add_argument("--size", type=int, default=None,
                    help="image side (vision; 224, or 32 with --smoke)")
    ap.add_argument("--dims", type=int, default=8,
                    help="series dimensions (time series)")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    out = run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
              seq=args.seq, size=args.size, dims=args.dims,
              n_train=args.n_train, n_eval=args.n_eval, seed=args.seed,
              device=args.device)
    print(f"[classify] done: eval acc={out['acc']:.4f} loss={out['loss']:.4f} "
          f"({out['train_time_s']} s training)")


if __name__ == "__main__":
    main()
