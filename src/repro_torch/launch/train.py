"""Train the LM on one GPU: the counterpart of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch flowformer-lm --steps 5 \\
        --batch 16 --seq 512
    python -m repro_torch.launch.train --arch mamba2_1p3b --steps 5 \\
        --batch 4 --seq 4096

Random weights from ``--seed`` (or given ``params``), batches from
``data.loader.lm_loader(seed)``, AdamW on fp32 master parameters with a
warmup-cosine schedule, bf16 compute.  The attention backend is resolved
once, for gradients: on a GPU every attention forward runs kernel K1 and
every attention backward kernel K2; in the paper-faithful causal mode
(``attention.strict_causal=False``) and without competition, every
forward runs K5a and every backward K5a (dq) and K5b (dk, dv).  An SSD
stack (``mamba2_1p3b``) has no attention: every SSD forward and its remat
recompute run K10a with carry-ins, every backward K10b.
Checkpointing, elastic restart and meshes are not ported yet.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.loader import lm_loader
from repro_torch.launch.steps import check_flow_trainable, microbatch_for
from repro_torch.layers.attention import executor_of, plan_of
from repro_torch.models import lm
from repro_torch.training.optimizer import decay_mask
from repro_torch.training.train_state import (TrainConfig, init_train_state,
                                              make_train_step)
from repro_torch.utils import resolve_device, tree_leaves, tree_map


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, seed: int = 0,
          peak_lr: float = 3e-4, device="cuda", dtype=torch.bfloat16,
          params: dict | None = None, log_every: int = 10) -> dict:
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens.

    ``params`` (fp32, any device) replaces the random init from ``seed``.
    Returns {"history": per-step losses, "final_loss", "wall_s",
    "step_s": per-step wall seconds, "state": the final TrainState}.
    """
    dev = resolve_device(device)
    shape = ShapeSpec("custom", seq, batch, "train")
    tcfg = TrainConfig(microbatch=microbatch_for(cfg, shape),
                       total_steps=steps, warmup=max(5, steps // 10),
                       peak_lr=peak_lr, fused_value_grad=True,
                       compute_dtype=dtype)
    xplan = plan_of(cfg, needs_grad=True)
    be = check_flow_trainable(cfg, shape, dev.type, xplan)
    if params is None:
        params = lm.init(cfg, torch.Generator().manual_seed(seed), device=dev)
    params = tree_map(lambda x: x.detach().to(dev, torch.float32), params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params:,} params on {dev}, "
          f"{str(dtype)[6:]} compute, microbatch={tcfg.microbatch}")
    mixers = sorted({cfg.block_kind(i) for i in range(cfg.n_layers)})
    print(f"[train] attention {xplan.describe()} -> "
          + (be.name if be is not None else
             f"no attention backend (mixers: {', '.join(mixers)})"))

    loss = functools.partial(lm.loss_fn, cfg=cfg, dtype=dtype,
                             plan=executor_of(cfg, xplan))
    step_fn = make_train_step(loss, tcfg, decay=decay_mask(params, cfg))
    state = init_train_state(params, tcfg)
    loader = lm_loader(seed, batch=batch, seq=seq, vocab=cfg.vocab_size)
    history, step_s = [], []
    t_start = time.perf_counter()
    for step in range(steps):
        batch_np = next(loader)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in batch_np.items()})
        loss_value = float(metrics["loss"])  # waits for the step
        step_s.append(time.perf_counter() - t0)
        history.append(loss_value)
        if step % log_every == 0 or step == steps - 1:
            print(f"  step {step:5d} loss={loss_value:.4f} "
                  f"ppl={float(metrics['ppl']):.2f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{step_s[-1] * 1000:.0f}ms")
    return {"history": history, "final_loss": history[-1] if history else None,
            "wall_s": time.perf_counter() - t_start, "step_s": step_s,
            "state": state}


def main():
    ap = argparse.ArgumentParser(
        description="Train the LM on one GPU (random weights, synthetic "
        "zipf_text batches).  Checkpointing (--ckpt-dir), elastic restart "
        "and device meshes are not ported yet.")
    ap.add_argument("--arch", default="flowformer-lm")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                device=args.device)
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"({out['wall_s']:.1f}s)")


if __name__ == "__main__":
    main()
