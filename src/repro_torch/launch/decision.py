"""Offline RL on one GPU: the Decision-Flowformer (paper §4.5, Table 7).

    python -m repro_torch.launch.decision --kind flow
    python -m repro_torch.launch.decision --table7 --kind linear

The port of the training step and the closed-loop rollout that
``benchmarks/rl_table7.py`` runs: noisy LQR rollouts
(``data.synthetic.trajectories``, seed 0) train the model with AdamW
(weight decay 1e-4, clip 0.25) on a warmup-cosine schedule (peak 1e-3,
warmup 20), bf16 compute on fp32 parameters, batches of trajectories drawn
with ``numpy`` seed 0; then the learned policy is rolled out in the same
linear environment (dynamics seed 0, 16 episodes) conditioned on an expert
return-to-go (the data's 95th percentile), and its mean return is the
result.  ``--table7`` takes the harness's override (2 layers, d 96, 4
heads of 24, d_ff 192, horizon 20); the default is ``flowformer_dt``
itself (3 layers, d 256, 4 heads of 64, horizon 60, N = 180).  ``--kind``
sets the attention kind at ``chunk_size=0``, as the harness's
``with_kind`` does: on a GPU flow runs K1 forward and K2 backward, linear
K5a (K5b in the backward), softmax plain PyTorch.  Random weights from
seed 0, 300 trajectories; ``--device cpu`` runs the plain versions.
Nothing here prints a benchmark table.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.data.synthetic import trajectories
from repro_torch.layers.attention import executor_of, plan_of
from repro_torch.models import decision
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.schedule import warmup_cosine
from repro_torch.utils import resolve_device, tree_leaves, tree_map

STATE_DIM, ACTION_DIM = 17, 6
TABLE7_HORIZON = 20
N_TRAJ = 300  # the harness's dataset
PEAK_LR, WARMUP = 1e-3, 20
LOG_EVERY = 20
KINDS = ("flow", "softmax", "linear")
#: the Table 7 harness's model override (``benchmarks/rl_table7.py``)
TABLE7 = dict(n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_ff=192)
ADAMW = AdamWConfig(weight_decay=1e-4, grad_clip=0.25)


def with_kind(cfg: ModelConfig, kind: str) -> ModelConfig:
    """``cfg`` with attention ``kind`` at ``chunk_size=0``, as the harness
    makes each row."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind, chunk_size=0))


def table7_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, **TABLE7)


def _env(seed: int = 0):
    rng = np.random.default_rng(seed)
    a_mat = np.eye(STATE_DIM) * 0.95
    b_mat = rng.normal(0, 0.3, (STATE_DIM, ACTION_DIM)) / np.sqrt(ACTION_DIM)
    return a_mat, b_mat


def shifted_actions(actions: np.ndarray) -> np.ndarray:
    """The model's action inputs: position t sees a_{t-1} (zeros at 0)."""
    return np.concatenate([np.zeros_like(actions[:, :1]), actions[:, :-1]], 1)


def batch_arrays(data: dict) -> dict:
    """``loss_fn``'s batch fields, as numpy, from ``trajectories``' arrays."""
    return {"rtg": data["rtg"], "states": data["states"],
            "actions_in": shifted_actions(data["actions"]),
            "actions": data["actions"], "timesteps": data["timesteps"]}


def make_step(cfg: ModelConfig, *, total: int, dtype=torch.bfloat16,
              plan=None):
    """The harness's step: (params, opt, batch, step) -> (params, opt,
    loss).  The loss runs in ``dtype`` on the fp32 parameters, its
    gradients reach them in fp32, and AdamW (``ADAMW``, every leaf of
    ndim >= 2 decayed) takes the warmup-cosine rate of ``step`` (peak
    ``PEAK_LR``, ``WARMUP`` steps)."""
    def step(params, opt, batch, s: int):
        leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss, _ = decision.loss_fn(leaves, batch, cfg, dtype=dtype, plan=plan)
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        lr = warmup_cosine(s, peak_lr=PEAK_LR, warmup=WARMUP, total=total)
        params, opt, _ = adamw_update(grads, opt, params, lr, ADAMW)
        return params, opt, loss.detach()

    return step


def rollout(params, cfg: ModelConfig, *, horizon: int, n_episodes: int,
            target_rtg: float, dtype=torch.bfloat16, plan=None) -> float:
    """Closed-loop return of the policy in the environment the data came
    from (dynamics seed 0, initial states seed 0): ``horizon`` forwards of
    ``n_episodes`` trajectories, each reading its action at the current
    step."""
    a_mat, b_mat = _env(0)
    rng = np.random.default_rng(0)
    dev = next(iter(tree_leaves(params))).device
    s = rng.normal(0, 1, (n_episodes, STATE_DIM)).astype(np.float32)
    states = np.zeros((n_episodes, horizon, STATE_DIM), np.float32)
    actions = np.zeros((n_episodes, horizon, ACTION_DIM), np.float32)
    rtg = np.full((n_episodes, horizon, 1), target_rtg, np.float32)
    total = np.zeros(n_episodes)
    ts = torch.from_numpy(np.tile(np.arange(horizon, dtype=np.int32),
                                  (n_episodes, 1))).to(dev)
    for t in range(horizon):
        states[:, t] = s
        with torch.no_grad():
            pred = decision.forward(
                params, torch.from_numpy(rtg).to(dev),
                torch.from_numpy(states).to(dev),
                torch.from_numpy(actions).to(dev), ts, cfg, dtype=dtype,
                plan=plan)
        a = pred[:, t].cpu().numpy()
        actions[:, t] = a
        r = -(s**2).sum(-1) * 0.05 - 0.1 * (a**2).sum(-1)
        total += r
        rtg[:, t + 1:] = rtg[:, t:t + 1] - r[:, None, None]
        s = (s @ a_mat.T + a @ b_mat.T).astype(np.float32)
    return float(total.mean())


def run(kind: str = "flow", *, table7: bool = False,
        cfg: ModelConfig | None = None, steps: int = 120, batch: int = 32,
        device="cuda", dtype=torch.bfloat16, params: dict | None = None,
        n_episodes: int = 16) -> dict:
    """Train ``steps`` steps on ``N_TRAJ`` trajectories and roll out.

    ``cfg`` replaces ``flowformer_dt`` as the base; ``table7`` applies the
    harness's override to it, and ``kind`` sets its attention kind at
    ``chunk_size=0``.  The horizon is 20 with ``table7`` and the config's
    ``max_seq_len / 3`` otherwise.  ``params`` (fp32) replaces the random
    init from seed 0; ``n_episodes=0`` skips the rollout.  Returns
    {"history": per-step losses, "step_s": per-step wall seconds,
    "return": the rollout's mean return (None without one), "rollout_s",
    "behavior_return", "expert_rtg", "params", "cfg"}.
    """
    dev = resolve_device(device)
    base = cfg or get_config("flowformer_dt")
    cfg = with_kind(table7_config(base) if table7 else base, kind)
    horizon = TABLE7_HORIZON if table7 else cfg.max_seq_len // 3
    data = trajectories(0, N_TRAJ, horizon=horizon, state_dim=STATE_DIM,
                        action_dim=ACTION_DIM)
    behavior = float(data["rewards"].sum(1).mean())
    expert_rtg = float(np.percentile(data["rtg"][:, 0, 0], 95))
    arrays = batch_arrays(data)
    if params is None:
        params = decision.init(cfg, torch.Generator().manual_seed(0),
                               state_dim=STATE_DIM, action_dim=ACTION_DIM,
                               max_ep_len=horizon, device=dev)
    params = tree_map(lambda x: x.detach().to(dev, torch.float32), params)
    train_plan = executor_of(cfg, plan_of(cfg, needs_grad=True))
    print(f"[decision] {cfg.name} kind={kind}: "
          f"{sum(x.numel() for x in tree_leaves(params)):,} params on {dev}, "
          f"d {cfg.d_model}, {cfg.n_heads} heads of {cfg.dim_head}, "
          f"{cfg.n_layers} layers, horizon {horizon} (N = {3 * horizon})")
    step_fn = make_step(cfg, total=steps, dtype=dtype, plan=train_plan)
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    history, step_s = [], []
    for s in range(steps):
        idx = rng.integers(0, N_TRAJ, batch)
        b = {k: torch.from_numpy(v[idx]).to(dev) for k, v in arrays.items()}
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, b, s)
        history.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        if s % LOG_EVERY == 0 or s == steps - 1:
            print(f"  step {s:4d} loss={history[-1]:.5f} "
                  f"{1e3 * step_s[-1]:.1f}ms")
    ret, rollout_s = None, 0.0
    if n_episodes:
        t0 = time.perf_counter()
        ret = rollout(params, cfg, horizon=horizon, n_episodes=n_episodes,
                      target_rtg=expert_rtg, dtype=dtype,
                      plan=executor_of(cfg, plan_of(cfg)))
        rollout_s = time.perf_counter() - t0
        print(f"[decision] rollout of {n_episodes} episodes x {horizon} "
              f"steps: return {ret:.4f} (behavior policy {behavior:.4f}, "
              f"expert rtg {expert_rtg:.4f}) in {rollout_s:.2f}s")
    return {"history": history, "step_s": step_s, "return": ret,
            "rollout_s": rollout_s, "behavior_return": behavior,
            "expert_rtg": expert_rtg, "params": params, "cfg": cfg}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Train the Decision-Flowformer on synthetic LQR "
        "rollouts and roll the policy out (random weights).")
    ap.add_argument("--kind", default="flow", choices=list(KINDS))
    ap.add_argument("--table7", action="store_true",
                    help="the Table 7 harness's model (2 layers, d 96, 4 "
                    "heads of 24) at horizon 20")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    return run(args.kind, table7=args.table7, steps=args.steps,
               batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
