"""Synthetic data, copied from ``repro/data/synthetic.py``.

``zipf_text`` is the language-modelling stand-in the LM training slice
reads; ``listops`` and ``pixel_images`` are the LRA stand-ins (ListOps and
pixel sequences) the classifier slice reads, ``pixel_images`` with
``channels=3`` also the ImageNet stand-in of the vision encoder, and
``timeseries`` the UEA stand-in of the time-series encoder, and
``trajectories`` the D4RL stand-in of the Decision-Flowformer.  Each is a
pure function of its seed and sizes, numpy only, so the port and the
reference draw the same data.
"""
from __future__ import annotations

import numpy as np


def zipf_text(seed: int, n_tokens: int, vocab: int, *, alpha: float = 1.2,
              copy_prob: float = 0.12, copy_span: int = 32) -> np.ndarray:
    """Zipfian unigram stream with stochastic span copying (induction heads)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    # paste copies of earlier spans to create learnable long-range structure
    n_copies = int(n_tokens * copy_prob / copy_span)
    for _ in range(n_copies):
        if n_tokens < 4 * copy_span:
            break
        src = rng.integers(0, n_tokens - 2 * copy_span)
        dst = rng.integers(src + copy_span, n_tokens - copy_span)
        toks[dst : dst + copy_span] = toks[src : src + copy_span]
    return toks


# ---------------------------------------------------------------------------
# ListOps (LRA)
# ---------------------------------------------------------------------------
_OPS = ("MIN", "MAX", "MED", "SM")  # SM = sum mod 10
OP_TOKENS = {op: 10 + i for i, op in enumerate(_OPS)}
CLOSE_TOKEN = 14
PAD = 15
LISTOPS_VOCAB = 16


def _gen_expr(rng, depth: int, max_args: int):
    if depth == 0 or rng.random() < 0.3:
        v = int(rng.integers(0, 10))
        return [v], v
    op = _OPS[rng.integers(0, len(_OPS))]
    n_args = int(rng.integers(2, max_args + 1))
    toks = [OP_TOKENS[op]]
    vals = []
    for _ in range(n_args):
        t, v = _gen_expr(rng, depth - 1, max_args)
        toks.extend(t)
        vals.append(v)
    toks.append(CLOSE_TOKEN)
    if op == "MIN":
        out = min(vals)
    elif op == "MAX":
        out = max(vals)
    elif op == "MED":
        out = int(np.median(vals))
    else:
        out = sum(vals) % 10
    return toks, out


def listops(seed: int, n: int, *, seq: int = 512, depth: int = 4,
            max_args: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """Returns (tokens (n, seq) int32 padded, labels (n,) 0..9)."""
    rng = np.random.default_rng(seed)
    xs = np.full((n, seq), PAD, np.int32)
    ys = np.zeros((n,), np.int32)
    for i in range(n):
        while True:
            toks, val = _gen_expr(rng, depth, max_args)
            if len(toks) <= seq:
                break
        xs[i, : len(toks)] = toks
        ys[i] = val
    return xs, ys


# ---------------------------------------------------------------------------
# Pixel sequences (LRA Image / ImageNet stand-in)
# ---------------------------------------------------------------------------
def pixel_images(seed: int, n: int, *, size: int = 32, n_classes: int = 10,
                 channels: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Class-dependent oriented textures; (n, size, size, channels) in [0,1]."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_classes, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    xs = np.zeros((n, size, size, channels), np.float32)
    for i in range(n):
        c = ys[i]
        angle = np.pi * c / n_classes
        freq = 3 + (c % 4) * 2
        base = np.sin(2 * np.pi * freq * (xx * np.cos(angle) + yy * np.sin(angle)))
        noise = rng.normal(0, 0.4, (size, size))
        img = (base + noise - (base + noise).min())
        img = img / (img.max() + 1e-6)
        xs[i, :, :, 0] = img
    if channels > 1:
        xs = np.repeat(xs[:, :, :, :1], channels, axis=-1)
    return xs, ys


# ---------------------------------------------------------------------------
# Time series (UEA stand-in)
# ---------------------------------------------------------------------------
def timeseries(seed: int, n: int, *, length: int = 256, dims: int = 8,
               n_classes: int = 6) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_classes, size=n).astype(np.int32)
    t = np.linspace(0, 1, length)
    xs = np.zeros((n, length, dims), np.float32)
    for i in range(n):
        c = ys[i]
        for d in range(dims):
            f1 = 2 + c + d % 3
            f2 = 5 + (c * 2) % 7
            phase = rng.uniform(0, 2 * np.pi)
            xs[i, :, d] = (
                np.sin(2 * np.pi * f1 * t + phase)
                + 0.5 * np.sin(2 * np.pi * f2 * t)
                + rng.normal(0, 0.3, length)
            )
    return xs, ys


# ---------------------------------------------------------------------------
# Offline-RL trajectories (D4RL stand-in)
# ---------------------------------------------------------------------------
def trajectories(seed: int, n: int, *, horizon: int = 60, state_dim: int = 17,
                 action_dim: int = 6) -> dict[str, np.ndarray]:
    """Noisy linear-control rollouts.  Reward = -0.05 ||s||^2 - 0.1 ||a||^2;
    the behavior policy is a noised stabilizing controller, so trajectories
    with a higher return-to-go carry better actions."""
    rng = np.random.default_rng(seed)
    a_mat = np.eye(state_dim) * 0.95
    b_mat = rng.normal(0, 0.3, (state_dim, action_dim)) / np.sqrt(action_dim)
    k_gain = rng.normal(0, 0.2, (action_dim, state_dim))

    states = np.zeros((n, horizon, state_dim), np.float32)
    actions = np.zeros((n, horizon, action_dim), np.float32)
    rewards = np.zeros((n, horizon), np.float32)
    s = rng.normal(0, 1, (n, state_dim))
    noise_scale = rng.uniform(0.05, 1.0, (n, 1))  # per-trajectory quality
    for t in range(horizon):
        a = -s @ k_gain.T + rng.normal(0, 1, (n, action_dim)) * noise_scale
        a = np.tanh(a)
        r = -(s**2).sum(-1) * 0.05 - 0.1 * (a**2).sum(-1)
        states[:, t] = s
        actions[:, t] = a
        rewards[:, t] = r
        s = s @ a_mat.T + a @ b_mat.T + rng.normal(0, 0.05, (n, state_dim))
    rtg = np.flip(np.cumsum(np.flip(rewards, 1), 1), 1).copy()
    timesteps = np.tile(np.arange(horizon, dtype=np.int32), (n, 1))
    return {"states": states, "actions": actions, "rewards": rewards,
            "rtg": rtg[..., None], "timesteps": timesteps}
