"""Port vs reference: Adafactor (``training/optimizer.py``).

The reference factors and clips each leaf of its own layout, where a
scanned stack's layers are one (n_rep, ...) leaf per pattern position;
the port keeps layers unstacked and computes on that grouping
(``stack_layers``).  The same parameters (``repro.models.lm.init``
carried across with ``interop``) and the same ``lm_loader`` batches go
through three fp32 ``make_train_step`` steps of each package, on a
stacked config (the smoke ``flowformer_lm``), a patterned one with a tail
(the smoke ``recurrentgemma_9b`` at 7 layers: two periods of rglru,
rglru, local and one rglru) and a MoE one (the smoke
``granite_moe_3b_a800m``, experts stacked (n_rep, E, d, f)).
Tolerances, each with its reason:

* losses rtol 1e-5 and the master params atol 1e-6: the gradients differ
  by XLA's and PyTorch's orders of the same fp32 sums (1e-5 of a leaf's
  max, ``test_torch_train.py``), and an update is the gradient times
  smooth row and column factors, so it differs by as little relative to
  its largest entry, times lr <= 3e-4;
* ``vr`` and ``vc`` within 1e-4 of each leaf's max: means of squared
  gradients, each 2x the gradients' relative difference.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.data.loader import lm_loader as j_lm_loader  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training.train_state import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_state import init_train_state as j_init_state  # noqa: E402
from repro.training.train_state import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.loader import lm_loader  # noqa: E402
from repro_torch.interop import (params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_state import (TrainConfig,  # noqa: E402
                                              init_train_state,
                                              make_train_step)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32
CASES = {
    "stacked": ("flowformer_lm", {}),
    "pattern_with_tail": ("recurrentgemma_9b", {"n_layers": 7}),
    "moe": ("granite_moe_3b_a800m", {}),
}


def configs(case):
    name, over = CASES[case]
    return (dataclasses.replace(j_smoke_config(name), **over),
            dataclasses.replace(get_smoke_config(name), **over))


def paths_and_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(kp), leaf) for kp, leaf in flat]


@pytest.mark.parametrize("case", list(CASES))
def test_adafactor_steps_match_reference(case):
    jcfg, cfg = configs(case)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    kw = dict(optimizer="adafactor", peak_lr=3e-4, warmup=1, total_steps=3,
              fused_value_grad=True)
    jtcfg = JTrainConfig(compute_dtype=jnp.float32, **kw)
    j_step = jax.jit(j_make_step(
        functools.partial(jlm.loss_fn, cfg=jcfg, dtype=jnp.float32), jtcfg))
    j_state = j_init_state(jparams, jtcfg)
    tcfg = TrainConfig(compute_dtype=F32, **kw)
    master = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    step = make_train_step(functools.partial(lm.loss_fn, cfg=cfg, dtype=F32),
                           tcfg, layout=cfg)
    state = init_train_state(master, tcfg, layout=cfg)
    # the port's fresh state is the reference's, leaf for leaf and shape
    # for shape (the moments of the stacked layout)
    want0 = paths_and_leaves(j_state)
    got0 = paths_and_leaves(train_state_to_numpy(state, cfg))
    assert [p for p, _ in got0] == [p for p, _ in want0]
    assert [np.shape(x) for _, x in got0] == [np.shape(x) for _, x in want0]
    j_loader = j_lm_loader(2, batch=2, seq=32, vocab=cfg.vocab_size)
    loader = lm_loader(2, batch=2, seq=32, vocab=cfg.vocab_size)
    for i in range(3):
        j_state, j_metrics = j_step(j_state, jax.tree.map(jnp.asarray,
                                                          next(j_loader)))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in next(loader).items()})
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(j_metrics["grad_norm"]), rtol=1e-5)
    assert state.step == state.opt.step == int(j_state.opt.step) == 3
    got = dict(paths_and_leaves(train_state_to_numpy(state, cfg)))
    n_master = 0
    for path, want in paths_and_leaves(jax.tree.map(np.asarray, j_state)):
        a = np.asarray(got[path])
        if path.startswith(".master"):
            np.testing.assert_allclose(a, want, rtol=0, atol=1e-6,
                                       err_msg=path)
            n_master += 1
        elif path.startswith((".opt.vr", ".opt.vc")):
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(a, want, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=path)
        else:
            assert a == want, path
    assert n_master == len(jax.tree.leaves(j_state.master))
    # the reference's state carried across steps on as the reference's
    # does (the moments matched to the port's leaves by path, not order)
    back = train_state_from_numpy(jax.tree.map(np.asarray, j_state), cfg)
    batch = next(loader)
    j_state, _ = j_step(j_state, jax.tree.map(jnp.asarray, next(j_loader)))
    back, _ = step(back, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = dict(paths_and_leaves(train_state_to_numpy(back, cfg)))
    for path, want in paths_and_leaves(jax.tree.map(np.asarray, j_state)):
        np.testing.assert_allclose(np.asarray(got[path]), want, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{path} at step 4")


def test_stacked_leaves_are_factored_and_clipped_as_one():
    """A (n_rep, d) norm scale is factored across the layers (its vc is a
    mean over them), and a stacked weight takes one RMS clip: the per-layer
    update differs."""
    cfg = get_smoke_config("flowformer_lm")
    master = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda x: torch.randn(x.shape, generator=gen), master)
    grads["blocks"][1] = tree_map(lambda x: 100 * x, grads["blocks"][1])
    lr = torch.tensor(1e-2)
    stacked = opt.adafactor_init(master, cfg)
    scale = stacked.vc["scan"][0]["norm1"]["scale"]
    assert scale.shape == (cfg.d_model,)
    new, nxt, _ = opt.adafactor_update(grads, stacked, master, lr,
                                       layout=cfg)
    g = torch.stack([grads["blocks"][r]["norm1"]["scale"] for r in (0, 1)])
    torch.testing.assert_close(nxt.vc["scan"][0]["norm1"]["scale"],
                               (g.square() + 1e-30).mean(0), rtol=1e-6,
                               atol=0)
    alone, _, _ = opt.adafactor_update(grads, opt.adafactor_init(master),
                                       master, lr)
    w = ("attn", "wq", "w")

    def leaf(p, i):
        return p["blocks"][i][w[0]][w[1]][w[2]]

    assert not torch.allclose(leaf(new, 0), leaf(alone, 0))
    assert all(x.shape == y.shape for x, y in zip(tree_leaves(new),
                                                  tree_leaves(master)))


def test_full_width_state_count_from_shapes():
    """flowformer_lm at full width: the reference's adafactor_init holds
    124,954 fp32 values in vr and vc; the port's stacked state exactly as
    many (a per-layer state would hold 135,194: each unstacked norm left
    unfactored).  Counted on meta tensors, from shapes alone."""
    jcfg, cfg = j_config("flowformer_lm"), get_config("flowformer_lm")
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    want = jax.eval_shape(j_opt.adafactor_init, shapes)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    master = opt.unstack_layers(meta, cfg)
    assert len(master["blocks"]) == cfg.n_layers == 6
    state = opt.adafactor_init(master, cfg)

    def count(s):
        return sum(x.numel() for x in tree_leaves((s.vr, s.vc)))

    assert count(state) == sum(int(np.prod(x.shape)) for x in
                               jax.tree.leaves((want.vr, want.vc))) == 124_954
    assert count(opt.adafactor_init(master)) == 135_194
    assert sum(x.numel() for x in tree_leaves(master)) == 52_442_112


def test_adafactor_converges_quadratic():
    """The reference's convergence test, ported."""
    p = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (8, 8)).astype(np.float32))}
    state = opt.adafactor_init(p)
    target = torch.ones((8, 8))
    for _ in range(200):
        g = {"w": 2 * (p["w"] - target)}
        p, state, _ = opt.adafactor_update(g, state, p, torch.tensor(0.1))
    assert float((p["w"] - target).abs().mean()) < 0.05


def test_adafactor_memory_sublinear():
    """The reference's sublinear-memory test, ported."""
    state = opt.adafactor_init({"w": torch.zeros((128, 256))})
    assert sum(x.numel() for x in tree_leaves((state.vr, state.vc))) == \
        128 + 256
