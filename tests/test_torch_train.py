"""Port vs reference: the training slice of flowformer_lm.

The same parameters (the reference's ``repro.models.lm.init``, carried
across with ``interop.params_from_numpy``) and the same ``lm_loader``
batches go through the JAX package and the port on the CPU, where the
port's attention runs its plain version under autograd.  Tolerances, each
with its reason:

* schedules and one AdamW update: rtol 1e-6 -- the same fp32 formulas,
  elementwise; only the global norm sums its leaves in another order.
  Where an update nearly cancels its parameter, the difference is a few
  ulp of the operands, so AdamW's leaves also get atol 1e-6 of the leaf's
  max |value|;
* ``loss_fn`` gradients, fp32: every leaf within 1e-5 of that leaf's max
  |grad| -- XLA and PyTorch sum the same fp32 products in another order;
* three fp32 train steps: losses rtol 1e-5, master params atol 1e-6 --
  the gradient differences above, after three Adam updates at lr <= 3e-4;
* the launcher in bf16: loss histories atol 2e-2 -- both round every
  matmul to bf16, at other places (packed and solo bf16 matmuls round
  about 1e-2 apart, see CHANGES.md, PR 5);
* the data loader: bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.data.loader import lm_loader as j_lm_loader  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import schedule as j_sched  # noqa: E402
from repro.training.train_state import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_state import init_train_state as j_init_state  # noqa: E402
from repro.training.train_state import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.loader import lm_loader  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import schedule as sched  # noqa: E402
from repro_torch.training.train_state import (TrainConfig,  # noqa: E402
                                              init_train_state,
                                              make_train_step)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke_config("flowformer_lm")
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("flowformer_lm")
    return jcfg, jparams, cfg


def to_port(tree, cfg):
    """A JAX tree in the reference layout as the port's unstacked dict."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg)


def leaf_pairs(got, want):
    """(path, port leaf, reference leaf) over the port's tree layout."""
    paths = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, x in enumerate(tree):
                walk(x, f"{path}/{i}")
        else:
            paths.append(path)

    walk(got, "")
    return zip(paths, tree_leaves(got), tree_leaves(want))


def batch_of(loader):
    return {k: torch.from_numpy(v) for k, v in next(loader).items()}


def test_lm_loader_matches_reference_bit_for_bit():
    for seed, batch, seq, vocab, host, hosts in ((1, 2, 32, 512, 0, 1),
                                                 (7, 6, 17, 300, 1, 3)):
        ours = lm_loader(seed, batch=batch, seq=seq, vocab=vocab,
                         start_step=2, host_id=host, n_hosts=hosts)
        ref = j_lm_loader(seed, batch=batch, seq=seq, vocab=vocab,
                          start_step=2, host_id=host, n_hosts=hosts)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
        assert ours.state() == ref.state()


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", dict(peak_lr=3e-4, warmup=7, total=40)),
    ("warmup_invsqrt", dict(peak_lr=1e-3, warmup=9)),
    ("constant", dict(peak_lr=5e-4, warmup=6)),
    ("constant", dict(peak_lr=5e-4)),
])
def test_schedules_match_reference(name, kw):
    steps = np.arange(51, dtype=np.int32)
    want = np.asarray(getattr(j_sched, name)(jnp.asarray(steps), **kw))
    got = [float(getattr(sched, name)(int(s), **kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    batched = getattr(sched, name)(torch.from_numpy(steps), **kw)
    np.testing.assert_allclose(batched.numpy(), want, rtol=1e-6)


def test_adamw_update_matches_reference_with_stacked_decay(model):
    jcfg, jparams, cfg = model
    rng = np.random.default_rng(4)

    def like(scale):
        return jax.tree.map(lambda x: jnp.asarray(
            scale * rng.standard_normal(x.shape).astype(np.float32)), jparams)

    grads = like(1.0)  # global norm >> grad_clip: the clip is active
    m = like(0.01)
    v = jax.tree.map(lambda x: jnp.abs(x), like(1e-4))
    j_state = j_opt.AdamWState(m=m, v=v, step=jnp.asarray(3, jnp.int32))
    acfg = j_opt.AdamWConfig(weight_decay=0.1, grad_clip=1.0)
    lr = 1e-2
    j_new, j_next, j_stats = j_opt.adamw_update(grads, j_state, jparams,
                                                jnp.float32(lr), acfg)
    master = to_port(jparams, cfg)
    state = opt.AdamWState(m=to_port(m, cfg), v=to_port(v, cfg), step=3)
    new, nxt, stats = opt.adamw_update(
        to_port(grads, cfg), state, master, torch.tensor(lr),
        opt.AdamWConfig(weight_decay=0.1, grad_clip=1.0),
        opt.decay_mask(master, cfg))
    assert float(j_stats["grad_norm"]) > 10.0
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(j_stats["grad_norm"]), rtol=1e-6)
    assert nxt.step == int(j_next.step) == 4
    for what, got, want in (("master", new, j_new), ("m", nxt.m, j_next.m),
                            ("v", nxt.v, j_next.v)):
        for path, a, b in leaf_pairs(got, to_port(want, cfg)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(b.abs().max()),
                                       err_msg=f"{what}{path}")
    mask = opt.decay_mask(master, cfg)
    assert all(tree_leaves(mask["blocks"])) and not any(
        tree_leaves(mask["final_norm"])) and mask["head"]["table"]


@pytest.mark.parametrize("backend", ["auto", "pallas_fused"])
def test_loss_fn_grads_match_reference(model, backend):
    """auto: the reference's XLA path; pallas_fused: its K1 forward and K2
    backward Pallas kernels in interpret mode."""
    jcfg, jparams, cfg = model
    jcfg = dataclasses.replace(jcfg, attention=dataclasses.replace(
        jcfg.attention, backend=backend))
    batch = next(j_lm_loader(1, batch=2, seq=32, vocab=cfg.vocab_size))
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                              dtype=jnp.float32), has_aux=True)(jparams)
    params = tree_map(lambda x: x.requires_grad_(True), to_port(jparams, cfg))
    loss, metrics = lm.loss_fn(params, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, cfg,
                               dtype=F32)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    assert float(metrics["tokens"]) == 64
    for path, a, b in leaf_pairs(grads, to_port(j_grads, cfg)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"{path}: {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("fused_value_grad", [True, False])
def test_train_step_matches_reference_over_three_steps(model,
                                                       fused_value_grad):
    jcfg, jparams, cfg = model
    kw = dict(peak_lr=3e-4, warmup=1, total_steps=3,
              fused_value_grad=fused_value_grad)
    j_step = jax.jit(j_make_step(
        functools.partial(jlm.loss_fn, cfg=jcfg, dtype=jnp.float32),
        JTrainConfig(compute_dtype=jnp.float32, **kw)))
    j_state = j_init_state(jparams, JTrainConfig(compute_dtype=jnp.float32,
                                                 **kw))
    master = to_port(jparams, cfg)
    step = make_train_step(
        functools.partial(lm.loss_fn, cfg=cfg, dtype=F32),
        TrainConfig(compute_dtype=F32, **kw), decay=opt.decay_mask(master, cfg))
    state = init_train_state(master, TrainConfig(compute_dtype=F32, **kw))
    j_loader = j_lm_loader(2, batch=2, seq=32, vocab=cfg.vocab_size)
    loader = lm_loader(2, batch=2, seq=32, vocab=cfg.vocab_size)
    for i in range(3):
        j_state, j_metrics = j_step(j_state, jax.tree.map(jnp.asarray,
                                                          next(j_loader)))
        state, metrics = step(state, batch_of(loader))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(j_metrics["loss"]), rtol=1e-5,
                                   err_msg=f"loss at step {i}")
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(j_metrics["lr"]), rtol=1e-6)
    assert state.step == int(j_state.step) == 3
    for path, a, b in leaf_pairs(state.master, to_port(j_state.master, cfg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=f"master{path} after 3 steps")


@pytest.mark.parametrize("fused_value_grad", [True, False])
def test_microbatched_step_equals_one_batch(model, fused_value_grad):
    """Accumulating two microbatches gives the whole batch's mean
    gradient (fp32, the same tolerance as the parity above), with the
    metrics from the gradient pass or from a separate no-grad pass."""
    _, jparams, cfg = model
    master = to_port(jparams, cfg)
    batch = batch_of(lm_loader(3, batch=4, seq=16, vocab=cfg.vocab_size))
    out = {}
    for micro in (0, 2):
        tcfg = TrainConfig(compute_dtype=F32, microbatch=micro, warmup=1,
                           fused_value_grad=fused_value_grad)
        step = make_train_step(functools.partial(lm.loss_fn, cfg=cfg,
                                                 dtype=F32), tcfg)
        state = init_train_state(master, tcfg)
        state, _ = step(state, batch)  # lr 0 at step 0: moments only
        out[micro] = state.opt.m
    for path, a, b in leaf_pairs(out[2], out[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-9, err_msg=f"m{path}")


def test_launcher_matches_reference_bf16(model):
    jcfg, _, cfg = model
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref = j_train(jcfg, steps=3, batch=2, seq=32, seed=1, mesh=mesh)
    params = to_port(jlm.init(jax.random.PRNGKey(1), jcfg), cfg)
    out = train(cfg, steps=3, batch=2, seq=32, seed=1, device="cpu",
                params=params)
    assert len(out["history"]) == 3 and out["state"].step == 3
    np.testing.assert_allclose(out["history"], ref["history"], atol=2e-2)
