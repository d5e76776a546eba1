"""Port vs reference: the Decision-Flowformer (``flowformer_dt``, paper
§4.5, Table 7) and the routes of K1 and K2 it needs, ``chunk_size <= 0``
and D = 24 (the Table 7 harness's 96-wide, 4-head override).

The same parameters (``repro.models.decision.init``, carried across with
``interop.params_from_numpy``) and the same numpy trajectories go through
the JAX package and the port on the CPU, in fp32:

* the configs field for field; ``trajectories`` array-equal;
* the smoke config (2 layers, d 64, 2 heads of 32) and a D = 24 variant
  (d 48, 2 heads), both at ``chunk_size=0``, at T = 20 and 60 (N = 60 and
  180): ``forward`` and ``loss_fn`` at ``test_torch_lm.py``'s rtol = atol
  = 1e-4, the gradient of every leaf (``jax.value_and_grad``) at
  ``test_torch_flow_bwd.py``'s rtol 2e-4, atol 2e-5, and one AdamW step
  of the harness (weight decay 1e-4, clip 0.25, warmup-cosine) at rtol
  1e-4, atol 1e-6 on the parameters.  The port runs ``auto`` (the plain
  ``cumsum`` floor on the CPU, the reference's ``xla_cumsum``) and the
  kernel glue of ``cuda_fused`` (its check patched to take the CPU, so K1
  and K2's wrappers run their plain versions with N padded to 64);
* the padded route itself: K1's wrapper at D = 24 (which pads to 32 on
  the card; on the CPU it runs its plain version) and the kernel's
  decomposition ``flow_fused_parallel`` at N = 60 and 180 against the
  reference's ``flow_fused_call`` in interpret mode (which takes D = 24)
  and its ``xla_cumsum`` prefill, at ``test_torch_flow.py``'s rtol 2e-4,
  atol 2e-5; K2's wrapper and twin against ``jax.vjp`` of the
  reference's ``flow_fused_dot``; ``FlowFusedDot`` giving padded rows
  exactly zero gradient and D = 24 gradients;
* the paper-causal mode at ``chunk_size=0`` through ``cuda_chunk``'s glue
  (K5a at its own chunk, D = 24 padded to 32) against ``xla_cumsum``;
* the launcher's step and rollout on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import attention as jattention  # noqa: E402
from repro.attention.vjp import flow_fused_dot  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.kernels.flow_fused.flow_fused import flow_fused_call as j_fused_call  # noqa: E402
from repro.models import decision as jdecision  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.training.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro.training.schedule import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention import backends  # noqa: E402
from repro_torch.attention.vjp import FlowFusedDot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,  # noqa: E402
                                            flow_fused_bwd_parallel,
                                            flow_fused_call,
                                            flow_fused_forward,
                                            flow_fused_parallel)
from repro_torch.launch import decision as launch  # noqa: E402
from repro_torch.layers.attention import plan_of  # noqa: E402
from repro_torch.models import decision  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

F32 = torch.float32
OUT_TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_lm.py's
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)  # test_torch_flow_bwd.py's
STATE_DIM, ACTION_DIM = launch.STATE_DIM, launch.ACTION_DIM
D24 = dict(d_model=48, n_heads=2, n_kv_heads=2)
WIDTHS = {"smoke": {}, "d24": D24}
HORIZONS = (20, 60)


def j_config(which, kind="flow"):
    cfg = dataclasses.replace(j_smoke_config("flowformer_dt"), **WIDTHS[which])
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind, chunk_size=0))


def port_config(which, kind="flow", backend="auto"):
    cfg = dataclasses.replace(get_smoke_config("flowformer_dt"),
                              **WIDTHS[which])
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind, chunk_size=0, backend=backend))


@pytest.fixture(scope="module")
def trees():
    """The reference's parameters per (width, horizon), as numpy trees."""
    out = {}
    for i, which in enumerate(WIDTHS):
        for h in HORIZONS:
            init = jax.jit(lambda key, c=j_config(which), h=h: jdecision.init(
                key, c, state_dim=STATE_DIM, action_dim=ACTION_DIM,
                max_ep_len=h))
            out[which, h] = jax.tree.map(np.asarray,
                                         init(jax.random.PRNGKey(i + h)))
    return out


def batch_of(horizon, n=3, seed=0):
    return launch.batch_arrays(synthetic.trajectories(seed, n,
                                                      horizon=horizon))


def j_reference(tree, batch, jcfg):
    """The reference's fp32 predictions, loss and gradients, in one jit."""
    def run(p, b):
        pred = jdecision.forward(p, b["rtg"], b["states"], b["actions_in"],
                                 b["timesteps"], jcfg, dtype=jnp.float32)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jdecision.loss_fn(p, b, jcfg, dtype=jnp.float32),
            has_aux=True)(p)
        return pred, loss, grads

    return jax.jit(run)(jax.tree.map(jnp.asarray, tree),
                        {k: jnp.asarray(v) for k, v in batch.items()})


def kernel_glue_on_cpu(monkeypatch):
    """Let ``cuda_fused`` and ``cuda_chunk`` take the CPU: their wrappers
    then run the kernels' plain versions with N padded as on the card."""
    real = backends._check_kernel
    monkeypatch.setattr(backends, "_check_kernel",
                        lambda s, p: real(s, "cuda"))
    real_chunk = backends._check_chunk_kernel
    monkeypatch.setattr(backends, "_check_chunk_kernel",
                        lambda s, p: real_chunk(s, "cuda"))


@pytest.mark.parametrize("get", ["full", "smoke"])
def test_flowformer_dt_configs_match_reference(get):
    ours = (get_config if get == "full" else get_smoke_config)("flowformer_dt")
    ref = (j_get_config if get == "full" else j_smoke_config)("flowformer_dt")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.attention.chunk_size == 0 and ours.max_seq_len == 180


@pytest.mark.parametrize("horizon", HORIZONS)
def test_trajectories_match_reference(horizon):
    ours = synthetic.trajectories(3, 7, horizon=horizon)
    ref = j_synthetic.trajectories(3, 7, horizon=horizon)
    assert ours.keys() == ref.keys()
    for key in ours:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("which", list(WIDTHS))
def test_decision_params_round_trip_bit_exact(trees, which):
    tree = trees[which, 20]
    cfg = port_config(which)
    params = params_from_numpy(tree, cfg)
    assert sorted(params) == ["action_head", "blocks", "embed_action",
                              "embed_rtg", "embed_state", "embed_t",
                              "final_norm"]
    back = params_to_numpy(params, cfg)
    (a_leaves, a_def), (b_leaves, b_def) = (jax.tree.flatten(back),
                                            jax.tree.flatten(tree))
    assert a_def == b_def
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="blocks"):
        params_from_numpy(tree, dataclasses.replace(cfg, n_layers=3))
    mine = decision.init(cfg, torch.Generator().manual_seed(0),
                         state_dim=STATE_DIM, action_dim=ACTION_DIM,
                         max_ep_len=20, device="cpu")
    (got, got_def) = jax.tree.flatten(params_to_numpy(mine, cfg))
    assert got_def == b_def
    for a, b in zip(got, b_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("which", list(WIDTHS))
@pytest.mark.parametrize("horizon", HORIZONS)
@pytest.mark.parametrize("backend", ["auto", "cuda_fused"])
def test_decision_forward_loss_and_grads_match_reference(
        trees, monkeypatch, which, horizon, backend):
    if backend == "cuda_fused":
        kernel_glue_on_cpu(monkeypatch)
    jcfg, cfg = j_config(which), port_config(which, backend=backend)
    batch = batch_of(horizon, seed=horizon)
    want_pred, j_loss, j_grads = j_reference(trees[which, horizon], batch,
                                             jcfg)
    params = params_from_numpy(trees[which, horizon], cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    shapes = attention.ShapeInfo(b=3, hq=cfg.n_heads, hkv=cfg.kv_heads,
                                 n=3 * horizon, m=3 * horizon,
                                 d=cfg.dim_head, dv=cfg.dim_head)
    ex = attention.resolve(plan_of(cfg, needs_grad=True))
    assert ex.backend("forward", shapes, "cpu").name == (
        "cumsum" if backend == "auto" else "cuda_fused")
    before = dict(LAUNCHES)
    with torch.no_grad():
        pred = decision.forward(params, tb["rtg"], tb["states"],
                                tb["actions_in"], tb["timesteps"], cfg,
                                dtype=F32)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               **OUT_TOL)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = decision.loss_fn(params, tb, cfg, dtype=F32)
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    grads = torch.autograd.grad(loss, leaves)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_grads),
                                         cfg))
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"leaf {i}",
                                   **GRAD_TOL)
    assert dict(LAUNCHES) == before  # the CPU runs no kernel


@pytest.mark.parametrize("kind", ["softmax", "linear"])
def test_decision_other_kinds_match_reference(trees, kind):
    """The Table 7 harness's other two rows at D = 24, T = 20."""
    jcfg, cfg = j_config("d24", kind), port_config("d24", kind)
    batch = batch_of(20, seed=1)
    want_pred, j_loss, j_grads = j_reference(trees["d24", 20], batch, jcfg)
    params = params_from_numpy(trees["d24", 20], cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = decision.loss_fn(params, tb, cfg, dtype=F32)
    np.testing.assert_allclose(loss.item(), float(j_loss), **OUT_TOL)
    with torch.no_grad():
        pred = decision.forward(params, tb["rtg"], tb["states"],
                                tb["actions_in"], tb["timesteps"], cfg,
                                dtype=F32)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               **OUT_TOL)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_grads),
                                         cfg))
    for i, (g, w) in enumerate(zip(torch.autograd.grad(loss, leaves), want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"leaf {i}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("which", list(WIDTHS))
def test_one_adamw_step_matches_the_harness(trees, which):
    """``launch.make_step`` against the harness's step (``adamw_update``
    with weight decay 1e-4 and clip 0.25 at the warmup-cosine rate of step
    5 of 120), fp32, T = 20."""
    jcfg, cfg = j_config(which), port_config(which)
    tree = trees[which, 20]
    batch = batch_of(20, n=4, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, tree)
    _, g = jax.value_and_grad(lambda p: jdecision.loss_fn(
        p, jb, jcfg, dtype=jnp.float32), has_aux=True)(jp)
    lr = j_warmup_cosine(jnp.asarray(5), peak_lr=1e-3, warmup=20, total=120)
    j_new, _, _ = j_adamw_update(g, j_adamw_init(jp), jp, lr, JAdamWConfig(
        weight_decay=1e-4, grad_clip=0.25))
    params = params_from_numpy(tree, cfg)
    step = launch.make_step(cfg, total=120, dtype=F32)
    new, opt, loss = step(params, adamw_init(params),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          5)
    assert opt.step == 1 and torch.isfinite(loss)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_new),
                                         cfg))
    for i, (a, b) in enumerate(zip(tree_leaves(new), want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# K1 and K2 on their padded routes: N to the kernel's chunk, D 24 -> 32
# ---------------------------------------------------------------------------
RTOL, ATOL = 2e-4, 2e-5  # test_torch_flow.py's
PAD_CASES = [("sigmoid", 1, 60), ("sigmoid", 2, 180), ("elu1", 1, 180),
             ("relu", 2, 60)]


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def padded_inputs(phi, g, n_valid, seed):
    """q, k, v at D = 24 over N = n_valid rounded up to 64, numpy, and the
    same as torch tensors."""
    rng = np.random.default_rng(seed)
    bh, n = 2, -(-n_valid // 64) * 64
    q = rng.standard_normal((bh, g, n, 24)).astype(np.float32)
    k = rng.standard_normal((bh, n, 24)).astype(np.float32)
    v = rng.standard_normal((bh, n, 24)).astype(np.float32)
    if phi == "relu":  # a row whose phi is all zero
        q[0, :, 3] = -np.abs(q[0, :, 3])
        k[1, 5] = -np.abs(k[1, 5])
    return (q, k, v), [torch.from_numpy(x) for x in (q, k, v)]


@pytest.mark.parametrize("phi,g,n_valid", PAD_CASES)
def test_padded_k1_twins_match_the_reference_kernel(phi, g, n_valid):
    (q, k, v), (tq, tk, tv) = padded_inputs(phi, g, n_valid, n_valid + g)
    bh, n = q.shape[0], q.shape[2]
    lens = jnp.full((bh,), n_valid, jnp.int32)
    want_out, want_sums = j_fused_call(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), lens, chunk=64,
                                       eps=1e-6, phi=phi, use_alloc=True,
                                       interpret=True)
    tl = torch.full((bh,), n_valid, dtype=torch.int32)
    for name, (out, sums) in {
            "flow_fused_call": flow_fused_call(tq, tk, tv, tl, chunk=64,
                                               phi=phi),
            "flow_fused_parallel": flow_fused_parallel(
                tq, tk, tv, tl, chunk=64, tile=256, phi=phi)}.items():
        assert out.shape == (bh, g, n, 24)
        close(out.numpy()[:, :, :n_valid],
              np.asarray(want_out)[:, :, :n_valid], f"{name} out")
        for i, (a, b) in enumerate(zip(sums[:5], want_sums[:5])):
            close(a.numpy(), np.asarray(b).reshape(a.shape), f"{name} sum {i}")
        close(sums[5].numpy(), np.asarray(want_sums[5]).reshape(bh, 24, 24),
              f"{name} s")


@pytest.mark.parametrize("n_valid", [60, 180])
@pytest.mark.parametrize("d", [24, 64])
def test_chunk_size_zero_glue_matches_xla_cumsum(monkeypatch, n_valid, d):
    """``flow_fused_forward`` at ``chunk_size=0`` (N padded to 64) against
    the reference's ``xla_cumsum`` prefill, packed and dense, with the
    boundary FlowState."""
    rng = np.random.default_rng(d + n_valid)
    b, hkv, g = 2, 2, 2
    q = rng.standard_normal((b, hkv * g, n_valid, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, n_valid, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, n_valid, d)).astype(np.float32)
    lengths = np.array([n_valid, n_valid // 3], np.int32)
    jex = jattention.resolve(jattention.ExecutionPlan(flow=JFlowConfig(
        causal=True, strict_causal=True, chunk_size=0, backend="xla_cumsum")))
    cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=0)
    for lens in (None, lengths):
        want, wst = jex.prefill(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lengths=None if lens is None
                                else jnp.asarray(lens))
        out, st = flow_fused_forward(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            cfg, return_state=True,
            lengths=None if lens is None else torch.from_numpy(lens))
        rows = n_valid if lens is None else lens
        for i in range(b):
            r = int(np.broadcast_to(rows, (b,))[i])
            close(out[i, :, :r].numpy(), np.asarray(want)[i, :, :r], "out")
        for name in ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s"):
            close(getattr(st, name).numpy(), np.asarray(getattr(wst, name)),
                  name)
    kernel_glue_on_cpu(monkeypatch)
    shapes = attention.ShapeInfo(b=b, hq=hkv * g, hkv=hkv, n=n_valid,
                                 m=n_valid, d=d, dv=d)
    ex = attention.resolve(attention.ExecutionPlan(flow=cfg))
    for op in ("forward", "prefill"):
        assert ex.backend(op, shapes, "cpu").name == "cuda_fused", op


@pytest.mark.parametrize("phi,g,n_valid", PAD_CASES)
def test_padded_k2_twins_match_jax_vjp(phi, g, n_valid):
    (q, k, v), (tq, tk, tv) = padded_inputs(phi, g, n_valid, 7 * n_valid + g)
    bh, n = q.shape[0], q.shape[2]
    rng = np.random.default_rng(n_valid)
    g_out = rng.standard_normal((bh, g, n, 24)).astype(np.float32)
    g_sums = [rng.standard_normal(s).astype(np.float32)
              for s in [(bh, 24)] * 4 + [(bh,), (bh, 24, 24)]]

    def jfn(qx, kx, vx):
        return flow_fused_dot(qx, kx, vx, n_valid, 64, 1e-6, phi, True, True)

    (_, j_sums), pull = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v))
    want = pull((jnp.asarray(g_out), tuple(
        jnp.asarray(x).reshape(y.shape) for x, y in zip(g_sums, j_sums))))
    tl = torch.full((bh,), n_valid, dtype=torch.int32)
    tg = [torch.from_numpy(x) for x in g_sums]
    with torch.no_grad():
        _, totals = flow_fused_call(tq, tk, tv, tl, chunk=64, phi=phi)
    got = {"flow_fused_bwd_call": flow_fused_bwd_call(
               tq, tk, tv, tl, totals, torch.from_numpy(g_out), tg, chunk=64,
               phi=phi),
           "flow_fused_bwd_parallel": flow_fused_bwd_parallel(
               tq, tk, tv, tl, torch.from_numpy(g_out), tg, chunk=64,
               tile=128, phi=phi)}
    for name, grads in got.items():
        for x, a, b in zip("qkv", grads, want):
            assert a.shape[-1] == 24, f"{name} d{x} width"
            assert not a[..., n_valid:, :].any(), f"{name} d{x} padded rows"
            close(a.numpy(), np.asarray(b), f"{name} d{x}")


def test_flow_fused_dot_gives_padded_lanes_and_rows_zero_gradient():
    """The padded lanes live inside the K1/K2 wrappers: ``FlowFusedDot``
    at D = 24 hands back D = 24 gradients, non-zero on the real rows and
    exactly zero on the rows padded past ``n_valid``."""
    (_, _, _), narrow = padded_inputs("sigmoid", 2, 60, 3)
    leaves = [x.clone().requires_grad_(True) for x in narrow]
    out, *sums = FlowFusedDot.apply(*leaves, 60, 64, 1e-6, "sigmoid", True)
    assert out.shape[-1] == 24 and sums[5].shape[1:] == (24, 24)
    (out.square().sum() + sums[5].sum() + sums[0].sum()).backward()
    for x in leaves:
        assert x.grad.shape[-1] == 24 and x.grad.abs().sum() > 0
        assert not x.grad[..., 60:, :].any()


@pytest.mark.parametrize("d", [24, 32])
def test_paper_causal_chunk_size_zero_through_cuda_chunk(monkeypatch, d):
    """``strict_causal=False`` at ``chunk_size=0``: ``cuda_chunk``'s glue
    (K5a at its own chunk, D = 24 padded to 32; its plain versions on the
    CPU) against the reference's ``xla_cumsum``, with gradients."""
    kernel_glue_on_cpu(monkeypatch)
    rng = np.random.default_rng(d)
    b, h, n = 2, 2, 90
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32)
               for _ in range(3))
    jcfg = JFlowConfig(causal=True, strict_causal=False, chunk_size=0,
                       backend="xla_cumsum")
    want, pull = jax.vjp(jattention.resolve(jattention.ExecutionPlan(
        flow=jcfg)).forward, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    cfg = FlowConfig(causal=True, strict_causal=False, chunk_size=0)
    ex = attention.resolve(attention.ExecutionPlan(flow=cfg, needs_grad=True))
    shapes = attention.ShapeInfo(b=b, hq=h, hkv=h, n=n, m=n, d=d, dv=d)
    assert ex.backend("forward", shapes, "cpu").name == "cuda_chunk"
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ex.forward(*leaves)
    close(out.detach().numpy(), np.asarray(want), "out")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for x, a, w in zip("qkv", grads, pull(jnp.asarray(cot))):
        close(a.numpy(), np.asarray(w), f"d{x}")


def test_launcher_trains_and_rolls_out_on_the_cpu(capsys):
    out = launch.main(["--table7", "--kind", "linear", "--steps", "2",
                       "--batch", "4", "--device", "cpu"])
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert out["cfg"].dim_head == 24 and out["cfg"].attention.kind == "linear"
    assert np.isfinite(out["return"])
    text = capsys.readouterr().out
    assert "horizon 20 (N = 60)" in text and "rollout of 16 episodes" in text
