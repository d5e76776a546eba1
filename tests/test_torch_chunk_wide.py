"""Port vs reference: the causal dot (K5a, K5b) at the wide head pairs.

K5a and K5b take (D, Dv) = (192, 128) (DeepSeek-V2-Lite's MLA heads),
(128, 192) (their dq call: ``FlowChunkDot`` swaps k and v), (192, 192)
(Nemotron-4-340B's) and (256, 256) (RecurrentGemma-9B's), beside the
products of ``HEAD_DIMS`` (``_lib.CHUNK_PAIRS``).  On the CPU the
wrappers run their plain versions, so this file holds, on the same numpy
inputs:

* (a) the plain versions (``flow_chunk_ref``, ``flow_chunk_parallel``,
  ``flow_chunk_dkv_ref``, ``flow_chunk_dkv_parallel`` and the wrappers)
  against ``repro.kernels.flow_chunk``'s Pallas kernels in interpret mode
  at the four pairs, G 1 and 4, N 64, chunk 32;
* (b) one paper-causal (``strict_causal=False``) training step of the wide
  smoke configs (``test_torch_wide_train.py::wide``) against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` on the reference's
  parameters: on the plain backend, and through ``cuda_chunk``'s glue
  with its device check judging as on "cuda", where the K5a and K5b
  wrappers run their plain versions (3 K5a and 1 K5b a layer);
* (c) the registry's choices on "cuda": the paper-causal and
  no-competition modes resolve ``cuda_chunk`` at every pair,
  ``cp_causal``'s shard-local inner K5a, the linear branch reaches the
  wrappers at RecurrentGemma's (256, 256), and the sequence-sharded
  prefill plan of the wide DeepSeek config binds ``cp_causal`` with no
  fall-back;
* (d) ``cp_causal`` at (192, 128) against the reference's ``cp_causal``
  on a 4-device Auto-axis mesh under ``jax.jit`` (as
  ``tests/test_torch_cp.py``).

Tolerances: (a) ``test_torch_chunk.py``'s rtol 2e-4, atol 2e-5; (b) the
loss at rtol 1e-5, each gradient leaf within 1e-4 of that leaf's max
|grad| (``test_torch_wide_train.py``'s); (c) the prefill's logits and
states 1e-4 of their max; (d) ``test_torch_cp.py``'s 1e-4 for outputs and
states, 5e-3 for the gradients of sum(out^2).  Everything is fp32.
"""
import dataclasses
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flow_chunk.bwd import flow_chunk_dkv_call as j_dkv_call  # noqa: E402
from repro.kernels.flow_chunk.flow_chunk import flow_chunk_call as j_chunk_call  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention import (ExecutionPlan, FlowConfig,  # noqa: E402
                                   ShapeInfo, ShardSpec, backends, cp)
from repro_torch.attention.dots import causal_dot_grouped  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES, PAIR_LAUNCHES  # noqa: E402
from repro_torch.kernels._lib import CHUNK_PAIRS  # noqa: E402
from repro_torch.kernels.flow_chunk import ops as k5_wrappers  # noqa: E402
from repro_torch.kernels.flow_chunk import (flow_chunk_call,  # noqa: E402
                                            flow_chunk_dkv_call,
                                            flow_chunk_dkv_parallel,
                                            flow_chunk_dkv_ref,
                                            flow_chunk_parallel, flow_chunk_ref)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import (RunPlan, build_prefill_step,  # noqa: E402
                                      check_flow_trainable)
from repro_torch.layers import attention as attn_layer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

from test_sharding import run_with_devices  # noqa: E402
from test_torch_chunk import dot_operands  # noqa: E402
from test_torch_wide_train import models, wide  # noqa: E402

F32 = torch.float32
RTOL, ATOL = 2e-4, 2e-5
WIDE = ((192, 128), (128, 192), (192, 192), (256, 256))
ARCH_PAIRS = {"deepseek_v2_lite_16b": (192, 128),
              "recurrentgemma_9b": (256, 256)}


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def paper(cfg):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, strict_causal=False))


def judged_as_cuda(monkeypatch):
    """``cuda_chunk``'s check judging the CPU as the card (its dims check
    still applies), so its glue runs with the wrappers' plain versions."""
    real = backends._check_chunk_kernel
    monkeypatch.setattr(backends, "_check_chunk_kernel",
                        lambda shapes, platform: real(shapes, "cuda"))


def counted_wrappers(monkeypatch):
    """Count the K5a and K5b wrappers' plain runs by (D, Dv)."""
    calls = []
    for name, key in (("flow_chunk_ref", "k5a"),
                      ("flow_chunk_dkv_ref", "k5b")):
        real = getattr(k5_wrappers, name)

        def counted(*a, _real=real, _key=key):
            calls.append((_key, a[0].shape[-1], a[2].shape[-1]))
            return _real(*a)

        monkeypatch.setattr(k5_wrappers, name, counted)
    return calls


# --- (a) the plain versions against the Pallas kernels ------------------------

@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d,dv", WIDE)
def test_plain_versions_match_pallas_at_the_wide_pairs(d, dv, g):
    assert (d, dv) in CHUNK_PAIRS
    rng = np.random.default_rng(d + dv + g)
    q, k, v, cot = dot_operands(rng, (2,), g, 64, d, dv)
    want = j_chunk_call(*map(jnp.asarray, (q, k, v)), chunk=32,
                        interpret=True)
    before, pairs = dict(LAUNCHES), dict(PAIR_LAUNCHES)
    close(flow_chunk_ref(t(q), t(k), t(v)), want, "flow_chunk_ref")
    close(flow_chunk_parallel(t(q), t(k), t(v), 32), want,
          "flow_chunk_parallel")
    close(flow_chunk_call(t(q), t(k), t(v)), want, "flow_chunk_call (cpu)")
    j_dk, j_dv = j_dkv_call(*map(jnp.asarray, (q, k, v, cot)), chunk=32,
                            interpret=True)
    for name, got in (
            ("flow_chunk_dkv_ref", flow_chunk_dkv_ref(t(q), t(k), t(v),
                                                      t(cot))),
            ("flow_chunk_dkv_parallel", flow_chunk_dkv_parallel(
                t(q), t(k), t(v), t(cot), 32)),
            ("flow_chunk_dkv_call (cpu)", flow_chunk_dkv_call(
                t(q), t(k), t(v), t(cot)))):
        close(got[0], j_dk, f"{name} dk")
        close(got[1], j_dv, f"{name} dv")
    assert LAUNCHES == before, "the CPU path must not count a launch"
    assert PAIR_LAUNCHES == pairs, "the CPU path must not count a launch"


# --- (b) one paper-causal training step of the wide smoke configs -------------

@pytest.mark.parametrize("route", ["plain", "kernel_glue"])
@pytest.mark.parametrize("arch", list(ARCH_PAIRS))
def test_paper_causal_wide_training_step_matches_reference(arch, route,
                                                           monkeypatch):
    jcfg, jparams, cfg, params = models(arch)
    jcfg, cfg = paper(jcfg), paper(cfg)
    d, dv = ARCH_PAIRS[arch]
    seq = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (2, 49)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(seq[:, :-1]),
              "targets": jnp.asarray(seq[:, 1:])}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, jcfg, dtype=jnp.float32),
        has_aux=True)(jparams)
    calls = []
    if route == "kernel_glue":
        judged_as_cuda(monkeypatch)
        calls = counted_wrappers(monkeypatch)
    be = check_flow_trainable(cfg, ShapeSpec("t", 48, 2, "train"), "cpu")
    assert (be.name == "cuda_chunk") == (route == "kernel_glue")
    port = tree_map(lambda x: x.clone().requires_grad_(True), params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    before = dict(LAUNCHES)
    loss, _ = lm.loss_fn(port, batch, cfg, dtype=F32)
    flat = iter(torch.autograd.grad(loss, tree_leaves(port)))
    assert LAUNCHES == before, "the CPU path must not count a launch"
    if route == "kernel_glue":
        n_flow = sum(cfg.block_kind(i) in ("attn", "local")
                     for i in range(cfg.n_layers))
        fwd = (2 if cfg.remat else 1) * n_flow  # forward, remat recompute
        assert sorted(calls) == sorted(
            [("k5a", d, dv)] * fwd + [("k5a", dv, d)] * n_flow
            + [("k5b", d, dv)] * n_flow)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = params_to_numpy(tree_map(lambda _: next(flat), port), cfg)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, jg), g in zip(paths, jax.tree.leaves(grads)):
        jg, name = np.asarray(jg), jax.tree_util.keystr(path)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


# --- (c) resolution on "cuda" -------------------------------------------------

@pytest.mark.parametrize("d,dv", WIDE)
def test_cuda_resolves_k5a_at_the_wide_pairs(d, dv):
    """The paper-causal and no-competition modes resolve ``cuda_chunk``
    (forward and training); ``cp_causal``'s ``auto`` inner at the local
    shapes of a 4-way split is K5a; the strict mode keeps K1 (and, at a
    group K2 takes, K2)."""
    g = 16 if d == 256 else 1
    shapes = ShapeInfo(b=4, hq=g * (1 if d == 256 else 16),
                       hkv=1 if d == 256 else 16, n=4096, m=4096, d=d, dv=dv)
    for mode in (dict(strict_causal=False), dict(use_competition=False)):
        cfg = FlowConfig(causal=True, chunk_size=128, **mode)
        plan = ExecutionPlan(flow=cfg)
        assert attention.resolve(plan).backend(
            "forward", shapes, "cuda").name == "cuda_chunk"
        assert attention.resolve_for_training(plan, shapes,
                                              "cuda").name == "cuda_chunk"
    strict = FlowConfig(causal=True, strict_causal=True, chunk_size=128)
    mesh = make_mesh((4,), ("seq",), devices=["cpu"])
    shard = ShardSpec(axis="seq", mesh=mesh)
    local = dataclasses.replace(shapes, n=1024, m=1024)
    assert cp.resolve_inner(strict, local, "cuda", shard).name == "cuda_chunk"
    rows = dict((n, w) for n, ok, w in attention.explain(
        ExecutionPlan(flow=strict, shard=shard), shapes, platform="cuda",
        op="forward").sections[0][1])
    assert "inner=cuda_chunk" in rows["cp_causal"]
    if (d, dv) != (128, 192):
        assert attention.resolve(ExecutionPlan(flow=strict)).backend(
            "forward", shapes, "cuda").name == "cuda_fused"


def test_linear_branch_reaches_k5a_at_d256(monkeypatch):
    """RecurrentGemma's local slots as the linear branch at its (256, 256)
    heads, G = 4 (the smoke config's): the causal dot on the kernel route
    (``use_kernel=True``, as a CUDA tensor takes it) runs the K5a wrapper
    at (256, 256) forward, K5a at (256, 256) for dq and K5b backward, and
    matches the plain dot's output and gradients."""
    calls = counted_wrappers(monkeypatch)
    cfg = wide(get_smoke_config("recurrentgemma_9b"), "recurrentgemma_9b")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind="linear"))
    blk = attn_layer.attn_init(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    outs, grads = {}, {}
    for use_kernel in (True, False):
        def dot(*a, use_kernel=None, _k=use_kernel, **kw):
            return causal_dot_grouped(*a, use_kernel=_k, **kw)

        monkeypatch.setattr(attn_layer, "causal_dot_grouped", dot)
        leaves = tree_map(lambda p: p.clone().requires_grad_(True), blk)
        out = attn_layer.attention(leaves, x, cfg, causal=True)
        grads[use_kernel] = torch.autograd.grad(
            (out ** 2).sum(), tree_leaves(leaves))
        outs[use_kernel] = out.detach()
    assert sorted(calls) == [("k5a", 256, 256)] * 2 + [("k5b", 256, 256)]
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-4, atol=1e-5)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_seq_sharded_prefill_of_wide_deepseek_binds_cp_causal(
        monkeypatch, capsys):
    """``build_prefill_step(seq_shard=True)`` for the wide DeepSeek smoke
    config, judged on "cuda": the sharded plan binds (no fall-back line);
    run with ``cuda_chunk`` judging the CPU as the card, every layer runs
    the K5a wrapper once a position at (192, 128) and the logits and every
    boundary FlowState match the unsharded ``lm.prefill``."""
    cfg = wide(get_smoke_config("deepseek_v2_lite_16b"),
               "deepseek_v2_lite_16b")
    monkeypatch.setattr(steps, "_platform", lambda mesh: "cuda")
    judged_as_cuda(monkeypatch)
    calls = counted_wrappers(monkeypatch)
    rows, n = 2, 64
    step, _, _, _ = build_prefill_step(
        cfg, ShapeSpec("prefill", n, rows, "prefill"),
        make_mesh((1, 4), ("data", "model"), devices=["cpu"]), RunPlan(),
        seq_shard=True, dtype=F32)
    assert "fell back" not in capsys.readouterr().out
    params = lm.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (rows, n)))
    with torch.no_grad():
        logits, caches = step(params, {"inputs": toks})
        assert calls == [("k5a", 192, 128)] * (4 * cfg.n_layers)
        want, want_caches = lm.prefill(params, toks, cfg, n, dtype=F32)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    assert rel(logits, want) <= 1e-4
    for got, ref in zip(caches, want_caches):
        assert torch.equal(got.t, ref.t)
        for f in ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s"):
            assert rel(getattr(got, f), getattr(ref, f)) <= 1e-4, f


# --- (d) cp_causal at (192, 128) against the reference ------------------------

CP_B, CP_H, CP_N, CP_D, CP_DV = 2, 2, 64, 192, 128
CP_CFG = FlowConfig(causal=True, strict_causal=True, chunk_size=8)
OUT_TOL, GRAD_TOL = 1e-4, 5e-3


def cp_inputs():
    rng = np.random.default_rng(5)
    return {"q": rng.standard_normal((CP_B, CP_H, CP_N, CP_D)).astype(
                np.float32),
            "k": rng.standard_normal((CP_B, CP_H, CP_N, CP_D)).astype(
                np.float32),
            "v": rng.standard_normal((CP_B, CP_H, CP_N, CP_DV)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def cp_reference(tmp_path_factory):
    """The reference's cp_causal on a 4-device CPU mesh at (192, 128)."""
    d = tmp_path_factory.mktemp("cp_wide")
    np.savez(d / "in.npz", **cp_inputs())
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro import attention
        from repro.attention import ExecutionPlan, FlowConfig, ShardSpec

        x = np.load({str(d / "in.npz")!r})
        q, k, v = (jnp.asarray(x[n]) for n in "qkv")
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
        cfg = FlowConfig(causal=True, strict_causal=True, chunk_size=8)
        ex = attention.resolve(ExecutionPlan(
            flow=cfg, shard=ShardSpec(axis="seq", mesh=mesh)))
        out = {{"fwd": jax.jit(ex.forward)(q, k, v)}}

        def sq(q, k, v):
            return (ex.forward(q, k, v).astype(jnp.float32) ** 2).sum()
        for n, g in zip("qkv", jax.jit(jax.grad(sq, argnums=(0, 1, 2)))(
                q, k, v)):
            out["d" + n] = g
        o, st = jax.jit(ex.prefill)(q, k, v)
        out["pf_out"] = o
        for f in st._fields:
            out["pf_" + f] = getattr(st, f)
        np.savez({str(d / "out.npz")!r},
                 **{{k: np.asarray(v) for k, v in out.items()}})
        print("done")
    """)
    run_with_devices(code, 4)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("route", ["plain", "kernel_glue"])
def test_cp_causal_at_d192_matches_reference(cp_reference, route,
                                             monkeypatch):
    """The port's cp_causal on a 4-way CPU mesh: its ``auto`` inner
    (``chunked`` on the CPU), and ``cuda_chunk``'s glue judged as on the
    card (the K5a and K5b wrappers' plain versions, ``ways`` K5a a
    forward, 2 ``ways`` K5a and ``ways`` K5b a gradient)."""
    calls = []
    if route == "kernel_glue":
        judged_as_cuda(monkeypatch)
        calls = counted_wrappers(monkeypatch)
    ex = attention.resolve(ExecutionPlan(flow=CP_CFG, shard=ShardSpec(
        axis="seq", mesh=make_mesh((4,), ("seq",), devices=["cpu"]))))
    x = cp_inputs()
    q, k, v = (torch.tensor(x[n]) for n in "qkv")
    with torch.no_grad():
        out = ex.forward(q, k, v)
        pf_out, state = ex.prefill(q, k, v)
    if route == "kernel_glue":
        assert calls == [("k5a", CP_D, CP_DV)] * 8
    leaves = [y.clone().requires_grad_(True) for y in (q, k, v)]
    grads = torch.autograd.grad((ex.forward(*leaves) ** 2).sum(), leaves)
    if route == "kernel_glue":
        assert sorted(calls[8:]) == sorted(
            [("k5a", CP_D, CP_DV)] * 4 + [("k5a", CP_DV, CP_D)] * 4
            + [("k5b", CP_D, CP_DV)] * 4)

    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())

    assert err(out, cp_reference["fwd"]) < OUT_TOL
    assert err(pf_out, cp_reference["pf_out"]) < OUT_TOL
    for f in ("q_sum", "k_sum", "ko_sum", "qi_sum", "z", "s"):
        ref = cp_reference["pf_" + f]
        assert err(getattr(state, f), ref) < OUT_TOL * max(
            1.0, float(np.abs(ref).max())), f
    for n, g in zip("qkv", grads):
        assert err(g, cp_reference["d" + n]) < GRAD_TOL, n
