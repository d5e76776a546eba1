"""Port vs reference: the dense LM architectures (granite_8b,
nemotron_4_15b, deepseek_coder_33b) and the FFN activations they need.

The reference's smoke parameters (``repro.models.lm.init``; d 128, 8
query heads over 2 kv heads of 16, so shared GQA at G = 4) are carried
across with ``repro_torch.interop``; the same inputs, drawn with numpy
from a fixed seed, go through both packages in fp32 on the CPU.

Tolerances: the FFN at rtol 1e-5 and atol 1e-5 (two matmuls and one
activation); logits at rtol 1e-4 and atol 1e-4, the loss at rtol 1e-5 and
each gradient leaf within 1e-4 of that leaf's max |grad| (the same fp32
sums in another order, XLA against PyTorch's CPU kernels); prefill plus
decode against the full forward at rtol 1e-4 and atol 1e-4 x max |logit|
(the recurrence and the chunked scan against the full-sequence scan).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.layers import ffn as jffn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.layers import ffn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

DENSE = ("granite_8b", "nemotron_4_15b", "deepseek_coder_33b")
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               err_msg=what, **(tol or TOL))


@pytest.mark.parametrize("act", ["gelu", "swiglu", "squared_relu", "relu"])
def test_ffn_matches_reference(act):
    jp = jffn.ffn_init(jax.random.PRNGKey(3), 64, 96, act)
    params = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    assert set(params) == ({"w_in", "w_out", "w_gate"} if act == "swiglu"
                           else {"w_in", "w_out"})
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(
        np.float32)
    want = jffn.ffn(jp, jnp.asarray(x), act)
    got = ffn.ffn(params, torch.from_numpy(x), act)
    close(got, want, act, rtol=1e-5, atol=1e-5)
    ours = ffn.ffn_init(torch.Generator().manual_seed(0), 64, 96, act)
    assert {k: tuple(v["w"].shape) for k, v in ours.items()} == {
        k: tuple(v["w"].shape) for k, v in jp.items()}


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("get", ["full", "smoke"])
def test_dense_configs_match_reference(arch, get):
    ours = (get_config if get == "full" else get_smoke_config)(
        arch.replace("_", "-"))
    ref = (j_get_config if get == "full" else j_smoke_config)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()


def model(arch):
    jcfg = j_smoke_config(arch)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg)
    return jcfg, jparams, cfg, params, tree


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_loss_and_gradients_match_reference(arch):
    """Logits, the loss and every gradient of the smoke LM, and the
    parameter tree (with swiglu's ``w_gate``) carried back bit for bit."""
    jcfg, jparams, cfg, params, tree = model(arch)
    rng = np.random.default_rng(7)
    seq = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(seq[:, :-1]),
              "targets": jnp.asarray(seq[:, 1:])}
    j_logits, _ = jlm.forward(jparams, jbatch["inputs"], jcfg,
                              dtype=jnp.float32)
    logits, _ = lm.forward(params, torch.from_numpy(seq[:, :-1]), cfg,
                           dtype=F32)
    close(logits, j_logits, f"{arch} logits")
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, jcfg, dtype=jnp.float32),
        has_aux=True)(jparams)
    port = tree_map(lambda x: x.clone().requires_grad_(True), params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss, _ = lm.loss_fn(port, batch, cfg, dtype=F32)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat = iter(torch.autograd.grad(loss, tree_leaves(port)))
    # the port's per-layer gradients restacked into the reference's layout
    grads = params_to_numpy(tree_map(lambda _: next(flat), port), cfg)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert any("w_gate" in jax.tree_util.keystr(p) for p, _ in paths) == (
        cfg.act == "swiglu")
    for (path, jg), g in zip(paths, jax.tree.leaves(grads)):
        jg, name = np.asarray(jg), jax.tree_util.keystr(path)
        scale = float(np.abs(jg).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_granite_prefill_and_decode_match_full_forward():
    """As the reference's ``test_serving.py`` holds it: a 32-token prompt
    prefilled, then 6 decode steps, each step's logits equal to the full
    forward's at that position; and the reference's prefill and decode
    give the same logits."""
    jcfg, jparams, cfg, params, _ = model("granite_8b")
    b, n, t_dec = 2, 32, 6
    seq = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, n + t_dec)).astype(np.int32)
    full, _ = lm.forward(params, torch.from_numpy(seq), cfg, dtype=F32)
    scale = float(full.abs().max())
    tol = dict(rtol=1e-4, atol=1e-4 * scale)
    lg, caches = lm.prefill(params, torch.from_numpy(seq[:, :n]), cfg,
                            n + t_dec, dtype=F32)
    jlg, jcaches = jlm.prefill(jparams, jnp.asarray(seq[:, :n]), jcfg,
                               max_len=n + t_dec, dtype=jnp.float32)
    close(lg, full[:, n - 1:n], "prefill vs forward", **tol)
    close(lg, jlg, "prefill vs reference", **tol)
    for t in range(t_dec):
        tok = seq[:, n + t:n + t + 1]
        lg, caches = lm.decode(params, torch.from_numpy(tok), caches, cfg,
                               n + t, dtype=F32)
        jlg, jcaches = jlm.decode(jparams, jnp.asarray(tok), jcaches, jcfg,
                                  jnp.asarray(n + t), dtype=jnp.float32)
        close(lg, full[:, n + t:n + t + 1], f"decode t={t} vs forward",
              **tol)
        close(lg, jlg, f"decode t={t} vs reference", **tol)


# --- the MoE, MLA and M-RoPE archs -------------------------------------------

#: granite_moe (MoE, G = 4 at the smoke size), deepseek_v2_lite (MoE with
#: shared experts and MLA: D = 48, Dv = 32), qwen2_vl (M-RoPE, the stub
#: frontend), nemotron_4_340b (squared-ReLU, layernorm; D = 16, G = 6)
WIDE = ("granite_moe_3b_a800m", "deepseek_v2_lite_16b", "qwen2_vl_72b",
        "nemotron_4_340b")


@pytest.mark.parametrize("arch", WIDE)
@pytest.mark.parametrize("get", ["full", "smoke"])
def test_moe_mla_mrope_configs_match_reference(arch, get):
    ours = (get_config if get == "full" else get_smoke_config)(
        arch.replace("_", "-"))
    ref = (j_get_config if get == "full" else j_smoke_config)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", WIDE)
def test_moe_mla_mrope_forward_loss_and_gradients_match_reference(arch):
    """Logits, the loss with the MoE's aux summed over the layers, every
    gradient, and the parameter tree (MoE experts stacked (L, E, d, f)
    under scan, MLA's leaves) carried back bit for bit."""
    jcfg, jparams, cfg, params, tree = model(arch)
    rng = np.random.default_rng(17)
    seq = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(seq[:, :-1]),
              "targets": jnp.asarray(seq[:, 1:])}
    j_logits, j_aux = jlm.forward(jparams, jbatch["inputs"], jcfg,
                                  dtype=jnp.float32)
    logits, aux = lm.forward(params, torch.from_numpy(seq[:, :-1]), cfg,
                             dtype=F32)
    close(logits, j_logits, f"{arch} logits")
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-5)
    assert (aux.item() > 0) == (cfg.moe is not None)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, jcfg, dtype=jnp.float32),
        has_aux=True)(jparams)
    port = tree_map(lambda x: x.clone().requires_grad_(True), params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    loss, metrics = lm.loss_fn(port, batch, cfg, dtype=F32)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]),
                               rtol=1e-5)
    flat = iter(torch.autograd.grad(loss, tree_leaves(port)))
    grads = params_to_numpy(tree_map(lambda _: next(flat), port), cfg)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, jg), g in zip(paths, jax.tree.leaves(grads)):
        jg, name = np.asarray(jg), jax.tree_util.keystr(path)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if cfg.moe is not None:  # the experts' leaves stacked (L, E, d, f)
        w_in = tree["scan"][0]["moe"]["experts"]["w_in"]["w"]
        assert w_in.shape[:2] == (cfg.n_layers, cfg.moe.n_experts)
        assert params["blocks"][1]["moe"]["experts"]["w_in"]["w"].shape == \
            w_in.shape[1:]


def test_stub_frontend_embeddings_skip_the_table():
    """Qwen2-VL's stub frontend: float (B, N, d) inputs are the embeddings
    themselves, as the reference's ``_embed_inputs`` takes them."""
    jcfg, jparams, cfg, params, _ = model("qwen2_vl_72b")
    emb = np.random.default_rng(18).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32) * 0.02
    j_logits, _ = jlm.forward(jparams, jnp.asarray(emb), jcfg,
                              dtype=jnp.float32)
    logits, _ = lm.forward(params, torch.from_numpy(emb), cfg, dtype=F32)
    close(logits, j_logits, "stub embeddings")


def test_mrope_matches_reference_and_reduces_to_rope_on_text():
    from repro.layers import rope as jrope
    from repro_torch.layers import rope

    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 3, 13, 16)).astype(np.float32)
    sections = (4, 2, 2)
    streams = rng.integers(0, 50, (2, 3, 13)).astype(np.int32)  # distinct
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(streams), sections)
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(streams),
                           sections)
    close(got, want, "distinct t/h/w streams", rtol=1e-5, atol=1e-5)
    assert not np.allclose(got.numpy(), rope.apply_rope(
        torch.from_numpy(x), torch.from_numpy(streams[:, 0])).numpy())
    text = rope.default_mrope_positions(2, 13, torch.tensor([3, 40]))
    np.testing.assert_array_equal(text.numpy(), np.asarray(
        jrope.default_mrope_positions(2, 13, jnp.asarray([3, 40]))))
    assert torch.equal(rope.apply_mrope(torch.from_numpy(x), text, sections),
                       rope.apply_rope(torch.from_numpy(x), text[:, 0]))
    with pytest.raises(ValueError, match="sum to"):
        rope.apply_mrope(torch.from_numpy(x), text, (4, 2, 1))


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b",
                                  "granite_moe_3b_a800m", "qwen2_vl_72b"])
def test_moe_mla_mrope_prefill_and_decode_match_full_forward(arch):
    """A 32-token prompt prefilled, then 6 decode steps: each step's logits
    equal to the full forward's at that position and to the reference's
    prefill and decode.  The MoE runs at ``capacity_factor = E / k``, its
    exact dispatch: a call's capacity follows its token count, so with
    drops a prefill, a decode step and the full forward would keep
    different tokens."""
    jcfg, jparams, cfg, params, _ = model(arch)
    if cfg.moe is not None:
        exact = cfg.moe.n_experts / cfg.moe.top_k
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=exact))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=exact))
    b, n, t_dec = 2, 32, 6
    seq = np.random.default_rng(20).integers(
        0, cfg.vocab_size, (b, n + t_dec)).astype(np.int32)
    full, _ = lm.forward(params, torch.from_numpy(seq), cfg, dtype=F32)
    scale = float(full.abs().max())
    tol = dict(rtol=1e-4, atol=1e-4 * scale)
    lg, caches = lm.prefill(params, torch.from_numpy(seq[:, :n]), cfg,
                            n + t_dec, dtype=F32)
    jlg, jcaches = jlm.prefill(jparams, jnp.asarray(seq[:, :n]), jcfg,
                               max_len=n + t_dec, dtype=jnp.float32)
    close(lg, full[:, n - 1:n], "prefill vs forward", **tol)
    close(lg, jlg, "prefill vs reference", **tol)
    for t in range(t_dec):
        tok = seq[:, n + t:n + t + 1]
        lg, caches = lm.decode(params, torch.from_numpy(tok), caches, cfg,
                               n + t, dtype=F32)
        jlg, jcaches = jlm.decode(jparams, jnp.asarray(tok), jcaches, jcfg,
                                  jnp.asarray(n + t), dtype=jnp.float32)
        close(lg, full[:, n + t:n + t + 1], f"decode t={t} vs forward",
              **tol)
        close(lg, jlg, f"decode t={t} vs reference", **tol)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "qwen2_vl_72b"])
def test_moe_mla_mrope_engine_matches_reference_engine(arch):
    """The fp32 Engine's greedy tokens against the JAX Engine's, token for
    token: two slots, more requests than slots (packed admission, slot
    churn), the configs' own MoE capacity."""
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest
    from repro_torch.serving.engine import Engine, Request

    jcfg, jparams, cfg, params, _ = model(arch)
    lens, budgets = (5, 17, 9, 30, 3), (4, 7, 1, 5, 6)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    def serve(engine, request_cls):
        for uid, (p, bud) in enumerate(zip(prompts, budgets)):
            engine.submit(request_cls(uid=uid, prompt=p, max_new_tokens=bud))
        return engine.run()

    j_done = serve(JEngine(jparams, jcfg, slots=2, max_len=64,
                           dtype=jnp.float32), JRequest)
    done = serve(Engine(params, cfg, slots=2, max_len=64,
                        dtype=torch.float32, device="cpu"), Request)
    assert [r.uid for r in done] == [r.uid for r in j_done]
    for r, jr in zip(done, j_done):
        assert r.done and len(r.generated) == budgets[r.uid]
        assert r.generated == jr.generated, f"{arch} request {r.uid}"
