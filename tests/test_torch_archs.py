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
