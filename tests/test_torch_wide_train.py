"""Port vs reference: a training step of the wide-head families.

DeepSeek-V2-Lite's and RecurrentGemma-9B's smoke configs at their real
head widths (MLA q and k nope 128 + rope 64 = 192 wide, v 128; a flow
head of 256 over one kv head, G = 4), the reference's parameters
(``repro.models.lm.init``) carried across with ``repro_torch.interop``:
the loss and every gradient leaf of one fp32 step against
``jax.value_and_grad(repro.models.lm.loss_fn)``.  On the CPU the port
trains on the plain backend, and, with the kernel routes' device check
lifted (``backends._check_fused_kernel``), on ``cuda_fused``'s glue:
``FlowFusedDot`` forward and backward with K1's and K2's wrappers running
their plain versions, as on the card they launch K1 and K2 at (192, 128)
and (256, 256).  The reference's ``train`` fails on jax 0.9 (ROADMAP
queue 3), so the step is the loss and its gradient.

Tolerances (``test_torch_archs.py``'s): the loss at rtol 1e-5, each
gradient leaf within 1e-4 of that leaf's max |grad| (the same fp32 sums
in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.attention import backends  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_fused import bwd as k2_wrapper  # noqa: E402
from repro_torch.kernels.flow_fused import ops as k1_wrapper  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import check_flow_trainable  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32


def wide(cfg, arch):
    """``cfg`` at the arch's real head widths (the smoke config's d_model,
    heads, vocab and depth otherwise)."""
    if arch == "deepseek_v2_lite_16b":
        return dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_head_dim=128, rope_head_dim=64, v_head_dim=128))
    return dataclasses.replace(cfg, head_dim=256)


def models(arch):
    jcfg = wide(j_smoke_config(arch), arch)
    cfg = wide(get_smoke_config(arch), arch)
    jparams = jlm.init(jax.random.PRNGKey(5), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg)


@pytest.mark.parametrize("route", ["plain", "kernel_glue"])
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "recurrentgemma_9b"])
def test_wide_head_training_step_matches_reference(arch, route, monkeypatch):
    jcfg, jparams, cfg, params = models(arch)
    heads = {"deepseek_v2_lite_16b": (192, 128), "recurrentgemma_9b": (256,
                                                                       256)}
    seq = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (2, 49)).astype(np.int32)
    jbatch = {"inputs": jnp.asarray(seq[:, :-1]),
              "targets": jnp.asarray(seq[:, 1:])}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jbatch, jcfg, dtype=jnp.float32),
        has_aux=True)(jparams)
    calls = {"k1": 0, "k2": 0}
    if route == "kernel_glue":
        monkeypatch.setattr(backends, "_check_fused_kernel",
                            lambda shapes, platform: None)
        for mod, name, key in ((k1_wrapper, "flow_fused_ref", "k1"),
                               (k2_wrapper, "flow_fused_bwd_ref", "k2")):
            real = getattr(mod, name)

            def counted(*a, _real=real, _key=key, **kw):
                calls[_key] += 1
                assert tuple(a[0].shape[-1:]) == heads[arch][:1]
                assert tuple(a[2].shape[-1:]) == heads[arch][1:]
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    be = check_flow_trainable(cfg, ShapeSpec("t", 48, 2, "train"), "cpu")
    assert be.name == ("cuda_fused" if route == "kernel_glue"
                       else "fused_causal")
    port = tree_map(lambda x: x.clone().requires_grad_(True), params)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    before = dict(LAUNCHES)
    loss, _ = lm.loss_fn(port, batch, cfg, dtype=F32)
    flat = iter(torch.autograd.grad(loss, tree_leaves(port)))
    assert LAUNCHES == before, "the CPU path must not count a launch"
    n_flow = sum(cfg.block_kind(i) in ("attn", "local")
                 for i in range(cfg.n_layers))
    if route == "kernel_glue":  # K1 forward and remat recompute, K2 once
        assert calls == {"k1": (2 if cfg.remat else 1) * n_flow,
                         "k2": n_flow}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = params_to_numpy(tree_map(lambda _: next(flat), port), cfg)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, jg), g in zip(paths, jax.tree.leaves(grads)):
        jg, name = np.asarray(jg), jax.tree_util.keystr(path)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_train_cli_cuts_the_depth_and_takes_adafactor(capsys):
    """``--layers`` cuts the depth at full width and ``--optimizer
    adafactor`` trains with factored moments (the chip run's
    RecurrentGemma-9B phase)."""
    from repro_torch.training.optimizer import AdafactorState

    out = train_cli.main(["--arch", "recurrentgemma-9b", "--smoke",
                          "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--layers", "3", "--optimizer",
                          "adafactor"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(x) for x in out["history"])
    assert isinstance(out["state"].opt, AdafactorState)
    assert len(out["state"].master["blocks"]) == 3
    assert "adafactor" in capsys.readouterr().out
