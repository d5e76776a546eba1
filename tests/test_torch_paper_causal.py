"""Port vs reference: flowformer_lm in the paper-faithful causal mode.

``benchmarks/lm_table4.py`` trains the LM as "paper-faithful causal"
(``attention.strict_causal=False``) and "w/o competition"
(``use_competition=False``); both variants are made here with
``dataclasses.replace`` on ``cfg.attention``, as
``benchmarks/common.py::with_kind`` does.  The same parameters (carried
across with ``interop.params_from_numpy``) and the same numpy batches go
through ``repro.models.lm.loss_fn`` and the port's ``lm.loss_fn`` on the
CPU, for the smoke config with ``chunk_size=16`` over 32 positions:

* the reference pinned to ``pallas_chunk`` (K5a and K5b in interpret
  mode) against the port's ``cuda_chunk`` glue (``FlowChunkDot``, with the
  kernel check patched to take the CPU, so the kernels' plain versions
  run), and the reference's ``xla_chunked`` against the port's
  ``chunked``: loss rtol 1e-6 and every gradient leaf within 1e-5 of that
  leaf's max |grad|, the tolerances of ``tests/test_torch_train.py`` (the
  same fp32 sums in another order);
* three bf16 training steps of ``launch/train.py::train`` against
  ``repro.launch.train.train`` (with an Auto-axis mesh, the workaround for
  the installed jax): losses within 2e-2, as for the strict config (bf16
  rounds at other places in the two frameworks);
* the attention mode leaves the parameter tree as it is, so ``interop``
  needs nothing new;
* training resolves a differentiable backend for both variants, where it
  raised ``ResolutionError`` before the flow_chunk kernels were ported.
"""
import dataclasses

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
from repro_torch.attention import backends  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.steps import check_flow_trainable  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32
VARIANTS = {"paper": dict(strict_causal=False),
            "no_comp": dict(use_competition=False)}


def variant(cfg, name, **over):
    """``cfg`` with ``attention`` replaced as ``with_kind`` replaces it."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, **VARIANTS[name], **over))


def to_port(tree, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init(jax.random.PRNGKey(0), j_smoke_config("flowformer_lm"))


@pytest.mark.parametrize("ref_backend,port_backend",
                         [("pallas_chunk", "cuda_chunk"),
                          ("xla_chunked", "chunked")])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_and_grads_match_reference(jparams, monkeypatch, name,
                                        ref_backend, port_backend):
    jcfg = variant(j_smoke_config("flowformer_lm"), name, chunk_size=16,
                   backend=ref_backend)
    cfg = variant(get_smoke_config("flowformer_lm"), name, chunk_size=16,
                  backend=port_backend)
    if port_backend == "cuda_chunk":
        monkeypatch.setattr(backends, "_check_chunk_kernel",
                            lambda shapes, platform: None)
    batch = next(j_lm_loader(4, batch=2, seq=32, vocab=cfg.vocab_size))
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                              dtype=jnp.float32), has_aux=True)(jparams)
    params = tree_map(lambda x: x.requires_grad_(True), to_port(jparams, cfg))
    before = dict(LAUNCHES)
    loss, _ = lm.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg, dtype=F32)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert LAUNCHES == before, "the CPU path must not count a launch"
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    for i, (a, b) in enumerate(zip(grads, tree_leaves(to_port(j_grads, cfg)))):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"leaf {i}: {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("name,chunk,backend", [("paper", 16, "chunked"),
                                                ("no_comp", 128, "cumsum")])
def test_three_training_steps_match_reference(capsys, name, chunk, backend):
    jcfg = variant(j_smoke_config("flowformer_lm"), name, chunk_size=chunk)
    cfg = variant(get_smoke_config("flowformer_lm"), name, chunk_size=chunk)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref = j_train(jcfg, steps=3, batch=2, seq=32, seed=1, mesh=mesh)
    out = train(cfg, steps=3, batch=2, seq=32, seed=1, device="cpu",
                params=to_port(jlm.init(jax.random.PRNGKey(1), jcfg), cfg))
    assert f"-> {backend}\n" in capsys.readouterr().out
    assert len(out["history"]) == 3 and out["state"].step == 3
    np.testing.assert_allclose(out["history"], ref["history"], atol=2e-2)


def test_interop_tree_is_the_same_in_every_causal_mode(jparams):
    strict = get_smoke_config("flowformer_lm")
    trees = {name: to_port(jparams, variant(strict, name))
             for name in VARIANTS}
    base = to_port(jparams, strict)
    for name, tree in trees.items():
        assert len(tree_leaves(tree)) == len(tree_leaves(base))
        for a, b in zip(tree_leaves(tree), tree_leaves(base)):
            assert torch.equal(a, b), name
        back = params_to_numpy(tree, variant(strict, name))
        assert jax.tree.structure(back) == jax.tree.structure(jparams)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("platform,want", [("cuda", "cuda_chunk"),
                                           ("cpu", "chunked")])
def test_training_resolves_for_both_variants(name, platform, want):
    """The full-width config at the ``lm_table4.py --full`` size."""
    cfg = variant(get_config("flowformer_lm"), name)
    be = check_flow_trainable(cfg, ShapeSpec("custom", 512, 16, "train"),
                              platform)
    assert be.name == want and "forward" in be.differentiable
