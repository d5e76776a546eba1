"""Port vs reference: the Mixture-of-Experts FFN (``layers/moe.py``).

The reference's parameters (``repro.layers.moe.moe_init``) are carried
across leaf for leaf; the same inputs, drawn with numpy from a fixed seed,
go through ``repro.layers.moe.moe`` and the port's ``moe`` in fp32 on the
CPU.  Two capacities: a tight one, where tokens past an expert's capacity
are dropped (the test checks that some are), and ``capacity_factor =
n_experts / top_k``, where the dispatch is exact and both sides also
equal the dense yardsticks (``moe_dense_ref``).  ``torch.topk`` and
``jax.lax.top_k`` may order an expert's zero-weight slots differently, so
outputs are compared, never indices.

Tolerances: outputs at rtol 1e-5 and atol 1e-5 (batched products of the
same fp32 values, summed in another order); the aux loss at rtol 1e-6
(means of the same fp32 probabilities); gradients within 1e-4 of each
leaf's max |grad|, as ``test_torch_archs.py`` holds the LM's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro_torch.config import MoEConfig  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D, F_FF = 64, 48


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what,
                               **(tol or TOL))


def setup(act, n_shared, cf, e=8, k=2, seed=0):
    kw = dict(n_experts=e, n_shared=n_shared, top_k=k, d_ff_expert=F_FF,
              capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, 2 * F_FF, act,
                       JMoEConfig(**kw))
    params = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    x = np.random.default_rng(seed + 1).standard_normal((2, 24, D)).astype(
        np.float32)
    return jp, params, JMoEConfig(**kw), MoEConfig(**kw), x


def dropped(params, x, mcfg):
    """Tokens' (expert, gate) entries past their expert's capacity."""
    xt = torch.from_numpy(x).reshape(-1, D)
    _, gates, idx = moe.route(params, xt, mcfg)
    counts = torch.bincount(idx.reshape(-1), minlength=mcfg.n_experts)
    return int((counts - moe.capacity(xt.shape[0], mcfg)).clamp(min=0).sum())


@pytest.mark.parametrize("n_shared", [0, 2], ids=["routed", "shared"])
@pytest.mark.parametrize("act", ["swiglu", "squared_relu"])
@pytest.mark.parametrize("cf", [0.5, 2.0, 4.0],
                         ids=["drops", "smoke_cf", "exact"])
def test_moe_matches_reference(act, n_shared, cf):
    """Outputs and aux against ``repro.layers.moe.moe``; at cf 0.5 tokens
    are dropped, at cf = E / k = 4 the dispatch is exact and both sides
    equal their dense yardsticks."""
    jp, params, jm, mcfg, x = setup(act, n_shared, cf)
    j_out, j_aux = jmoe.moe(jp, jnp.asarray(x), act, jm)
    out, aux = moe.moe(params, torch.from_numpy(x), act, mcfg)
    close(out, j_out, "out")
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)
    n_drop = dropped(params, x, mcfg)
    if cf == 0.5:
        assert n_drop > 0, "the tight capacity must drop tokens"
    if cf == 4.0:
        assert n_drop == 0
        dense = moe.moe_dense_ref(params, torch.from_numpy(x), act, mcfg)
        close(out, dense, "exact dispatch vs dense")
        close(dense, jmoe.moe_dense_ref(jp, jnp.asarray(x), act, jm),
              "dense yardsticks")


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "exact"])
def test_moe_gradients_match_reference(cf):
    act = "swiglu"
    jp, params, jm, mcfg, x = setup(act, 2, cf, seed=3)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe(p, xx, act, jm)
        return jnp.sum(out * cot) + aux

    j_gp, j_gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    port = tree_map(lambda t: t.clone().requires_grad_(True), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe(port, xt, act, mcfg)
    loss = (out * torch.from_numpy(cot)).sum() + aux
    grads = torch.autograd.grad(loss, [*tree_leaves(port), xt])
    want = [*jax.tree.leaves(j_gp), j_gx]
    assert len(grads) == len(want)
    for g, jg in zip(grads, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * float(np.abs(jg).max()))


def test_moe_init_stacks_the_experts_as_the_reference():
    mc = MoEConfig(n_experts=5, n_shared=1, top_k=2, d_ff_expert=24)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 32, 40, "swiglu",
                       JMoEConfig(**dataclasses.asdict(mc)))
    ours = moe.moe_init(torch.Generator().manual_seed(0), 32, 40, "swiglu",
                        mc)
    shapes = lambda tree: jax.tree.map(np.shape, tree)  # noqa: E731
    assert shapes(tree_map(lambda t: t.numpy(), ours)) == shapes(jp)
    assert ours["experts"]["w_in"]["w"].shape == (5, 32, 24)
    assert ours["shared"]["w_in"]["w"].shape == (32, 24)


def test_moe_combine_is_repeatable_and_in_expert_order():
    """Two calls bitwise equal, and the combine equal to a per-token sum of
    the kept rows taken in expert order, one by one."""
    jp, params, jm, mcfg, x = setup("swiglu", 0, 0.5, seed=5)
    xt = torch.from_numpy(x)
    a, _ = moe.moe(params, xt, "swiglu", mcfg)
    b, _ = moe.moe(params, xt, "swiglu", mcfg)
    assert torch.equal(a, b)
    flat = xt.reshape(-1, D)
    _, gates, idx = moe.route(params, flat, mcfg)
    w_te = torch.zeros((flat.shape[0], mcfg.n_experts)).scatter_(1, idx,
                                                                 gates)
    wv, tok = torch.topk(w_te.t(), moe.capacity(flat.shape[0], mcfg), dim=-1)
    ye = moe._expert_ffn(params["experts"], flat[tok], "swiglu")
    want = torch.zeros_like(flat)
    for t_ in range(flat.shape[0]):
        for e in sorted(idx[t_].tolist()):
            hit = (tok[e] == t_).nonzero()
            if len(hit):
                want[t_] = want[t_] + ye[e, hit[0, 0]] * wv[e, hit[0, 0]]
    assert torch.equal(a.reshape(-1, D), want)


def test_router_jitter_draws_from_the_given_generator():
    _, params, _, mcfg, x = setup("swiglu", 0, 2.0)
    mcfg = dataclasses.replace(mcfg, router_jitter=0.5)
    xt = torch.from_numpy(x)
    draw = lambda seed: moe.moe(params, xt, "swiglu", mcfg,  # noqa: E731
                                gen=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(draw(3), draw(3))
    plain, _ = moe.moe(params, xt, "swiglu", mcfg)  # no generator: no jitter
    assert not torch.equal(draw(3), plain)
    probs, _, _ = moe.route(params, xt.reshape(-1, D), mcfg,
                            gen=torch.Generator().manual_seed(4))
    logits = xt.reshape(-1, D) @ params["router"]["w"]
    noise = 0.5 * torch.randn(logits.shape,
                              generator=torch.Generator().manual_seed(4))
    close(probs, torch.softmax(logits + noise, -1), "jittered probs")
