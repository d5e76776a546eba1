"""Port vs reference: the RecurrentGemma hybrid stack (rglru, rglru, local).

The reference's parameters (``repro.models.lm.init``) are carried across
with ``interop``; the same numpy inputs go through both packages in fp32
on the CPU, where every port wrapper (K1, K3, K9) runs its plain version.
The local slots run flow attention in flow mode (the configuration's own)
and sliding-window rings in softmax mode (``tests/test_torch_local.py``
holds the rings themselves).  Tolerances, each with its reason:

* the RG-LRU block, prefill (plain and packed) and decode: |port - ref|
  <= 1e-5 |ref| + 1e-5 max |ref| -- the same fp32 recurrence, its scan
  summed in another tree (the port's Hillis-Steele rounds, the
  reference's ``associative_scan``); the bf16 conv histories exactly;
* a packed row's boundary state against the same row prefilled alone: the
  same bound (the scan's tree differs with the padded length);
* K1's and K3's plain versions at D = Dv = 256 against the reference's
  Pallas kernels in interpret mode: rtol 2e-4, atol 2e-5, as
  ``tests/test_torch_mla.py`` holds them at D = 192;
* the LM at 5 layers (one period and a tail of two): loss rtol 1e-5,
  every gradient leaf within 1e-4 of that leaf's max |grad|;
* int8 pools: payloads within 1 LSB (at most a share of 1e-3 differ),
  scales rtol 1e-5, decode outputs rtol 1e-4 and atol 1e-4, as
  ``tests/test_torch_quant.py``;
* the fp32 Engine: token for token (tolerance zero);
* interop and mixer verdicts: exact.
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
from repro.kernels.flow_decode.flow_decode import flow_decode_call as j_decode_call  # noqa: E402
from repro.kernels.flow_fused.flow_fused import flow_fused_call as j_fused_call  # noqa: E402
from repro.layers import mixer as jmixer  # noqa: E402
from repro.layers import rglru as jrglru  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import quant as jquant  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_decode import (flow_decode_call,  # noqa: E402
                                             flow_decode_split)
from repro_torch.kernels.flow_fused import (flow_fused_call,  # noqa: E402
                                            flow_fused_parallel)
from repro_torch.layers import mixer as mixer_lib  # noqa: E402
from repro_torch.layers import rglru, ssd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import quant  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32
ARCH = "recurrentgemma_9b"


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(name, got, want, tol=1e-5):
    """|got - want| <= tol |want| + tol max |want| (see above)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    lim = tol * np.abs(want) + tol * float(np.abs(want).max())
    err = np.abs(got - want)
    assert (err <= lim).all(), f"{name}: max |diff| {float(err.max()):.3e}"


def with_kind(cfg, kind):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind))


def carried(n_layers=None, kind=None, seed=0):
    """(jcfg, jparams, cfg, params): the smoke config (at ``n_layers`` and
    attention ``kind`` where given) in both packages, the reference's
    parameters carried across."""
    jcfg, cfg = j_smoke_config(ARCH), get_smoke_config(ARCH)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if kind:
        jcfg, cfg = with_kind(jcfg, kind), with_kind(cfg, kind)
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


@pytest.fixture(scope="module")
def model():
    return carried()


def test_config_matches_reference():
    for j, c in ((j_get_config(ARCH), get_config(ARCH)),
                 (j_smoke_config(ARCH), get_smoke_config(ARCH))):
        assert c.param_count() == j.param_count()
        assert [c.block_kind(i) for i in range(c.n_layers)] == \
            [j.block_kind(i) for i in range(j.n_layers)]
        for field in ("name", "pattern", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "vocab_size", "max_seq_len",
                      "act", "norm", "rope", "tie_embeddings"):
            assert getattr(c, field) == getattr(j, field), field
        assert vars(c.rglru) == vars(j.rglru)
        assert vars(c.attention) == vars(j.attention)
    full = get_config(ARCH)
    assert (full.dim_head, full.n_heads // full.kv_heads) == (256, 16)


@pytest.mark.parametrize("n_layers", [3, 5, 8])
def test_interop_round_trips_the_hybrid_tree(n_layers):
    """3 and 5 layers (one period, without and with a tail of two) are the
    reference's ``blocks`` layout; 8 its stacked ``scan`` of two periods
    with a tail of two."""
    jcfg, jparams, cfg, params = carried(n_layers)
    tree = jax.tree.map(np.asarray, jparams)
    assert ("scan" in tree) == (n_layers == 8)
    if n_layers == 8:
        assert len(tree["tail"]) == 2
    assert [next(k for k in b if k in ("rglru", "attn"))
            for b in params["blocks"]] == [
        "attn" if jcfg.block_kind(i) == "local" else "rglru"
        for i in range(n_layers)]
    assert set(params["blocks"][0]["rglru"]) == {
        "w_x", "w_gate", "conv_w", "conv_b", "gate_a", "gate_x", "lam",
        "w_out"}
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(lm.init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), cfg)
    assert jax.tree.structure(own) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # the lambda init is the reference's (to 1e-4: log(expm1(a^(-1/8) - 1))
    # amplifies the last bit of linspace's a by ~1/(a^(-1/8) - 1))
    np.testing.assert_allclose(
        own["blocks"][0]["rglru"]["lam"] if "blocks" in own
        else own["scan"][0]["rglru"]["lam"][0],
        tree["blocks"][0]["rglru"]["lam"] if "blocks" in tree
        else tree["scan"][0]["rglru"]["lam"][0], rtol=1e-4)


def layer(model):
    jcfg, jparams, cfg, params = model
    return jcfg, jparams["blocks"][0]["rglru"], cfg, params["blocks"][0][
        "rglru"]


def test_rglru_block_matches_reference(model):
    jcfg, jp, cfg, p = layer(model)
    x = np.random.default_rng(21).standard_normal((3, 40, cfg.d_model),
                                                  np.float32)
    close("rglru_block", rglru.rglru_block(p, t(x), cfg),
          jrglru.rglru_block(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 257])
def test_scan_is_the_recurrence(n):
    """The log-depth scan against the recurrence written as a loop."""
    g = torch.Generator().manual_seed(n)
    a = torch.rand((2, n, 5), generator=g)
    b = torch.randn((2, n, 5), generator=g)
    h, want = torch.zeros((2, 5)), []
    for i in range(n):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    close("scan", rglru._scan(a, b), torch.stack(want, dim=1))


def test_rglru_prefill_and_decode_match_reference(model):
    jcfg, jp, cfg, p = layer(model)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((3, 40, cfg.d_model), np.float32)
    jout, jst = jrglru._rglru_prefill(jp, jnp.asarray(x), jcfg)
    out, st = rglru._rglru_prefill(p, t(x), cfg)
    close("prefill out", out, jout)
    close("prefill h", st.h, jst.h)
    assert st.conv.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.conv.float().numpy(),
                                  np.asarray(jst.conv.astype(jnp.float32)))
    for step in range(3):  # decode, the conv history carried in bf16
        tok = rng.standard_normal((3, 1, cfg.d_model), np.float32)
        jout, jst = jrglru._rglru_decode(jp, jnp.asarray(tok), jst, jcfg)
        out, st = rglru._rglru_decode(p, t(tok), st, cfg)
        close(f"decode out {step}", out, jout)
        close(f"decode h {step}", st.h, jst.h)
        assert st.conv.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            st.conv.float().numpy(), np.asarray(jst.conv.astype(jnp.float32)),
            err_msg=f"decode conv {step}")


def test_rglru_packed_prefill_matches_reference_and_each_row(model):
    """Ragged lengths in one padded call: outputs and boundary states
    against the reference's packed prefill, and each row's boundary state
    against that row prefilled alone at its own length."""
    jcfg, jp, cfg, p = layer(model)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((4, 40, cfg.d_model), np.float32)
    lens = np.array([40, 17, 2, 1], np.int32)
    jout, jst = jrglru._rglru_prefill(jp, jnp.asarray(x), jcfg,
                                      lengths=jnp.asarray(lens))
    out, st = rglru._rglru_prefill(p, t(x), cfg, lengths=t(lens))
    for i, n in enumerate(lens):
        close(f"packed out row {i}", out[i, :n], np.asarray(jout)[i, :n])
    close("packed h", st.h, jst.h)
    np.testing.assert_array_equal(st.conv.float().numpy(),
                                  np.asarray(jst.conv.astype(jnp.float32)))
    for i, n in enumerate(lens):
        _, alone = rglru._rglru_prefill(p, t(x[i:i + 1, :n]), cfg)
        close(f"row {i} boundary h", st.h[i:i + 1], alone.h)
        assert torch.equal(st.conv[i:i + 1], alone.conv), i


# (D, Dv) = (256, 256): RecurrentGemma-9B's flow heads at small N
@pytest.mark.parametrize("g", [1, 16])
def test_flow_fused_plain_and_twin_at_d256(g):
    """K1's plain version (the wrapper's CPU path) and its chunk-parallel
    twin at the kernel's own super-chunk (8 positions at D = 256, G = 16)
    against the reference kernel in interpret mode, ragged lengths."""
    rng = np.random.default_rng(256 + g)
    bh, n, chunk, d = 2, 24, 8, 256
    q = rng.standard_normal((bh, g, n, d)).astype(np.float32)
    k = rng.standard_normal((bh, n, d)).astype(np.float32)
    v = rng.standard_normal((bh, n, d)).astype(np.float32)
    lens = np.array([n, 13], np.int32)
    j_out, j_sums = j_fused_call(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens),
                                 chunk=chunk, interpret=True)
    before = dict(LAUNCHES)
    for tag, (out, sums) in (
            ("plain", flow_fused_call(t(q), t(k), t(v), t(lens),
                                      chunk=chunk)),
            ("twin", flow_fused_parallel(t(q), t(k), t(v), t(lens),
                                         chunk=chunk, tile=8))):
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"{tag} out")
        for name, a, b in zip(("q_sum", "k_sum", "ko_sum", "qi_sum", "z",
                               "s"), sums, j_sums):
            np.testing.assert_allclose(a.numpy(), np.reshape(b, a.shape),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{tag} {name}")
    assert LAUNCHES == before, "the CPU path must not count a launch"


@pytest.mark.parametrize("g", [1, 16])
def test_flow_decode_plain_and_split_at_d256(g):
    """K3's plain version (in place) and its kernel order
    (``flow_decode_split``) against the reference kernel in interpret
    mode, 3 steps from a non-zero state at D = Dv = 256."""
    rng = np.random.default_rng(512 + g)
    b, hkv, steps, d = 2, 1, 3, 256
    bh = b * hkv
    t0 = np.array([20, 5], np.int32)
    names = ("k_sum", "q_sum", "ko_sum", "qi_sum", "z", "s")
    st = {n: (rng.random((bh, d)) * 20).astype(np.float32)
          for n in names[:4]}
    st["z"] = (rng.random((bh,)) * 20 + 1).astype(np.float32)
    st["s"] = rng.standard_normal((bh, d, d)).astype(np.float32)
    j = {n: jnp.asarray(st[n]) for n in names}
    j["z"] = j["z"].reshape(bh, 1)
    pool = [t(st[n]) for n in names]
    split = [t(st[n]) for n in names]
    counts = t(t0)
    for step in range(steps):
        q = rng.standard_normal((bh, g, d)).astype(np.float32)
        k = rng.standard_normal((bh, d)).astype(np.float32)
        v = rng.standard_normal((bh, d)).astype(np.float32)
        tf = np.repeat(t0 + step + 1, hkv).astype(np.float32)[:, None]
        j_out, *new = j_decode_call(
            jnp.asarray(tf), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            *(j[n] for n in names), eps=1e-6, phi="sigmoid",
            use_allocation=True, interpret=True)
        j.update(zip(names, new))
        counts = counts + 1
        out = flow_decode_call(counts, t(q), t(k), t(v), *pool, hkv=hkv)
        s_out, split = flow_decode_split(counts, t(q), t(k), t(v), *split,
                                         hkv=hkv)
        for tag, o, state in (("plain", out, pool), ("split", s_out, split)):
            np.testing.assert_allclose(o.numpy(), np.asarray(j_out),
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{tag} out {step}")
            for name, x in zip(names, state):
                np.testing.assert_allclose(
                    x.numpy(), np.reshape(j[name], x.shape), rtol=2e-4,
                    atol=2e-5, err_msg=f"{tag} {name} {step}")


def verdicts(mx, cfg):
    return (mx.packable(cfg), mx.paged_capable(cfg), mx.verify_capable(cfg),
            mx.differentiable(cfg, "cpu"),
            *(mx.quant_capable(cfg, platform, dtype)
              for platform in ("cpu", "cuda") for dtype in ("int8", "fp8")))


@pytest.mark.parametrize("kind", ["flow", "softmax"])
def test_mixer_verdicts_match_the_references_strings(kind):
    """Every capability of the rglru and local mixers, and the SSD mixer's
    quant_capable, string for string the reference's."""
    jcfg = with_kind(j_smoke_config(ARCH), kind)
    cfg = with_kind(get_smoke_config(ARCH), kind)
    for name in ("rglru", "local"):
        assert verdicts(mixer_lib.get_mixer(name), cfg) == \
            verdicts(jmixer.get_mixer(name), jcfg), name
    mcfg, jmcfg = get_smoke_config("mamba2_1p3b"), j_smoke_config(
        "mamba2_1p3b")
    for platform in ("cpu", "cuda"):
        for dtype in ("int8", "fp8"):
            assert mixer_lib.get_mixer("ssd").quant_capable(
                mcfg, platform, dtype) == jmixer.get_mixer(
                "ssd").quant_capable(jmcfg, platform, dtype)
    want = {cap: (ok, kname, why) for cap, (ok, kname, why) in
            jmixer.stack_capabilities(jcfg).items()}
    got = mixer_lib.stack_capabilities(cfg, "cpu")
    for cap in ("packable", "paged_capable", "verify_capable",
                "quant_capable"):
        assert got[cap] == want[cap], cap
    assert got["packable"][0] is (kind == "flow")


@pytest.mark.parametrize("kind", ["flow", "softmax"])
def test_lm_loss_and_grads_match_reference_at_5_layers(kind):
    """One period of the pattern and a tail of two (rglru, rglru, local,
    rglru, rglru); prompts of 64 positions: one local window."""
    jcfg, jparams, cfg, params = carried(5, kind)
    rng = np.random.default_rng(41)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, 1)}
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda q: jlm.loss_fn(q, jax.tree.map(jnp.asarray, batch), jcfg,
                              dtype=jnp.float32), has_aux=True)(jparams)
    logits, _ = lm.forward(params, t(toks), cfg, dtype=F32)
    j_logits, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg,
                              dtype=jnp.float32)
    close("logits", logits, j_logits)
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), params)
    loss, _ = lm.loss_fn(leaves, {k: t(v) for k, v in batch.items()}, cfg,
                         dtype=F32)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_grads),
                                         cfg))
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-4 * scale, f"leaf {i}: {err:.3e} of max {scale:.3e}"


def serve_both(model, prompts, budgets, slots, max_len=96, **kw):
    jcfg, jparams, cfg, params = model
    jengine = JEngine(jparams, jcfg, slots=slots, max_len=max_len,
                      dtype=jnp.float32, **kw)
    engine = Engine(params, cfg, slots=slots, max_len=max_len, dtype=F32,
                    device="cpu", **kw)
    for e, req in ((jengine, JRequest), (engine, Request)):
        for uid, (p, b) in enumerate(zip(prompts, budgets)):
            e.submit(req(uid=uid, prompt=p, max_new_tokens=int(b)))
    return ({r.uid: r.generated for r in jengine.run()},
            {r.uid: r.generated for r in engine.run()}, engine)


@pytest.fixture(scope="module")
def softmax_model():
    return carried(kind="softmax")


@pytest.mark.parametrize("mode", ["flow", "softmax"])
def test_engine_matches_reference_engine(mode, model, softmax_model):
    """Mixed prompt lengths: flow mode packs them into one admission;
    softmax mode (local rings) admits one request a round."""
    m = model if mode == "flow" else softmax_model
    cfg = m[2]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 18, 11)]
    want, got, engine = serve_both(m, prompts, (5, 5, 5), slots=3)
    assert got == want
    assert engine.worker.packable is (mode == "flow")
    assert engine.worker.admission_rounds == (1 if mode == "flow" else 3)


@pytest.mark.parametrize("mode", ["flow", "softmax"])
def test_engine_slot_churn_and_readmission_match_reference(
        mode, model, softmax_model):
    m = model if mode == "flow" else softmax_model
    cfg = m[2]
    rng = np.random.default_rng(13)
    lens, buds = rng.integers(4, 24, 7), rng.integers(1, 6, 7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    want, got, engine = serve_both(m, prompts, buds, slots=2)
    assert got == want and len(got) == 7
    assert engine.worker.admission_rounds >= (3 if mode == "flow" else 7)
    assert all(slot is None for slot in engine.active)


def test_softmax_engine_past_the_window_matches_reference(softmax_model):
    """Prompts of one and two windows (64, 128: the band path), decode on
    past the window so the ring wraps."""
    cfg = softmax_model[2]
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (64, 128, 30)]
    want, got, _ = serve_both(softmax_model, prompts, (40, 12, 50), slots=2,
                              max_len=192)
    assert got == want


def int8_pool_close(name, pool, jpool):
    """A port pool against the reference's (see the module docstring)."""
    for i, (a, b) in enumerate(zip(tree_leaves(pool.payload),
                                   jax.tree.leaves(jpool.payload))):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, i)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} payload {i}")
    for i, (a, b) in enumerate(zip(tree_leaves(pool.scale),
                                   jax.tree.leaves(jpool.scale))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   err_msg=f"{name} scale {i}")


@pytest.mark.parametrize("kind", ["rglru", "ssd"])
def test_int8_pools_match_reference_quantized_pool(kind, model):
    """A prefill's state installed into an int8 pool by both packages, then
    three decode steps on each side's own pool: outputs and pools."""
    if kind == "rglru":
        jcfg, jp, cfg, p = layer(model)
        jprefill, prefill = jrglru._rglru_prefill, rglru._rglru_prefill
    else:
        jcfg, cfg = j_smoke_config("mamba2_1p3b"), get_smoke_config(
            "mamba2_1p3b")
        jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
        jp = jax.tree.map(lambda x: x[0], jparams["scan"][0]["ssd"])
        p = params["blocks"][0]["ssd"]
        jprefill, prefill = jssd._ssd_prefill, ssd._ssd_prefill
    jmx, mx = jmixer.get_mixer(kind), mixer_lib.get_mixer(kind)
    rng = np.random.default_rng(61)
    x = rng.standard_normal((2, 20, cfg.d_model), np.float32)
    _, jst = jprefill(jp, jnp.asarray(x), jcfg)
    _, st = prefill(p, t(x), cfg)
    jpool = jquant.quantize_state(jst, jquant.spec_of("int8"),
                                  granularity="head")
    pool = quant.quantize_state(st, quant.spec_of("int8"), granularity="head")
    int8_pool_close("installed", pool, jpool)
    for step in range(3):
        tok = rng.standard_normal((2, 1, cfg.d_model), np.float32)
        jout, jpool = jmx.decode_step(jp, jnp.asarray(tok), jpool, jcfg)
        out, pool = mx.decode_step(p, t(tok), pool, cfg)
        assert isinstance(pool, quant.QuantizedPool)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                                   atol=1e-4, err_msg=f"out {step}")
        int8_pool_close(f"step {step}", pool, jpool)


def test_int8_hybrid_engine_matches_fp32(model):
    """The int8 hybrid Engine (rglru int8 pools, the flow slots' int8
    FlowState) gives the fp32-pool Engine's greedy tokens on this
    traffic, as the reference's own test holds its int8 hybrid stack
    (``tests/test_quant_pools.py``), and the reference's int8 Engine's."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 6 + 3 * i).astype(np.int32)
               for i in range(4)]

    def run(state_dtype):
        engine = Engine(params, cfg, slots=2, max_len=96, dtype=F32,
                        state_dtype=state_dtype, device="cpu")
        for i, pr in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=pr, max_new_tokens=6))
        return {r.uid: r.generated for r in engine.run()}, engine

    got, engine = run("int8")
    assert isinstance(engine.worker.caches[0], quant.QuantizedPool)
    assert got == run(None)[0]
    jengine = JEngine(jparams, jcfg, slots=2, max_len=96, dtype=jnp.float32,
                      state_dtype="int8")
    for i, pr in enumerate(prompts):
        jengine.submit(JRequest(uid=i, prompt=pr, max_new_tokens=6))
    assert got == {r.uid: r.generated for r in jengine.run()}


@pytest.mark.parametrize("mode", ["flow", "softmax"])
def test_launcher_serves_both_modes(mode):
    """``launch/serve.py --arch recurrentgemma-9b --smoke`` on the CPU:
    every request finishes, flow mode in one packed admission per round,
    softmax mode one prefill a request; its pools' bytes are the
    reference's for the same slots and length."""
    from repro_torch.launch import serve

    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
            "--requests", "5", "--slots", "2", "--max-new", "6",
            "--prompt-len", "64"]
    if mode == "softmax":
        argv += ["--attn", "softmax"]
    out = serve.main(argv)
    assert all(r.done and len(r.generated) == 6 for r in out["requests"])
    assert out["plan"].packed is (mode == "flow")
    jcfg = j_smoke_config(ARCH)
    if mode == "softmax":
        jcfg = with_kind(jcfg, "softmax")
    jcaches = jlm.init_caches(jcfg, 2, 64 + 6 + 8, dtype=jnp.bfloat16)
    assert out["pool_bytes"] == jquant.pool_bytes(jcaches)

