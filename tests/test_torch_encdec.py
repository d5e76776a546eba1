"""Port vs reference: the Whisper encoder-decoder on the same weights.

The reference's smoke parameters (``repro.models.encdec.init`` at
``whisper_small``'s smoke config: d 128, 4 heads of 32, 2 encoder and 2
decoder layers) are carried across with ``repro_torch.interop``; the same
frames and tokens, drawn with numpy from a fixed seed, go through both
``encdec`` modules in fp32 on the CPU (the port's plain non-causal ``nc``
and strict-causal backends, the reference's XLA ones).

Tolerances: the memory and the logits at rtol 1e-4 and atol 1e-4 (the
same fp32 products summed in another order by XLA and PyTorch's CPU
kernels); the loss at rtol 1e-5; each gradient leaf within 1e-4 of that
leaf's max |grad| (the same sums carried back through both layer stacks);
the greedy decode loop against the reference's ``decode_step`` loop
teacher-forced on the same tokens (and at its first position against
``decode_train``) at rtol 1e-4 and atol 1e-4 x max |logit|, its tokens
equal to the argmax of the reference's logits.
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
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.attention import ShapeInfo  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32
B, N_ENC, N_DEC = 2, 48, 32


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke_config("whisper_small")
    jparams = jencdec.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("whisper_small")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def inputs(cfg, seed=1, n_enc=N_ENC, n_dec=N_DEC):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, n_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, n_dec + 1)).astype(np.int32)
    return frames, toks[:, :-1], toks[:, 1:]


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               err_msg=what, **(tol or TOL))


def test_smoke_and_full_configs_match_reference():
    for ours, ref in ((get_config("whisper-small"),
                       j_get_config("whisper-small")),
                      (get_smoke_config("whisper_small"),
                       j_smoke_config("whisper_small"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()


def test_encode_matches_reference(model):
    jcfg, jparams, cfg, params = model
    frames, _, _ = inputs(cfg)
    want = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                          dtype=jnp.float32)
    got = encdec.encode(params, torch.from_numpy(frames), cfg, dtype=F32)
    assert got.shape == (B, N_ENC, cfg.d_model) and got.dtype == F32
    close(got, want, "memory")


def test_decode_train_cross_attention_n_ne_m_matches_reference(model):
    """N_dec = 32 decoder queries against M = 48 memory rows."""
    jcfg, jparams, cfg, params = model
    frames, toks, _ = inputs(cfg, seed=2)
    jmem = jencdec.encode(jparams, jnp.asarray(frames), jcfg,
                          dtype=jnp.float32)
    want = jencdec.decode_train(jparams, jnp.asarray(toks), jmem, jcfg,
                                dtype=jnp.float32)
    # the same memory on both sides: this test isolates the decoder
    mem = torch.from_numpy(np.array(jmem))
    got = encdec.decode_train(params, torch.from_numpy(toks), mem, cfg,
                              dtype=F32)
    assert got.shape == (B, N_DEC, cfg.vocab_size)
    close(got, want, "decode_train logits")
    ex = encdec.executors(cfg)
    q = torch.zeros((B, cfg.n_heads, N_DEC, cfg.dim_head))
    kv = torch.zeros((B, cfg.kv_heads, N_ENC, cfg.dim_head))
    shapes = ShapeInfo.from_qkv(q, kv, kv)
    assert (shapes.n, shapes.m) == (N_DEC, N_ENC)
    assert ex.nc.backend("forward", shapes, "cpu").name == "nc"


def test_loss_and_gradients_match_reference(model):
    jcfg, jparams, cfg, params = model
    frames, toks, targets = inputs(cfg, seed=3)
    mask = (np.random.default_rng(4).random((B, N_DEC)) > 0.2).astype(
        np.float32)
    jbatch = {"frames": jnp.asarray(frames), "inputs": jnp.asarray(toks),
              "targets": jnp.asarray(targets), "mask": jnp.asarray(mask)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jencdec.loss_fn(p, jbatch, jcfg, dtype=jnp.float32),
        has_aux=True)(jparams)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    leaves = jax.tree.map(lambda x: torch.from_numpy(
        np.array(x, copy=True)).requires_grad_(True), jax.tree.map(
            np.asarray, jparams))
    loss_fn = steps.model_loss_fn(cfg, dtype=F32)
    loss, metrics = loss_fn(leaves, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(metrics["tokens"]) == mask.sum()
    flat = jax.tree.leaves(leaves)
    grads = torch.autograd.grad(loss, flat)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, jg in zip(names, grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        scale = float(np.abs(jg).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_greedy_decode_matches_teacher_forced_logits(model):
    """Decode from ``init_dec_caches`` (a 3-token prompt, then 10 greedy
    tokens).  The reference's ``decode_step`` loop, teacher-forced on the
    same tokens from its own ``init_dec_caches``, gives the same logits
    at every step, and each chosen token is the argmax of its logits.

    Decode's cross-attention pairs the new token alone with the memory (one
    sink, as the reference does), while ``decode_train`` pairs all N_dec
    sinks at once, so Eq. 4's sums over the sinks differ past the first
    position: the two agree at the first position only (one sink in
    both), which is held here too."""
    jcfg, jparams, cfg, params = model
    frames, toks, _ = inputs(cfg, seed=5)
    mem = encdec.encode(params, torch.from_numpy(frames), cfg, dtype=F32)
    start = torch.from_numpy(toks[:, :3]).long()
    chosen, logits = encdec.greedy_decode(params, mem, start, cfg, 10,
                                          dtype=F32)
    assert chosen.shape == (B, 10) and logits.shape == (B, 12,
                                                         cfg.vocab_size)
    fed = torch.cat([start, chosen[:, :-1]], dim=1)
    scale = float(logits.abs().max())
    caches = jencdec.init_dec_caches(jcfg, B, 16)
    jmem = jnp.asarray(mem.numpy())
    want = []
    for t in range(fed.shape[1]):
        jl, caches = jencdec.decode_step(
            jparams, jnp.asarray(fed[:, t:t + 1].numpy(), jnp.int32), jmem,
            caches, jcfg, jnp.asarray(t), dtype=jnp.float32)
        want.append(np.asarray(jl))
    want = np.concatenate(want, axis=1)
    close(logits, want, "greedy decode vs the reference's decode_step",
          rtol=1e-4, atol=1e-4 * scale)
    assert np.array_equal(chosen.numpy(), want[:, 2:].argmax(-1))
    first = encdec.decode_train(params, fed[:, :1], mem, cfg, dtype=F32)
    close(logits[:, :1], first, "first position vs decode_train",
          rtol=1e-4, atol=1e-4 * scale)


def test_decode_steps_and_caches_on_the_cpu(model):
    _, _, cfg, params = model
    frames, toks, _ = inputs(cfg, seed=6)
    batch = {"frames": torch.from_numpy(frames)}
    prefill = steps.prefill_step(cfg, dtype=F32)
    mem = prefill(params, batch)
    assert mem.shape == (B, N_ENC, cfg.d_model) and mem.dtype == F32
    assert torch.equal(mem, encdec.encode(params, batch["frames"], cfg,
                                          dtype=F32))
    caches = encdec.init_dec_caches(cfg, B, 16, device="cpu")
    assert len(caches) == cfg.n_layers
    assert all(c["self"].s.dtype == F32 for c in caches)
    token = torch.from_numpy(toks[:, :1])
    step = steps.decode_step(cfg, dtype=F32)
    logits, caches = step(params, {"token": token, "memory": mem,
                                   "caches": caches, "pos": 0})
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert caches[0]["self"].t.tolist() == [1] * B
    want, _ = encdec.decode_step(params, token, mem,
                                 encdec.init_dec_caches(cfg, B, 16,
                                                        device="cpu"),
                                 cfg, 0, dtype=F32)
    assert torch.equal(logits, want)


@pytest.mark.parametrize("build", ["model_loss_fn", "prefill_step",
                                   "decode_step"])
def test_step_builders_refuse_other_families(build):
    """The step builders here are the encoder-decoder's; the LM's loss
    and serve steps are ``models/lm.py``'s own."""
    with pytest.raises(ValueError, match="encoder-decoder"):
        getattr(steps, build)(get_smoke_config("granite_8b"))


def test_check_flow_trainable_resolves_both_sides():
    """The encoder-decoder trains both attention directions: a pin that
    serves the causal side only passes an LM and fails the encdec."""
    from repro_torch.attention import ResolutionError
    from repro_torch.config import ShapeSpec

    cfg = get_smoke_config("whisper_small")
    shape = ShapeSpec("train", 64, 2, "train")
    be = steps.check_flow_trainable(cfg, shape, "cpu")
    assert be.name in ("fused_causal", "chunked", "cumsum")
    pin = lambda c: dataclasses.replace(c, attention=dataclasses.replace(  # noqa: E731
        c.attention, backend="fused_causal"))
    lm_cfg = dataclasses.replace(pin(cfg), family="lm")
    assert steps.check_flow_trainable(lm_cfg, shape, "cpu").name == \
        "fused_causal"
    with pytest.raises(ResolutionError, match="causal-only"):
        steps.check_flow_trainable(pin(cfg), shape, "cpu")


@pytest.mark.parametrize("which", ["smoke", "init"])
def test_interop_round_trip_is_bit_exact(model, which):
    jcfg, jparams, cfg, params = model
    tree = jax.tree.map(np.asarray, jparams)
    if which == "init":  # the port's own init has the reference's tree
        params = encdec.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert jax.tree.map(np.shape, params_to_numpy(params, cfg)) == \
            jax.tree.map(np.shape, tree)
        tree = params_to_numpy(params, cfg)
    back = params_to_numpy(params_from_numpy(tree, cfg), cfg)
    (a, a_def), (b, b_def) = jax.tree.flatten(back), jax.tree.flatten(tree)
    assert a_def == b_def
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert len(tree_leaves(params)) == len(a)
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy(tree, dataclasses.replace(cfg, n_layers=3))
