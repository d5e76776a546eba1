"""Port vs reference: the mamba2_1p3b slice (Mamba-2 SSD stacks).

The same numpy inputs, and the same parameters (the reference's
``repro.models.lm.init``, carried across with ``interop``), go through the
JAX package and the port on the CPU, fp32, where every port wrapper runs
its kernel's plain version.  Tolerances, each with its reason:

* the SSD chunk scan (y, carry-ins) and its backward against the
  reference's Pallas kernels in interpret mode: |port - ref| <= 1e-5 +
  1e-5 |ref| + 1e-5 max |ref| -- the same fp32 terms summed in another
  order (the reference's in-chunk cumsum is a tril matmul, the port's a
  running sum), and a chunk sums C S products as large as its outputs;
* the boundary gather: exact (a gather);
* the SSD block, packed prefill and decode: the same bound, at 1e-5;
* the LM: loss rtol 1e-6 and every gradient leaf within 1e-5 of that
  leaf's max |grad|, as ``tests/test_torch_train.py``;
* the fp32 Engine: token for token (tolerance zero);
* three bf16 training steps: losses within 2e-2, as
  ``tests/test_torch_train.py`` (bf16 rounds at other places in the two
  frameworks);
* interop: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.kernels.ssd_chunk.bwd import ssd_chunk_bwd_call as j_bwd_call  # noqa: E402
from repro.kernels.ssd_chunk.ops import ssd_chunk_dot as j_chunk_dot  # noqa: E402
from repro.kernels.ssd_chunk.ops import ssd_scan_pallas as j_scan  # noqa: E402
from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_call as j_chunk_call  # noqa: E402
from repro.launch.train import train as j_train  # noqa: E402
from repro.layers import ssd as jssd  # noqa: E402
from repro.layers.rglru import _boundary_conv_history as j_history  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels._lib import KERNELS  # noqa: E402
from repro_torch.kernels.gather import (boundary_gather,  # noqa: E402
                                        boundary_gather_many,
                                        boundary_gather_many_ref,
                                        boundary_gather_ref)
from repro_torch.kernels.ssd_chunk import (SSDChunkDot,  # noqa: E402
                                           ssd_chunk_bwd_call,
                                           ssd_chunk_bwd_parallel,
                                           ssd_chunk_bwd_ref, ssd_chunk_call,
                                           ssd_chunk_chunked,
                                           ssd_chunk_parallel, ssd_chunk_ref,
                                           ssd_scan)
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.layers import ssd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

F32 = torch.float32
ARCH = "mamba2_1p3b"


def close(name, got, want, tol=1e-5):
    """|got - want| <= tol + tol |want| + tol max |want| (see above)."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.isfinite(got).all(), name
    lim = tol + tol * want.abs() + tol * float(want.abs().max())
    err = (got - want).abs()
    assert (err <= lim).all(), f"{name}: max |diff| {float(err.max()):.3e}"


def operands(bh, n, p, s, seed, strong=False):
    """x, dta, b, c as numpy, as ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, n, p), np.float32) * 0.5
    dta = (np.full((bh, n, 1), -50.0, np.float32) if strong else
           -np.abs(rng.standard_normal((bh, n, 1), np.float32)) * 0.1)
    b = rng.standard_normal((bh, n, s), np.float32) * 0.5
    c = rng.standard_normal((bh, n, s), np.float32) * 0.5
    return x, dta, b, c


CHUNK_CASES = [(2, 64, 16, 8, 16, False), (4, 128, 32, 16, 32, False),
               (1, 96, 8, 4, 32, False), (2, 64, 8, 8, 8, True)]


@pytest.mark.parametrize("bh,n,p,s,chunk,strong", CHUNK_CASES)
def test_chunk_scan_plain_matches_reference_kernel(bh, n, p, s, chunk,
                                                   strong):
    ops = operands(bh, n, p, s, seed=p + s, strong=strong)
    jy, jh = j_chunk_call(*map(jnp.asarray, ops), chunk=chunk,
                          interpret=True, return_hins=True)
    y, hins = ssd_chunk_chunked(*map(torch.from_numpy, ops), chunk)
    close("y", y, jy)
    close("hins", hins, jh)
    y_call, h_call = ssd_chunk_call(*map(torch.from_numpy, ops), chunk=chunk,
                                    return_hins=True)
    assert torch.equal(y_call, y) and torch.equal(h_call, hins)
    # and the sequential oracle (the reference's ssd_chunk_ref)
    close("y vs recurrence", y, ssd_chunk_ref(*map(torch.from_numpy, ops)),
          tol=1e-4)


@pytest.mark.parametrize("strong", [False, True])
def test_chunk_bwd_plain_matches_reference_kernel(strong):
    bh, n, p, s, chunk = 3, 96, 16, 8, 32
    ops = operands(bh, n, p, s, seed=11, strong=strong)
    g = np.random.default_rng(12).standard_normal((bh, n, p), np.float32)
    _, jh = j_chunk_call(*map(jnp.asarray, ops), chunk=chunk, interpret=True,
                         return_hins=True)
    want = j_bwd_call(*map(jnp.asarray, ops), jh, jnp.asarray(g), chunk=chunk,
                      interpret=True)
    t = [torch.from_numpy(a) for a in ops]
    got = ssd_chunk_bwd_ref(*t, torch.from_numpy(np.array(jh)),
                            torch.from_numpy(g), chunk=chunk)
    for name, a, b in zip(("dx", "ddta", "db", "dc"), got, want):
        close(name, a, b)
    call = ssd_chunk_bwd_call(*t, torch.from_numpy(np.array(jh)),
                              torch.from_numpy(g), chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(call, got))


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_chunk_dot_matches_reference_vjp(strong):
    bh, n, p, s, chunk = 4, 64, 16, 8, 16
    ops = operands(bh, n, p, s, seed=21, strong=strong)
    g = np.random.default_rng(22).standard_normal((bh, n, p), np.float32)
    jy, pull = jax.vjp(lambda *a: j_chunk_dot(*a, chunk, True),
                       *map(jnp.asarray, ops))
    jgrads = pull(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    y = SSDChunkDot.apply(*leaves, chunk)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    close("y", y.detach(), jy)
    for name, a, b in zip(("dx", "ddta", "db", "dc"), grads, jgrads):
        close(name, a, b)


def shared_operands(bsz, heads, n, p, s, seed, strong=False):
    """x, dta as ``operands`` for B*H rows; b and c (B, N, S), shared by
    each batch row's heads."""
    x, dta, _, _ = operands(bsz * heads, n, p, s, seed, strong)
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal((bsz, n, s), np.float32) * 0.5
    c = rng.standard_normal((bsz, n, s), np.float32) * 0.5
    return x, dta, b, c


def per_head(t, heads):
    """The reference's per-row (B*H, N, S) copy of shared (B, N, S) rows."""
    return np.repeat(t, heads, axis=0)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("chunk", [8, 32, 96, 128])
def test_parallel_decomposition_matches_reference_kernels(chunk, strong):
    """The kernels' decomposition in PyTorch (local states, the state
    pass, c b^T once per batch row and chunk, W summed over the heads)
    against the reference's Pallas kernels in interpret mode, which see
    b and c repeated per head; db and dc against the reference's summed
    over the heads."""
    bsz, heads, p, s = 2, 3, 8, 16
    n = 2 * chunk
    x, dta, b, c = shared_operands(bsz, heads, n, p, s, seed=chunk + strong,
                                   strong=strong)
    g = np.random.default_rng(chunk + 7).standard_normal(x.shape, np.float32)
    jops = (x, dta, per_head(b, heads), per_head(c, heads))
    jy, jh = j_chunk_call(*map(jnp.asarray, jops), chunk=chunk,
                          interpret=True, return_hins=True)
    want = j_bwd_call(*map(jnp.asarray, jops), jh, jnp.asarray(g),
                      chunk=chunk, interpret=True)
    t = [torch.from_numpy(a) for a in (x, dta, b, c)]
    y, hins = ssd_chunk_parallel(*t, chunk)
    close("y", y, jy)
    close("hins", hins, jh)
    got = ssd_chunk_bwd_parallel(*t, hins, torch.from_numpy(g), chunk=chunk)
    close("dx", got[0], want[0])
    close("ddta", got[1], want[1])
    for name, a, w in (("db", got[2], want[2]), ("dc", got[3], want[3])):
        close(name, a, np.asarray(w).reshape(bsz, heads, n, s).sum(1))


@pytest.mark.parametrize("strong", [False, True])
def test_head_summed_grads_match_reference_vjp(strong):
    """``ssd_chunk_bwd_ref`` (through ``ssd_chunk_bwd_call``) and
    ``SSDChunkDot`` take (B, N, S) b and c and return db and dc summed
    over the heads: against ``jax.vjp(ssd_chunk_dot)`` on the per-head
    copies, summed over the heads."""
    bsz, heads, n, p, s, chunk = 2, 4, 64, 16, 8, 16
    x, dta, b, c = shared_operands(bsz, heads, n, p, s, seed=31,
                                   strong=strong)
    g = np.random.default_rng(32).standard_normal(x.shape, np.float32)
    jops = (x, dta, per_head(b, heads), per_head(c, heads))
    jy, pull = jax.vjp(lambda *a: j_chunk_dot(*a, chunk, True),
                       *map(jnp.asarray, jops))
    jgrads = [np.asarray(a) for a in pull(jnp.asarray(g))]
    jgrads[2:] = [a.reshape(bsz, heads, n, s).sum(1) for a in jgrads[2:]]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, dta, b,
                                                                 c)]
    y = SSDChunkDot.apply(*leaves, chunk)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    close("y", y.detach(), jy)
    _, hins = ssd_chunk_chunked(*(t.detach() for t in leaves), chunk)
    direct = ssd_chunk_bwd_call(*(t.detach() for t in leaves), hins,
                                torch.from_numpy(g), chunk=chunk)
    for name, a, d, w in zip(("dx", "ddta", "db", "dc"), grads, direct,
                             jgrads):
        assert a.shape == d.shape == w.shape, name
        close(name, a, w)
        close(name + " (ssd_chunk_bwd_ref)", d, w)


def test_wrappers_refuse_bc_with_a_head_stride():
    """b and c are the heads' shared rows: a (B, H, N, S) view must have
    head stride 0; any other is refused, not read as head 0."""
    bsz, heads, n, p, s, chunk = 2, 3, 32, 16, 8, 16
    x, dta, b, c = (torch.from_numpy(a) for a in shared_operands(
        bsz, heads, n, p, s, seed=41))
    view = b[:, None].expand(bsz, heads, n, s)
    own = view.contiguous()  # (B, H, N, S) with head stride N * S
    y, hins = ssd_chunk_call(x, dta, view, c, chunk=chunk, return_hins=True)
    assert torch.equal(y, ssd_chunk_call(x, dta, b, c, chunk=chunk))
    g = torch.ones_like(x)
    db = ssd_chunk_bwd_call(x, dta, view, c, hins, g, chunk=chunk)[2]
    assert db.shape == (bsz, n, s)
    for bb, cc in ((own, c), (b, own.clone())):
        with pytest.raises(ValueError, match="head stride 0"):
            ssd_chunk_call(x, dta, bb, cc, chunk=chunk)
        with pytest.raises(ValueError, match="head stride 0"):
            ssd_chunk_bwd_call(x, dta, bb, cc, hins, g, chunk=chunk)
    with pytest.raises(ValueError, match=r"\(B, N, S\)"):
        SSDChunkDot.apply(x, dta, view, c, chunk)


@pytest.mark.parametrize("n,chunk", [(64, 16), (96, 64), (40, 32)])
@pytest.mark.parametrize("interpret", [None, True])
def test_ssd_scan_matches_reference(n, chunk, interpret):
    """The head-batched scan with its chunk rule (96 at chunk 64 halves to
    32, 40 at chunk 32 to 8), forward and gradients of every input, for
    the CPU glue (``interpret=None``: SSDChunkDot on the plain versions)
    and the plain chunked scan under autograd (``interpret=True``)."""
    b, h, p, s = 2, 3, 16, 8
    rng = np.random.default_rng(n + chunk)
    xh = rng.standard_normal((b, n, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, n, h), np.float32) - 2))
    bm = rng.standard_normal((b, n, s), np.float32) * 0.5
    cm = rng.standard_normal((b, n, s), np.float32) * 0.5
    a = -np.exp(rng.uniform(0, 2, h)).astype(np.float32)
    g = rng.standard_normal((b, n, h, p), np.float32)
    ins = (xh, dt, bm, cm, a)
    jy, pull = jax.vjp(lambda *t: j_scan(*t, chunk=chunk, interpret=True),
                       *map(jnp.asarray, ins))
    jgrads = pull(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    reset_launches()
    y = ssd_scan(*leaves, chunk=chunk, interpret=interpret)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    close("y", y.detach(), jy)
    for name, a_, b_ in zip(("dxh", "ddt", "dbmat", "dcmat", "da"), grads,
                            jgrads):
        close(name, a_, b_)
    with torch.no_grad():  # the no-grad route: K10a without carry-ins
        assert torch.equal(ssd_scan(*leaves, chunk=chunk), y.detach())
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("lens", [[19, 32, 2], [1, 3, 0], [32, 32, 32]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_boundary_gather_plain_matches_reference(lens, dtype):
    b, n, w, k = 3, 32, 24, 4
    xb = np.random.default_rng(8).standard_normal((b, n, w), np.float32)
    jx = jnp.asarray(xb).astype(dtype)
    want = np.asarray(j_history(jx, jnp.asarray(lens), k).astype(jnp.float32))
    tx = torch.from_numpy(xb).to(getattr(torch, dtype))
    lengths = torch.tensor(lens, dtype=torch.int32)
    reset_launches()
    for got in (boundary_gather(tx, lengths, k),
                boundary_gather(tx, lengths, k, interpret=True),
                boundary_gather_ref(tx, lengths, k)):
        assert got.dtype == tx.dtype and got.shape == (b, k - 1, w)
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("streams", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_boundary_gather_many_plain_matches_reference(streams, dtype):
    """Each stream exactly as the reference's XLA ``_boundary_conv_history``
    gathers it, with lengths 0, 1, 2, 3 and N among the rows."""
    n, k = 32, 4
    lens = [0, 1, 2, 3, n, 17]
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((len(lens), n, w), np.float32)
          for w in (24, 8, 8, 5)[:streams]]
    tx = tuple(torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs)
    lengths = torch.tensor(lens, dtype=torch.int32)
    reset_launches()
    for got in (boundary_gather_many(tx, lengths, k),
                boundary_gather_many(tx, lengths, k, interpret=True),
                boundary_gather_many_ref(tx, lengths, k)):
        assert isinstance(got, tuple) and len(got) == streams
        for x, jx_np, g in zip(tx, xs, got):
            jx = jnp.asarray(jx_np).astype(dtype)
            want = j_history(jx, jnp.asarray(lens), k).astype(jnp.float32)
            assert g.dtype == x.dtype and g.shape == (len(lens), k - 1,
                                                      x.shape[2])
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(want))
    assert LAUNCHES == dict.fromkeys(KERNELS, 0)


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


def test_config_matches_reference():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    for j, c in ((j_get_config(ARCH), get_config(ARCH)),
                 (j_smoke_config(ARCH), get_smoke_config(ARCH))):
        assert c.param_count() == j.param_count()
        assert (c.pattern, c.d_model, c.n_layers, c.vocab_size,
                c.tie_embeddings, c.d_ff) == (j.pattern, j.d_model,
                                              j.n_layers, j.vocab_size,
                                              j.tie_embeddings, j.d_ff)
        assert vars(c.ssd) == vars(j.ssd)


def test_interop_round_trips_the_ssd_tree(model):
    jcfg, jparams, cfg, params = model
    tree = jax.tree.map(np.asarray, jparams)
    assert "scan" in tree and "ssd" in tree["scan"][0]
    assert set(params["blocks"][0]) == {"norm1", "ssd"}
    back = params_to_numpy(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the reference's tree
    own = params_to_numpy(lm.init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"), cfg)
    assert jax.tree.structure(own) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def layer_params(model):
    _, jparams, _, params = model
    jp = jax.tree.map(lambda x: x[0], jparams["scan"][0]["ssd"])
    return jp, params["blocks"][0]["ssd"]


def test_ssd_block_prefill_and_decode_match_reference(model):
    jcfg, _, cfg, _ = model
    jp, p = layer_params(model)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 40, cfg.d_model), np.float32)
    close("ssd_block", ssd.ssd_block(p, torch.from_numpy(x), cfg),
          jssd.ssd_block(jp, jnp.asarray(x), jcfg))
    lens = np.array([40, 17, 2], np.int32)
    jout, jst = jssd._ssd_prefill(jp, jnp.asarray(x), jcfg,
                                  lengths=jnp.asarray(lens))
    out, st = ssd._ssd_prefill(p, torch.from_numpy(x), cfg,
                               lengths=torch.from_numpy(lens))
    close("packed prefill out", out, jout)
    close("packed prefill h", st.h, jst.h)
    for i, (a, b) in enumerate(zip(st.conv, jst.conv)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)),
                                      err_msg=f"conv history {i}")
    tok = rng.standard_normal((3, 1, cfg.d_model), np.float32)
    jout, jst = jssd._ssd_decode(jp, jnp.asarray(tok), jst, jcfg)
    out, st = ssd._ssd_decode(p, torch.from_numpy(tok), st, cfg)
    close("decode out", out, jout)
    close("decode h", st.h, jst.h)


def test_lm_loss_and_grads_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(41)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, 1)}
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda q: jlm.loss_fn(q, jax.tree.map(jnp.asarray, batch), jcfg,
                              dtype=jnp.float32), has_aux=True)(jparams)
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), params)
    loss, _ = lm.loss_fn(leaves, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cfg, dtype=F32)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_grads),
                                         cfg))
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"leaf {i}: {err:.3e} of max {scale:.3e}"


def engines(model, slots, max_len):
    jcfg, jparams, cfg, params = model
    return (JEngine(jparams, jcfg, slots=slots, max_len=max_len,
                    dtype=jnp.float32),
            Engine(params, cfg, slots=slots, max_len=max_len, dtype=F32,
                   device="cpu"))


def serve_both(model, prompts, budgets, slots, max_len=96):
    jengine, engine = engines(model, slots, max_len)
    for e, req in ((jengine, JRequest), (engine, Request)):
        for uid, (p, b) in enumerate(zip(prompts, budgets)):
            e.submit(req(uid=uid, prompt=p, max_new_tokens=int(b)))
    return ({r.uid: r.generated for r in jengine.run()},
            {r.uid: r.generated for r in engine.run()}, engine)


def test_engine_matches_reference_engine(model):
    cfg = model[2]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 18, 11)]
    want, got, engine = serve_both(model, prompts, (5, 5, 5), slots=3)
    assert got == want
    assert engine.worker.admission_rounds == 1


def test_engine_slot_churn_and_readmission_match_reference(model):
    cfg = model[2]
    rng = np.random.default_rng(13)
    lens, buds = rng.integers(4, 24, 7), rng.integers(1, 6, 7)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    want, got, engine = serve_both(model, prompts, buds, slots=2)
    assert got == want and len(got) == 7
    assert engine.worker.admission_rounds >= 3
    assert all(slot is None for slot in engine.active)


def test_launcher_matches_reference_bf16(model):
    jcfg, _, cfg, _ = model
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ref = j_train(jcfg, steps=3, batch=2, seq=32, seed=1, mesh=mesh)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jlm.init(jax.random.PRNGKey(1), jcfg)), cfg)
    out = train(cfg, steps=3, batch=2, seq=32, seed=1, device="cpu",
                params=params)
    assert len(out["history"]) == 3 and out["state"].step == 3
    np.testing.assert_allclose(out["history"], ref["history"], atol=2e-2)
