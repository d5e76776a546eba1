"""Port vs reference: the LRA encoder classifier slice.

The same parameters (``repro.models.classifier.init``, carried across with
``interop.params_from_numpy``) and the same numpy inputs go through the
JAX package and the port on the CPU, for the smoke ``flowformer_lra``,
with token inputs and with continuous ``in_dim=1`` inputs, with and
without a pooling mask.  Tolerances, each with its reason:

* logits and loss, fp32: rtol 1e-4, atol 1e-4 -- XLA and PyTorch sum the
  same fp32 products in another order;
* gradients, fp32: every leaf within 1e-4 of that leaf's max |grad|: the
  same fp32 sums in another order, but the query and key projections'
  gradients are 10-100x smaller than the other leaves' (the flow
  normalizers cancel most of q's and k's scale), so their rounding noise
  is larger beside their own maximum (up to 2.9e-5 of it, measured on the
  CPU, kernels' plain versions and plain path alike).  Checked once with
  the reference on its fused
  non-causal kernel (``pallas_nc``, interpret mode) against the port's
  kernel glue (``cuda_nc``: ``FlowNCFused``, whose kernels run their plain
  versions on the CPU), once with both on ``auto`` (the plain paths);
* three fp32 ``train_eval_classifier`` steps against the reference's loop
  rebuilt from ``benchmarks/common.py:39-83``: losses rtol 1e-5, the eval
  loss rtol 1e-5 and the eval accuracy exactly -- the gradient
  differences above, after three Adam updates;
* the converter and the data generators: bit for bit.
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
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro.training.optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro.training.schedule import warmup_cosine  # noqa: E402
from repro_torch.attention import backends  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.classify import train_eval_classifier  # noqa: E402
from repro_torch.models import classifier  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

F32 = torch.float32
SEQ, N_CLASSES = 64, 10


def with_backend(cfg, backend):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))


def data(kind: str, n: int, seed: int = 0) -> dict:
    """Token (ListOps, masked by != PAD) or continuous (8 x 8 pixel) inputs."""
    if kind == "tokens":
        xs, ys = synthetic.listops(seed, n, seq=SEQ, depth=2, max_args=3)
        return {"inputs": xs, "labels": ys,
                "mask": (xs != synthetic.PAD).astype(np.float32)}
    xs, ys = synthetic.pixel_images(seed, n, size=8)
    return {"inputs": xs.reshape(n, SEQ, 1), "labels": ys}


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, in_dim in (("tokens", 0), ("pixels", 1)):
        tree = jclf.init(jax.random.PRNGKey(in_dim), j_smoke_config(
            "flowformer_lra"), n_classes=N_CLASSES, in_dim=in_dim)
        out[kind] = jax.tree.map(np.asarray, tree)
    return out


def to_port(tree):
    return params_from_numpy(tree, get_smoke_config("flowformer_lra"))


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("get", ["full", "smoke"])
def test_flowformer_lra_configs_match_reference(get):
    ours = (get_config if get == "full" else get_smoke_config)("flowformer_lra")
    ref = (j_get_config if get == "full" else j_smoke_config)("flowformer_lra")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.scan_layers and ours.family == "lm"  # yet never stacked


@pytest.mark.parametrize("kind", ["tokens", "pixels"])
def test_classifier_params_round_trip_bit_exact(models, kind):
    tree = models[kind]
    params = to_port(tree)
    assert isinstance(params["blocks"], list) and "b" in params["head"]
    back = params_to_numpy(params, get_smoke_config("flowformer_lra"))
    (a_leaves, a_def), (b_leaves, b_def) = (jax.tree.flatten(back),
                                            jax.tree.flatten(tree))
    assert a_def == b_def
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_reference_shapes():
    cfg = get_smoke_config("flowformer_lra")
    for in_dim in (0, 3):
        params = classifier.init(cfg, torch.Generator().manual_seed(0),
                                 n_classes=N_CLASSES, in_dim=in_dim,
                                 device="cpu")
        ours = jax.tree.map(np.shape, params_to_numpy(params, cfg))
        ref = jax.tree.map(np.shape, jclf.init(
            jax.random.PRNGKey(0), j_smoke_config("flowformer_lra"),
            n_classes=N_CLASSES, in_dim=in_dim))
        assert ours == ref


@pytest.mark.parametrize("kind,masked", [("tokens", True), ("tokens", False),
                                         ("pixels", False)])
def test_classifier_forward_and_loss_match_reference(models, kind, masked):
    batch = data(kind, 6, seed=1)
    if not masked:
        batch.pop("mask", None)
    jcfg, cfg = j_smoke_config("flowformer_lra"), get_smoke_config(
        "flowformer_lra")
    want = jclf.forward(models[kind], jnp.asarray(batch["inputs"]), jcfg,
                        mask=None if not masked else jnp.asarray(batch["mask"]),
                        dtype=jnp.float32)
    params = to_port(models[kind])
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = classifier.forward(params, as_torch(batch)["inputs"], cfg,
                                 mask=as_torch(batch).get("mask"), dtype=F32)
        loss, metrics = classifier.loss_fn(params, as_torch(batch), cfg,
                                           dtype=F32)
    assert LAUNCHES == before, "the CPU path must not count a launch"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    j_loss, j_metrics = jclf.loss_fn(models[kind], as_jax(batch), jcfg,
                                     dtype=jnp.float32)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    assert float(metrics["acc"]) == float(j_metrics["acc"])


def test_dense_bias_rounds_once_like_reference():
    """bf16 dense with a bias: the fp32 bias joins the fp32 accumulator and
    the sum is rounded to bf16 once, as ``repro.layers.linear.dense`` does.
    The operands are multiples of 1/64 and 1/4096, so every fp32 sum is
    exact in any order and the two must agree bit for bit; rounding the
    product to bf16 before the bias would miss many of these entries."""
    from repro.layers.linear import dense as j_dense
    from repro_torch.layers.linear import dense

    rng = np.random.default_rng(3)
    x = rng.integers(-64, 65, (16, 8)).astype(np.float32) / 64
    w = rng.integers(-64, 65, (8, 12)).astype(np.float32) / 64
    b = rng.integers(-512, 513, (12,)).astype(np.float32) / 4096
    want = j_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                   jnp.asarray(x, jnp.bfloat16))
    got = dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["tokens", "pixels"])
def test_classifier_bf16_logits_match_reference(models, kind):
    """The main path's bf16 compute: logits within two bf16 steps at the
    largest logit's magnitude of the reference's bf16 forward."""
    batch = data(kind, 6, seed=1)
    jcfg, cfg = j_smoke_config("flowformer_lra"), get_smoke_config(
        "flowformer_lra")
    mask = batch.get("mask")
    want = np.asarray(jclf.forward(
        models[kind], jnp.asarray(batch["inputs"]), jcfg,
        mask=None if mask is None else jnp.asarray(mask),
        dtype=jnp.bfloat16), np.float32)
    with torch.no_grad():
        got = classifier.forward(to_port(models[kind]),
                                 as_torch(batch)["inputs"], cfg,
                                 mask=as_torch(batch).get("mask"),
                                 dtype=torch.bfloat16)
    assert got.dtype == F32 and got.shape == want.shape
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * step)


def leaf_pairs(port: dict, ref: dict):
    """(port leaf, reference leaf) in the port's tree order."""
    ref_leaves = params_from_numpy(
        jax.tree.map(np.asarray, ref), get_smoke_config("flowformer_lra"))
    return zip(tree_leaves(port), tree_leaves(ref_leaves))


@pytest.mark.parametrize("kind", ["tokens", "pixels"])
@pytest.mark.parametrize("ref_backend,port_backend", [
    ("pallas_nc", "cuda_nc"), ("auto", "auto")])
def test_classifier_grads_match_reference(models, monkeypatch, kind,
                                          ref_backend, port_backend):
    if port_backend == "cuda_nc":  # the kernel glue, on its plain versions
        monkeypatch.setattr(backends, "_check_nc_dims", lambda s, p: None)
    batch = data(kind, 4, seed=2)
    jcfg = with_backend(j_smoke_config("flowformer_lra"), ref_backend)
    cfg = with_backend(get_smoke_config("flowformer_lra"), port_backend)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jclf.loss_fn(p, as_jax(batch), jcfg, dtype=jnp.float32),
        has_aux=True)(jax.tree.map(jnp.asarray, models[kind]))
    params = to_port(models[kind])
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = classifier.loss_fn(params, as_torch(batch), cfg, dtype=F32)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for g, (_, want) in zip(grads, leaf_pairs(params, j_grads)):
        scale = float(want.abs().max())
        assert scale > 0 and float((g - want).abs().max()) <= 1e-4 * scale


def reference_train_eval(tree, cfg, train, evald, *, steps, batch, lr=1e-3,
                         seed=0):
    """``benchmarks/common.py:39-83``, with the loss in fp32."""
    def loss_fn(p, b):
        return jclf.loss_fn(p, b, cfg, dtype=jnp.float32)

    params = jax.tree.map(jnp.asarray, tree)
    opt = adamw_init(params)
    acfg = AdamWConfig(weight_decay=0.01, grad_clip=1.0)

    @jax.jit
    def step_fn(params, opt, batch_t, lr_t):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: loss_fn(p, batch_t), has_aux=True)(params)
        new_p, new_o, stats = adamw_update(grads, opt, params, lr_t, acfg)
        return new_p, new_o, metrics

    n = len(jax.tree.leaves(train)[0])
    rng = np.random.default_rng(seed)
    history = []
    for s in range(steps):
        idx = rng.integers(0, n, batch)
        bt = {k: jnp.asarray(v[idx]) for k, v in train.items()}
        lr_t = warmup_cosine(jnp.asarray(s), peak_lr=lr,
                             warmup=max(steps // 20, 5), total=steps)
        params, opt, metrics = step_fn(params, opt, bt, lr_t)
        history.append(float(metrics["loss"]))

    @jax.jit
    def eval_fn(params, batch_t):
        _, m = loss_fn(params, batch_t)
        return m

    ne = len(jax.tree.leaves(evald)[0])
    accs, losses = [], []
    eb = 64
    for i in range(0, ne, eb):
        bt = {k: jnp.asarray(v[i: i + eb]) for k, v in evald.items()}
        m = eval_fn(params, bt)
        accs.append(float(m.get("acc", 0.0)) * len(jax.tree.leaves(bt)[0]))
        losses.append(float(m["loss"]) * len(jax.tree.leaves(bt)[0]))
    return {"acc": sum(accs) / ne, "loss": sum(losses) / ne,
            "history": history}


def test_train_eval_classifier_matches_reference_loop(models):
    train, evald = data("tokens", 24, seed=3), data("tokens", 70, seed=4)
    want = reference_train_eval(models["tokens"],
                                j_smoke_config("flowformer_lra"), train,
                                evald, steps=3, batch=4)
    got = train_eval_classifier(
        get_smoke_config("flowformer_lra"), train, evald,
        n_classes=N_CLASSES, steps=3, batch=4, device="cpu", dtype=F32,
        params=to_port(models["tokens"]))
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    assert len(got["step_s"]) == 3 and got["steps_per_s"] > 0


def test_synthetic_generators_match_reference_bit_for_bit():
    for ours, ref in ((synthetic.listops(7, 12, seq=128),
                       j_synthetic.listops(7, 12, seq=128)),
                      (synthetic.pixel_images(7, 5, size=16, channels=3),
                       j_synthetic.pixel_images(7, 5, size=16, channels=3))):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (synthetic.PAD, synthetic.LISTOPS_VOCAB) == (j_synthetic.PAD,
                                                        j_synthetic.LISTOPS_VOCAB)
