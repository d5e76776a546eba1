"""Port vs reference: the hierarchical vision Flowformer.

The same parameters (``repro.models.vision.init``, carried across with
``interop.params_from_numpy``) and the same numpy images go through the
JAX package and the port on the CPU, in fp32:

* ``_patchify`` and ``_merge2x2``: bit for bit (reshapes and transposes);
* the configs, field for field; ``pixel_images(channels=3)`` bit for bit;
* the smoke config (channels 32-128, 4 heads: D = 8, 16, 24, 32) and the
  full width cut to one block a stage (channels 96-768, 16 heads: D = 6,
  12, 24, 48): logits and loss at rtol 1e-4, atol 1e-4 (XLA and PyTorch
  sum the same fp32 products in another order), and every gradient
  (``jax.grad``) within 1e-4 of that leaf's max |grad| (the query and key
  projections' gradients are 10-1,000x smaller than the others', so
  their rounding noise is larger beside their own maximum: up to 1.8e-5
  of it against an fp64 run on the CPU, ``tools/nc_grad_precision.py
  --device cpu --size 64 --batch 2``).  Checked
  with the reference on its fused non-causal kernel (``pallas_nc``,
  interpret mode) against the port's kernel glue (``cuda_nc``, whose
  kernels run their plain versions on the CPU), and with both on
  ``auto``.  The images are 64 x 64 (256, 64, 16 and 4 tokens a stage):
  at 32 x 32 the last stage holds one token, where non-causal flow
  attention returns sigmoid(1) v whatever q and k are (up to eps), so the
  wq and wk gradients there are rounding noise (4e-8 against 0.27 for
  wv) and no two implementations agree on them;
* the interop round trip, bit for bit; the registry's choice of
  ``cuda_nc`` at every head dim the non-causal kernels take, while the
  causal kernels keep refusing those outside (32, 64, 128);
* the launcher's vision task on the CPU.
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
from repro.models import vision as jvision  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.attention import backends  # noqa: E402
from repro_torch.attention.registry import ShapeInfo  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels._lib import HEAD_DIMS, NC_HEAD_DIMS  # noqa: E402
from repro_torch.launch import classify  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

F32 = torch.float32
SIZE = 64


def shallow_full_width():
    """The full-width vision config with one block a stage."""
    return dataclasses.replace(get_config("flowformer_vision"),
                               stage_layers=(1, 1, 1, 1))


def j_config(which: str):
    if which == "smoke":
        return j_smoke_config("flowformer_vision")
    return dataclasses.replace(j_get_config("flowformer_vision"),
                               stage_layers=(1, 1, 1, 1))


def port_config(which: str):
    return (get_smoke_config("flowformer_vision") if which == "smoke"
            else shallow_full_width())


def with_backend(cfg, backend):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))


@pytest.fixture(scope="module")
def trees():
    init = jax.jit(jvision.init, static_argnums=1)
    return {which: jax.tree.map(np.asarray, init(jax.random.PRNGKey(i),
                                                 j_config(which)))
            for i, which in enumerate(("smoke", "full"))}


def j_reference(tree, batch, jcfg):
    """The reference's fp32 logits, loss and gradients, in one jit."""
    def run(p, b):
        logits = jvision.forward(p, b["images"], jcfg, dtype=jnp.float32)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jvision.loss_fn(p, b, jcfg, dtype=jnp.float32),
            has_aux=True)(p)
        return logits, loss, grads

    return jax.jit(run)(tree, batch)


def images(n: int, n_classes: int, seed: int = 0) -> dict:
    xs, ys = synthetic.pixel_images(seed, n, size=SIZE, n_classes=n_classes,
                                    channels=3)
    return {"images": xs, "labels": ys}


def test_patchify_and_merge_match_reference_bitwise():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        vision._patchify(torch.from_numpy(imgs), 4).numpy(),
        np.asarray(jvision._patchify(jnp.asarray(imgs), 4)))
    x = rng.standard_normal((2, 64, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        vision._merge2x2(torch.from_numpy(x), 8).numpy(),
        np.asarray(jvision._merge2x2(jnp.asarray(x), 8)))


@pytest.mark.parametrize("get", ["full", "smoke"])
def test_flowformer_vision_configs_match_reference(get):
    ours = (get_config if get == "full" else get_smoke_config)(
        "flowformer_vision")
    ref = (j_get_config if get == "full" else j_smoke_config)(
        "flowformer_vision")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    dims = [s.dim_head for s in vision.stage_cfgs(ours)]
    assert dims == ([6, 12, 24, 48] if get == "full" else [8, 16, 24, 32])


def test_rgb_pixel_images_match_reference():
    for a, b in zip(synthetic.pixel_images(3, 5, size=24, n_classes=1000,
                                           channels=3),
                    j_synthetic.pixel_images(3, 5, size=24, n_classes=1000,
                                             channels=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_vision_params_round_trip_bit_exact(trees, which):
    tree = trees[which]
    cfg = port_config(which)
    params = params_from_numpy(tree, cfg)
    assert isinstance(params["stages"][0]["blocks"], list)
    assert "merge" not in params["stages"][-1] and "b" in params["classifier"]
    back = params_to_numpy(params, cfg)
    (a_leaves, a_def), (b_leaves, b_def) = (jax.tree.flatten(back),
                                            jax.tree.flatten(tree))
    assert a_def == b_def
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="stages"):
        params_from_numpy(tree, dataclasses.replace(cfg,
                                                    stage_layers=(2, 1, 1, 1)))


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_port_init_matches_reference_tree(trees, which):
    params = vision.init(port_config(which), torch.Generator().manual_seed(0),
                         device="cpu")
    (_, want_def), (got, got_def) = (jax.tree.flatten(trees[which]),
                                     jax.tree.flatten(params_to_numpy(
                                         params, port_config(which))))
    assert got_def == want_def
    for a, b in zip(got, jax.tree.leaves(trees[which])):
        assert a.shape == b.shape and a.dtype == b.dtype


def leaf_pairs(port: dict, ref: dict, cfg):
    """(port leaf, reference leaf) in the port's tree order."""
    return zip(tree_leaves(port), tree_leaves(params_from_numpy(
        jax.tree.map(np.asarray, ref), cfg)))


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("ref_backend,port_backend", [
    ("pallas_nc", "cuda_nc"), ("auto", "auto")])
def test_vision_logits_loss_and_grads_match_reference(
        trees, monkeypatch, which, ref_backend, port_backend):
    if port_backend == "cuda_nc":  # the kernel glue, on its plain versions
        monkeypatch.setattr(backends, "_check_nc_dims", lambda s, p: None)
    jcfg, cfg = j_config(which), port_config(which)
    jcfg = with_backend(jcfg, ref_backend)
    cfg = with_backend(cfg, port_backend)
    batch = images(2, cfg.n_classes, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_logits, j_loss, j_grads = j_reference(
        jax.tree.map(jnp.asarray, trees[which]), jb, jcfg)
    params = params_from_numpy(trees[which], cfg)
    before = dict(LAUNCHES)
    with torch.no_grad():
        logits = vision.forward(params, tb["images"], cfg, dtype=F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4,
                               atol=1e-4)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, metrics = vision.loss_fn(params, tb, cfg, dtype=F32)
    grads = torch.autograd.grad(loss, leaves)
    assert LAUNCHES == before, "the CPU path must not count a launch"
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4)
    assert 0.0 <= float(metrics["acc"]) <= 1.0
    for g, (_, want) in zip(grads, leaf_pairs(params, j_grads, cfg)):
        scale = float(want.abs().max())
        assert scale > 0 and float((g - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("d", NC_HEAD_DIMS)
def test_cuda_nc_resolves_at_every_nc_head_dim(d):
    """On a CUDA device the non-causal kernels take every head dim of the
    nc tuple (forward and training); the causal kernels keep theirs."""
    shapes = ShapeInfo(b=64, hq=16, hkv=16, n=49, m=49, d=d, dv=d)
    plan = attention.ExecutionPlan(flow=FlowConfig(causal=False))
    assert attention.resolve(plan).backend("forward", shapes,
                                           "cuda").name == "cuda_nc"
    assert attention.resolve_for_training(plan, shapes, "cuda").name == \
        "cuda_nc"
    causal = attention.ExecutionPlan(flow=FlowConfig(causal=True,
                                                     strict_causal=True))
    if d in HEAD_DIMS:
        assert attention.resolve(causal).backend(
            "forward", shapes, "cuda").name == "cuda_fused"
    else:
        with pytest.raises(attention.ResolutionError,
                           match=r"kernel takes D == Dv in \(32, 64, 128\)"):
            attention.resolve(causal).backend("forward", shapes, "cuda")


def test_cuda_nc_refuses_head_dims_outside_the_nc_tuple():
    shapes = ShapeInfo(b=2, hq=4, hkv=4, n=49, m=49, d=20, dv=20)
    plan = attention.ExecutionPlan(flow=FlowConfig(causal=False))
    with pytest.raises(attention.ResolutionError, match="kernel takes D == Dv"):
        attention.resolve(plan).backend("forward", shapes, "cuda")


def test_launcher_vision_task_runs_on_cpu():
    out = classify.run("flowformer-vision", smoke=True, steps=2, batch=2,
                       n_train=4, n_eval=3, log_every=0, device="cpu")
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert out["backends"] == ["nc"] * 4 and 0.0 <= out["acc"] <= 1.0
