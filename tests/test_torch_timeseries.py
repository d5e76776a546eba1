"""Port vs reference: the UEA time-series encoder.

The encoder classifier with continuous inputs (``in_dim`` features into
``in_proj``; rope over the positions) on the time-series configs.  The
same parameters (``repro.models.classifier.init``, carried across with
``interop.params_from_numpy``) and the same numpy series go through the
JAX package and the port on the CPU, in fp32:

* ``timeseries``: bit for bit from the same seed; the configs field for
  field;
* the smoke config (64 wide, 2 heads: D = 32) and the reference
  harness's override (``benchmarks/timeseries_table6.py``: 96 wide,
  4 heads, d_ff 192: D = 24, a head dim only the non-causal kernels'
  small-head route takes), with 8 and 24 dims: logits and loss at rtol
  1e-4, atol 1e-4 (the same fp32 products summed in another order), and
  every gradient within 1e-4 of that leaf's max |grad| (the query and key
  projections' gradients are far smaller than the others', so their
  rounding noise is larger beside their own maximum), with the reference
  on ``pallas_nc`` (interpret mode) against the port's kernel glue
  (``cuda_nc`` on its plain versions) and with both on ``auto``;
* the launcher's time-series task on the CPU.
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
from repro_torch.attention import backends  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import classify  # noqa: E402
from repro_torch.models import classifier  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

F32 = torch.float32
LENGTH, N_CLASSES = 48, 6
#: the reference harness's override of the config (timeseries_table6.py:19-20)
HARNESS = dict(d_model=96, n_heads=4, n_kv_heads=4, d_ff=192)


def configs(which: str):
    """(reference config, port config): the smoke config, or the harness's
    D = 24 override of the full one."""
    if which == "smoke":
        return (j_smoke_config("flowformer_timeseries"),
                get_smoke_config("flowformer_timeseries"))
    return (dataclasses.replace(j_get_config("flowformer_timeseries"),
                                **HARNESS),
            get_config("flowformer_timeseries", **HARNESS))


def with_backend(cfg, backend):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend=backend))


def test_timeseries_matches_reference_bitwise():
    for kw in (dict(length=96, dims=8, n_classes=6),
               dict(length=40, dims=24, n_classes=3)):
        for a, b in zip(synthetic.timeseries(5, 7, **kw),
                        j_synthetic.timeseries(5, 7, **kw)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("get", ["full", "smoke"])
def test_flowformer_timeseries_configs_match_reference(get):
    ours = (get_config if get == "full" else get_smoke_config)(
        "flowformer_timeseries")
    ref = (j_get_config if get == "full" else j_smoke_config)(
        "flowformer_timeseries")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.embedding_frontend == "stub" and ours.dim_head == (
        64 if get == "full" else 32)
    assert configs("harness")[1].dim_head == 24


@pytest.mark.parametrize("which,dims", [("smoke", 8), ("harness", 8),
                                        ("harness", 24)])
@pytest.mark.parametrize("ref_backend,port_backend", [
    ("pallas_nc", "cuda_nc"), ("auto", "auto")])
def test_timeseries_loss_and_grads_match_reference(monkeypatch, which, dims,
                                                   ref_backend, port_backend):
    if port_backend == "cuda_nc":  # the kernel glue, on its plain versions
        monkeypatch.setattr(backends, "_check_nc_dims", lambda s, p: None)
    jcfg, cfg = configs(which)
    jcfg, cfg = with_backend(jcfg, ref_backend), with_backend(cfg, port_backend)
    xs, ys = synthetic.timeseries(dims, 3, length=LENGTH, dims=dims,
                                  n_classes=N_CLASSES)
    tree = jax.jit(lambda k: jclf.init(k, jcfg, n_classes=N_CLASSES,
                                       in_dim=dims))(jax.random.PRNGKey(dims))
    jb = {"inputs": jnp.asarray(xs), "labels": jnp.asarray(ys)}

    @jax.jit
    def reference(p, b):
        logits = jclf.forward(p, b["inputs"], jcfg, dtype=jnp.float32)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jclf.loss_fn(p, b, jcfg, dtype=jnp.float32),
            has_aux=True)(p)
        return logits, loss, grads

    want_logits, j_loss, j_grads = reference(tree, jb)
    params = params_from_numpy(jax.tree.map(np.asarray, tree), cfg)
    tb = {"inputs": torch.from_numpy(xs), "labels": torch.from_numpy(ys)}
    with torch.no_grad():
        logits = classifier.forward(params, tb["inputs"], cfg, dtype=F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = classifier.loss_fn(params, tb, cfg, dtype=F32)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, j_grads),
                                         cfg))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        scale = float(w.abs().max())
        assert scale > 0 and float((g - w).abs().max()) <= 1e-4 * scale


def test_launcher_timeseries_task_runs_on_cpu():
    out = classify.run("flowformer-timeseries", smoke=True, steps=2, batch=2,
                       seq=32, n_train=4, n_eval=3, log_every=0, device="cpu")
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    assert out["backends"] == ["nc"] and 0.0 <= out["acc"] <= 1.0
