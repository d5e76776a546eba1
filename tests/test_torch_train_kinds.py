"""Training the softmax and linear LMs (``--attn``) on the port, against
the reference.

``launch/steps.py::check_flow_trainable`` resolves no flow backend for
them, as the reference's does, after resolving every layer's mixer.  The
smoke LM of each kind (the reference's ``lm.init``, carried across with
``interop``) trains 2 fp32 steps through the port's ``train(device=
"cpu")`` and through the reference's ``make_train_step`` with the
``TrainConfig`` that ``train`` builds: losses within rtol 1e-5, as three
fp32 steps are held in ``tests/test_torch_train.py`` (the same fp32 sums
in another order).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.data.loader import lm_loader as j_lm_loader  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training.train_state import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_state import init_train_state as j_init_state  # noqa: E402
from repro.training.train_state import make_train_step as j_make_step  # noqa: E402
from repro_torch import attention  # noqa: E402
from repro_torch.config import ShapeSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import check_flow_trainable  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def with_kind(cfg, kind, **over):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, kind=kind, **over))


@pytest.mark.parametrize("kind", ["softmax", "linear"])
@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_check_flow_trainable_resolves_no_flow_backend(kind, platform):
    cfg = with_kind(get_smoke_config("flowformer_lm"), kind)
    assert check_flow_trainable(cfg, ShapeSpec("t", 512, 16, "train"),
                                platform) is None


def test_flow_stacks_still_resolve_and_refuse():
    """Flow keeps its backend, and a flow stack that no backend can
    differentiate causally (the non-causal ``nc`` pinned) is still
    refused."""
    cfg = get_smoke_config("flowformer_lm")
    shape = ShapeSpec("t", 512, 16, "train")
    assert check_flow_trainable(cfg, shape, "cuda").name == "cuda_fused"
    pinned = with_kind(cfg, "flow", backend="nc")
    with pytest.raises(attention.ResolutionError, match="with gradients"):
        check_flow_trainable(pinned, shape, "cpu")


@pytest.mark.parametrize("kind", ["softmax", "linear"])
def test_two_steps_match_the_reference(kind):
    jcfg = with_kind(j_smoke_config("flowformer_lm"), kind)
    cfg = with_kind(get_smoke_config("flowformer_lm"), kind)
    jparams = jlm.init(jax.random.PRNGKey(1), jcfg)
    steps, batch, seq = 2, 2, 32
    # the TrainConfig that ``train`` builds
    jtcfg = JTrainConfig(total_steps=steps, warmup=5, peak_lr=3e-4,
                         fused_value_grad=True, compute_dtype=jnp.float32)
    j_step = jax.jit(j_make_step(
        functools.partial(jlm.loss_fn, cfg=jcfg, dtype=jnp.float32), jtcfg))
    j_state = j_init_state(jparams, jtcfg)
    loader = j_lm_loader(1, batch=batch, seq=seq, vocab=cfg.vocab_size)
    want = []
    for _ in range(steps):
        j_state, metrics = j_step(j_state, jax.tree.map(jnp.asarray,
                                                        next(loader)))
        want.append(float(metrics["loss"]))
    out = train(cfg, steps=steps, batch=batch, seq=seq, seed=1,
                device="cpu", dtype=torch.float32,
                params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         cfg))
    np.testing.assert_allclose(out["history"], want, rtol=1e-5)
    assert out["state"].step == steps
