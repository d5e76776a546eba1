"""Port vs reference: the flowformer_lm decoder on the same weights.

The reference's smoke parameters (``repro.models.lm.init``) are carried
across with ``repro_torch.interop.params_from_numpy``; the same token ids
go through both ``lm`` modules in fp32 on the CPU.  Tolerance: atol and
rtol 1e-4 on the logits and 2e-4 on the decode states -- the same fp32
products summed in another order by XLA and PyTorch's CPU kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


@pytest.fixture(scope="module")
def model():
    jcfg = j_smoke_config("flowformer_lm")
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("flowformer_lm")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def ids(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def close(a, b, what="", **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               err_msg=what, **(tol or TOL))


def test_forward_logits_match_reference(model):
    jcfg, jparams, cfg, params = model
    seq = ids(np.random.default_rng(1), cfg, 2, 45)
    j_logits, _ = jlm.forward(jparams, jnp.asarray(seq), jcfg,
                              dtype=jnp.float32)
    logits, aux = lm.forward(params, torch.from_numpy(seq), cfg, dtype=F32)
    assert logits.dtype == F32 and float(aux) == 0.0
    close(logits, j_logits, "forward logits")


def test_packed_prefill_and_decode_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(2)
    n, steps = 32, 4
    lengths = np.array([32, 9, 20], np.int32)
    toks = ids(rng, cfg, 3, n)
    for i, li in enumerate(lengths):
        toks[i, li:] = 0
    j_logits, j_caches = jlm.prefill(jparams, jnp.asarray(toks), jcfg,
                                     max_len=n, dtype=jnp.float32,
                                     lengths=jnp.asarray(lengths))
    logits, caches = lm.prefill(params, torch.from_numpy(toks), cfg,
                                max_len=n, dtype=F32,
                                lengths=torch.from_numpy(lengths))
    close(logits, j_logits, "prefill logits")
    pos = lengths.copy()
    for s in range(steps):
        tok = ids(rng, cfg, 3, 1)
        j_logits, j_caches = jlm.decode(jparams, jnp.asarray(tok), j_caches,
                                        jcfg, jnp.asarray(pos),
                                        dtype=jnp.float32)
        logits, caches = lm.decode(params, torch.from_numpy(tok), caches, cfg,
                                   torch.from_numpy(pos), dtype=F32)
        close(logits, j_logits, f"decode logits step {s}")
        pos += 1
    for layer, (st, jst) in enumerate(zip(caches, j_caches)):
        for name, a, b in zip(st._fields, st, jst):
            close(a, b, f"layer {layer} {name}", rtol=2e-4, atol=2e-4)


def test_prefill_then_decode_equals_forward(model):
    _, _, cfg, params = model
    rng = np.random.default_rng(3)
    n, steps = 27, 5
    seq = torch.from_numpy(ids(rng, cfg, 2, n + steps))
    full, _ = lm.forward(params, seq, cfg, dtype=F32)
    logits, caches = lm.prefill(params, seq[:, :n], cfg, max_len=n + steps,
                                dtype=F32)
    close(logits, full[:, n - 1:n], "prefill")
    for s in range(steps):
        logits, caches = lm.decode(params, seq[:, n + s:n + s + 1], caches,
                                   cfg, n + s, dtype=F32)
        close(logits, full[:, n + s:n + s + 1], f"decode {s}")
