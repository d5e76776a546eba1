"""Port vs reference: K2, the backward of the flow_fused kernel.

The same numpy inputs and cotangents, made from a seed, go through
``jax.vjp`` of the reference's ``repro.attention.vjp.flow_fused_dot`` (its
Pallas forward and reverse-scan backward kernels in interpret mode) and
through the port's three plain ways to the same gradients on CPU tensors:
``flow_fused_bwd_ref`` (autograd through K1's plain version),
``flow_fused_bwd_parallel`` (the chunk-parallel decomposition with the
hand-written pull-back that ``csrc/flow_fused_bwd.cu`` runs, at the
kernel-chunk and super-chunk sizes of each case) and ``FlowFusedDot``
through ``backward()``.  Cotangents are random on ``out`` and on all six state
outputs; N is not a multiple of the chunk, so the padded tail must get
zero gradients.  Everything is fp32.  Tolerance: rtol 2e-4, atol 2e-5 --
the same fp32 terms summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.attention.vjp import flow_fused_dot  # noqa: E402
from repro_torch.attention.vjp import FlowFusedDot  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flow_fused import (flow_fused_bwd_call,  # noqa: E402
                                            flow_fused_bwd_parallel,
                                            flow_fused_bwd_ref,
                                            flow_fused_call)

RTOL, ATOL = 2e-4, 2e-5
EPS = 1e-6


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


# (phi, G, use_alloc, n_valid, chunk, tile): n_valid < N = n_valid rounded
# up to the chunk; the parallel twin's chunk is ``tile`` and its flows'
# super-chunk 128 // tile, so the two differ from each other and from N
CASES = [
    ("sigmoid", 1, True, 50, 16, 32),
    ("sigmoid", 2, False, 61, 32, 8),
    ("elu1", 1, False, 45, 16, 8),
    ("elu1", 2, True, 30, 16, 32),
    ("relu", 1, True, 57, 32, 16),
    ("relu", 2, False, 40, 16, 32),
]


@pytest.mark.parametrize("phi,g,use_alloc,n_valid,chunk,tile", CASES)
def test_flow_fused_backward_matches_jax_vjp(phi, g, use_alloc, n_valid,
                                             chunk, tile):
    rng = np.random.default_rng(len(phi) + 10 * g + n_valid + int(use_alloc))
    bh, d = 2, 32
    n = -(-n_valid // chunk) * chunk
    q = rng.standard_normal((bh, g, n, d)).astype(np.float32)
    k = rng.standard_normal((bh, n, d)).astype(np.float32)
    v = rng.standard_normal((bh, n, d)).astype(np.float32)
    g_out = rng.standard_normal((bh, g, n, d)).astype(np.float32)
    g_sums = [rng.standard_normal(s).astype(np.float32)
              for s in [(bh, d)] * 4 + [(bh,), (bh, d, d)]]

    def jfn(qx, kx, vx):
        return flow_fused_dot(qx, kx, vx, n_valid, chunk, EPS, phi,
                              use_alloc, True)

    (j_out, j_sums), pull = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    j_cot = [jnp.asarray(x).reshape(y.shape) for x, y in zip(g_sums, j_sums)]
    want = pull((jnp.asarray(g_out), tuple(j_cot)))

    lens = torch.full((bh,), n_valid, dtype=torch.int32)
    out, totals = flow_fused_call(t(q), t(k), t(v), lens, chunk=chunk,
                                  phi=phi, use_alloc=use_alloc)
    close(out, j_out, "forward out")
    kw = dict(eps=EPS, phi=phi, use_alloc=use_alloc)
    before = dict(LAUNCHES)
    got = {
        "bwd_ref": flow_fused_bwd_ref(t(q), t(k), t(v), lens, t(g_out),
                                      [t(x) for x in g_sums], chunk=chunk,
                                      **kw),
        "bwd_parallel": flow_fused_bwd_parallel(
            t(q), t(k), t(v), lens, t(g_out), [t(x) for x in g_sums],
            chunk=tile, tile=128 // tile, **kw),
        "bwd_call": flow_fused_bwd_call(t(q), t(k), t(v), lens, totals,
                                        t(g_out), [t(x) for x in g_sums],
                                        chunk=chunk, **kw),
    }
    assert LAUNCHES == before, "the CPU path must not count a launch"
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    outs = FlowFusedDot.apply(*leaves, n_valid, chunk, EPS, phi, use_alloc)
    torch.autograd.backward(outs, [t(g_out)] + [t(x) for x in g_sums])
    got["FlowFusedDot"] = tuple(x.grad for x in leaves)

    for how, grads in got.items():
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            close(a, b, f"{how} {name}")
            pad = a[..., n_valid:, :]
            assert torch.equal(pad, torch.zeros_like(pad)), \
                f"{how} {name}: non-zero gradient past n_valid"
