"""Port vs reference: the int8 error-feedback all-reduce
(``training/compression.py``).

``quantize_int8`` / ``dequantize_int8`` are held bitwise against the
reference's on seeded arrays.  ``compressed_psum`` over 4 positions (one
process) is held against the reference's ``compressed_psum`` inside
``jax.shard_map(in_specs=P("data"))`` on a 4-device CPU mesh in a
subprocess: three error-feedback steps, the int8 payloads equal bit for
bit, the means and the carried residuals within 1 ulp of fp32.
"""
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.training import compression as j_comp  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training import compression  # noqa: E402

from test_sharding import run_with_devices  # noqa: E402

N_POS, STEPS = 4, 3
SHAPES = {"a": (257,), "w": (8, 16)}


def arrays(seed):
    rng = np.random.default_rng(seed)
    yield rng.normal(0, 3, (64,))
    yield rng.normal(0, 1e-3, (7, 9))
    yield np.zeros((33,))
    spike = np.zeros((128,))
    spike[17] = 5.0
    yield spike
    yield rng.standard_cauchy((200,))
    # exact halves of the scale: round half to even decides them
    half = np.arange(-8, 9) * 0.5 * (127.0 / 8.0) / 127.0
    yield half * 127.0


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_matches_reference_bitwise(seed):
    for x in arrays(seed):
        x = x.astype(np.float32)
        q, s = compression.quantize_int8(torch.from_numpy(x))
        jq, js = j_comp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        back = compression.dequantize_int8(q, s).numpy()
        jback = np.asarray(j_comp.dequantize_int8(jq, js))
        assert back.tobytes() == jback.tobytes()
        assert np.abs(back - x).max() <= float(s) * 0.5 + 1e-6


def grads_at(step: int):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal((N_POS,) + shp)
                * rng.uniform(0.1, 10.0, (N_POS,) + (1,) * len(shp)))
            .astype(np.float32) for k, shp in SHAPES.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("comp")
    np.savez(d / "in.npz", **{f"{k}_{s}": v for s in range(STEPS)
                              for k, v in grads_at(s).items()})
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.training.compression import compressed_psum

        x = np.load({str(d / "in.npz")!r})
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:{N_POS}]), ("data",))

        def body(g, r):
            g = jax.tree.map(lambda a: a[0], g)
            r = jax.tree.map(lambda a: a[0], r)
            m, nr = compressed_psum(g, r, "data")
            return (jax.tree.map(lambda a: a[None], m),
                    jax.tree.map(lambda a: a[None], nr))

        fn = jax.jit(jax.shard_map(body, mesh=mesh,
                                   in_specs=(P("data"), P("data")),
                                   out_specs=(P("data"), P("data"))))
        keys = {sorted(SHAPES)!r}
        r = {{k: jnp.zeros_like(jnp.asarray(x[k + "_0"])) for k in keys}}
        out = {{}}
        for s in range({STEPS}):
            g = {{k: jnp.asarray(x[f"{{k}}_{{s}}"]) for k in keys}}
            m, r = fn(g, r)
            for k in keys:
                out[f"mean_{{k}}_{{s}}"] = np.asarray(m[k])
                out[f"resid_{{k}}_{{s}}"] = np.asarray(r[k])
        np.savez({str(d / "out.npz")!r}, **out)
        print("done")
    """)
    run_with_devices(code, N_POS)
    return dict(np.load(d / "out.npz"))


def recovered_payload(g, r_in, r_out):
    """The reference's int8 payloads from its residuals: ``r_out = g + r_in
    - q * scale`` with the shared scale, so ``q`` is the nearest integer
    to ``(g + r_in - r_out) / scale``."""
    gg = g.astype(np.float32) + r_in
    scale = np.float32(max(np.float32(max(np.abs(p).max(), 1e-12))
                           for p in gg)) / np.float32(127.0)
    return np.rint((gg.astype(np.float64) - r_out) / np.float64(scale))


def test_compressed_psum_matches_reference(reference):
    mesh = make_mesh((N_POS,), ("data",), devices=["cpu"])
    resid = [{k: torch.zeros(shp) for k, shp in SHAPES.items()}
             for _ in range(N_POS)]
    ref_r = {k: np.zeros((N_POS,) + shp, np.float32)
             for k, shp in SHAPES.items()}
    for s in range(STEPS):
        g = grads_at(s)
        grads = [{k: torch.from_numpy(g[k][i]) for k in SHAPES}
                 for i in range(N_POS)]
        for k in SHAPES:
            qs, scales, _ = compression.ef_payloads(
                [x[k] for x in grads], [x[k] for x in resid], mesh, "data")
            want = recovered_payload(g[k], ref_r[k],
                                     reference[f"resid_{k}_{s}"])
            for i in range(N_POS):
                np.testing.assert_array_equal(qs[i].numpy().astype(np.int64),
                                              want[i].astype(np.int64))
        means, resid = compression.compressed_psum(grads, resid, mesh,
                                                   "data")
        for k in SHAPES:
            ours_m = np.stack([m[k].numpy() for m in means])
            ours_r = np.stack([r[k].numpy() for r in resid])
            np.testing.assert_array_max_ulp(ours_m,
                                            reference[f"mean_{k}_{s}"], 1)
            np.testing.assert_array_max_ulp(ours_r,
                                            reference[f"resid_{k}_{s}"], 1)
            ref_r[k] = reference[f"resid_{k}_{s}"]
            # every position holds the same mean
            assert all(np.array_equal(ours_m[0], x) for x in ours_m)


def test_error_feedback_converges():
    """The reference's ``test_error_feedback_compression_converges``, run
    through the port's ``compressed_psum``: the EF-int8 mean over 4
    positions tracks the true mean, its rounding error bounded and not
    accumulating."""
    rng = np.random.default_rng(0)
    mesh = make_mesh((N_POS,), ("data",), devices=["cpu"])
    resid = [{"g": torch.zeros(32)} for _ in range(N_POS)]
    total_err = []
    for _ in range(50):
        grads = [{"g": torch.from_numpy(rng.normal(0, 1, (32,)))
                  .float()} for _ in range(N_POS)]
        true_mean = sum(g["g"] for g in grads) / N_POS
        means, resid = compression.compressed_psum(grads, resid, mesh)
        total_err.append(float((means[0]["g"] - true_mean).abs().mean()))
    assert np.mean(total_err) < 0.02
    assert max(total_err) < 0.05


def test_make_compressed_allreduce_over_a_dp_axis_of_a_2d_mesh():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    fn = compression.make_compressed_allreduce(mesh, "data")
    # the shared scale is 127 / 127 = 1: both payloads are exact
    grads = [{"g": torch.full((5,), 1.0)}, {"g": torch.full((5,), 127.0)}]
    means, resid = fn(grads, [{"g": torch.zeros(5)}] * 2)
    assert torch.equal(means[0]["g"], torch.full((5,), 64.0))
    assert torch.equal(means[1]["g"], means[0]["g"])
    assert all(float(r["g"].abs().max()) == 0.0 for r in resid)
