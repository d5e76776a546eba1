"""Port vs reference: configuration copies and the parameter carry-over.

The port keeps its own copies of ``config.py``, ``configs/flowformer_lm.py``
and ``FlowConfig``; they must equal the reference field for field, default
for default.  ``params_from_numpy`` / ``params_to_numpy`` must round-trip
the reference's param tree bit for bit (tolerance zero) in both of its
layouts: stacked ``scan`` groups and the flat ``blocks`` list.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.flow_attention import FlowConfig as JFlowConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
import repro_torch.config as tconfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.flow_attention import FlowConfig  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def fields(cls):
    """(name, type, default) per field; ``None`` where there is none."""
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if default is dataclasses.MISSING:
            default = (None if f.default_factory is dataclasses.MISSING
                       else f.default_factory())
        out.append((f.name, str(f.type), default))
    return out


@pytest.mark.parametrize("name", ["AttentionConfig", "MoEConfig", "MLAConfig",
                                  "RGLRUConfig", "SSDConfig", "ModelConfig",
                                  "ShapeSpec"])
def test_config_dataclasses_match_reference(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    if name == "ModelConfig":  # the nested default is the port's own class
        strip = lambda fs: [(n, ty, dataclasses.asdict(d)  # noqa: E731
                             if dataclasses.is_dataclass(d) else d)
                            for n, ty, d in fs]
        assert strip(fields(ours)) == strip(fields(ref))
    else:
        assert fields(ours) == fields(ref)


def test_flow_config_matches_reference():
    assert fields(FlowConfig) == fields(JFlowConfig)
    assert FlowConfig().eps == 1e-6 and FlowConfig().backend == "auto"


@pytest.mark.parametrize("get", ["full", "smoke"])
def test_flowformer_lm_configs_match_reference(get):
    ours = (get_config if get == "full" else get_smoke_config)("flowformer_lm")
    ref = (j_get_config if get == "full" else j_smoke_config)("flowformer_lm")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()


@pytest.mark.parametrize("n_layers,layout", [(2, "scan"), (1, "blocks"),
                                             (3, "scan")])
def test_params_round_trip_bit_exact(n_layers, layout):
    jcfg = dataclasses.replace(j_smoke_config("flowformer_lm"),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_smoke_config("flowformer_lm"),
                              n_layers=n_layers)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(n_layers),
                                             jcfg))
    assert layout in tree
    params = params_from_numpy(tree, cfg)
    assert len(params["blocks"]) == n_layers
    if layout == "scan":  # layer r is the r-th slice of the stacked group
        np.testing.assert_array_equal(
            params["blocks"][-1]["attn"]["wq"]["w"].numpy(),
            tree["scan"][0]["attn"]["wq"]["w"][n_layers - 1])
    back = params_to_numpy(params, cfg)
    (a_leaves, a_def), (b_leaves, b_def) = (jax.tree.flatten(back),
                                            jax.tree.flatten(tree))
    assert a_def == b_def
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_reference_shapes_and_scales():
    cfg = get_smoke_config("flowformer_lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ours = jax.tree.map(np.shape, params_to_numpy(params, cfg))
    ref = jax.tree.map(np.shape, jlm.init(jax.random.PRNGKey(0),
                                          j_smoke_config("flowformer_lm")))
    assert ours == ref
    table = params["embed"]["table"]
    assert table.abs().max() <= 0.04 + 1e-6  # truncated at 2 std
    assert abs(float(table.std()) - 0.02 * 0.88) < 2e-3  # trunc-normal std
    w = params["blocks"][0]["ffn"]["w_in"]["w"]
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05  # LeCun
    again = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["head"]["table"], params["head"]["table"])
