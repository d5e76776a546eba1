"""The port's checkpointing (``checkpoint/manager.py``) and crash-restart
through ``launch/train.py::train``.

The reference's six manager tests, ported; the on-disk format held
against the reference's manager in both directions (either restores what
the other wrote, and both write the same ``paths`` and ``bf16`` lists);
a writer's error raised by ``wait()``; and a crash-restart of the smoke LM
on the CPU, bitwise equal to an uninterrupted run on every leaf of the
final ``TrainState`` (the reference's own crash-restart test fails on
jax 0.9.0, whose ``jax.make_mesh`` gives the reference's default mesh
Explicit axes).
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.training.optimizer import AdamWState as JAdamWState  # noqa: E402
from repro.training.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.training.optimizer import AdamWState  # noqa: E402
from repro_torch.training.train_state import TrainState  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402


def _tree(seed=0):
    """The reference test's tree: dict, list, bf16 and int leaves."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "a": {"w": torch.randn((8, 8), generator=gen), "b": torch.zeros(8)},
        "step_arr": 3,
        "nested": [{"x": torch.ones((2, 3), dtype=torch.bfloat16)}],
    }


def zeros_like(tree):
    return tree_map(lambda x: torch.zeros_like(x)
                    if isinstance(x, torch.Tensor) else 0, tree)


def assert_bitwise(got, want, what=""):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, what
            assert torch.equal(x.view(-1).view(torch.uint8),
                               y.view(-1).view(torch.uint8)), what
        else:
            assert type(x) is type(y) and x == y, what


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(10, tree)
    restored, extra = mgr.restore(10, zeros_like(tree))
    assert_bitwise(restored, tree)
    assert extra == {}


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]  # GC kept the last 2


def test_extra_state_rides_along(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(), extra={"data_step": 123})
    _, extra = mgr.restore(5, _tree())
    assert extra == {"data_step": 123}


def test_torn_write_is_invisible(tmp_path):
    """A *_tmp directory (a crash mid-write) is never visible."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    tmp = pathlib.Path(tmp_path) / "step_000000000002_tmp"
    tmp.mkdir()
    (tmp / "shard_0.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    restored = mgr.restore_latest(zeros_like(_tree()))
    assert restored is not None and restored[0] == 1


def test_async_save(tmp_path):
    """The async save copies the tree before its writer starts: a tensor
    changed in place afterwards is saved as it was."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    want = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)
    mgr.save(7, tree, async_=True)
    tree["a"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    assert_bitwise(mgr.restore(7, zeros_like(want))[0], want)


def test_restore_latest_none(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.restore_latest(_tree()) is None


def test_writer_error_is_raised_by_wait(tmp_path):
    root = pathlib.Path(tmp_path) / "ckpt"
    mgr = CheckpointManager(root)
    root.rmdir()
    root.write_text("not a directory")  # the writer's mkdir must fail
    mgr.save(1, _tree(), async_=True)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


def test_restore_names_a_missing_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf b"):
        mgr.restore(1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def port_state():
    tree = _tree()
    master = {"a": tree["a"], "nested": tree["nested"]}
    m = tree_map(lambda x: x + 1, master)
    return TrainState(master, AdamWState(m, m, 4), 4)


def ref_state():
    """``port_state`` in the reference's types, with JAX arrays."""
    s = port_state()

    def jx(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())

    master, m = tree_map(jx, s.master), tree_map(jx, s.opt.m)
    step = jnp.asarray(4, jnp.int32)
    return JTrainState(master, JAdamWState(m, m, step), step)


def meta_of(root, step):
    return json.loads((pathlib.Path(root) / f"step_{step:012d}" /
                       "meta.json").read_text())


def test_formats_are_interchangeable_with_the_reference(tmp_path):
    """Either manager restores a TrainState-shaped tree (dict, list, bf16
    and int leaves under NamedTuples) that the other wrote, and both write
    the same leaf paths and bf16 list."""
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(ours).save(4, port_state(), extra={"step": 4})
    JManager(theirs).save(4, ref_state(), extra={"step": 4})
    mine, ref = meta_of(ours, 4), meta_of(theirs, 4)
    assert mine["paths"] == ref["paths"]
    assert mine["bf16"] == ref["bf16"] == [".master/nested/0/x",
                                           ".opt/.m/nested/0/x",
                                           ".opt/.v/nested/0/x"]
    assert ".opt/.step" in mine["paths"] and ".step" in mine["paths"]
    assert mine["extra"] == ref["extra"] == {"step": 4}

    # the port restores the reference's directory
    got, _ = CheckpointManager(theirs).restore(4, zeros_like(port_state()))
    assert_bitwise(got, port_state())
    assert got.step == got.opt.step == 4
    # the reference restores the port's
    like = jax.tree.map(jnp.zeros_like, ref_state())
    back, extra = JManager(ours).restore(4, like)
    assert extra == {"step": 4}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state())):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_crash_restart_is_bitwise(tmp_path):
    """Train 4 steps with a checkpoint every 2; separately train 2 steps,
    'crash', and resume to 4 in a fresh ``train()``: the resumed run
    replays the same batches and ends bitwise on the uninterrupted run's
    state."""
    cfg = get_smoke_config("flowformer_lm")
    kw = dict(batch=2, seq=32, ckpt_every=2, log_every=100, device="cpu")
    full = train(cfg, steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    first = train(cfg, steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train(cfg, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert first["start_step"] == 0 and resumed["start_step"] == 2
    assert first["history"] == full["history"][:2]
    assert resumed["history"] == full["history"][2:]
    assert resumed["ckpt"]["restore_s"] is not None
    assert len(full["ckpt"]["async_save_s"]) == 2
    assert_bitwise(resumed["state"], full["state"], "resumed final state")
    assert CheckpointManager(tmp_path / "b").all_steps() == [2, 4]
    assert meta_of(tmp_path / "b", 4)["extra"] == {"step": 4}


def test_cli_takes_attn_and_checkpoint_flags(tmp_path):
    """``--attn linear --ckpt-dir --ckpt-every`` on the CPU; a second run
    of the same command resumes and has nothing left to run."""
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "32", "--attn", "linear", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "1"]
    out = train_cli.main(argv)
    assert len(out["history"]) == 2 and out["state"].step == 2
    assert CheckpointManager(tmp_path).all_steps() == [1, 2]
    again = train_cli.main(argv)
    assert again["start_step"] == 2 and again["history"] == []
    assert_bitwise(again["state"], out["state"])
