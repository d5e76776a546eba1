"""Port vs reference: ``runtime/elastic.py`` (mesh plans, the step-time
monitor, the recovery loop with the port's ``CheckpointManager``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import elastic as j_elastic  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime import (ElasticTrainer, MeshPlan,  # noqa: E402
                                 StepMonitor, plan_mesh)


@pytest.mark.parametrize("pod_size", [1, 4, 16, 64, 256])
def test_plan_mesh_matches_reference(pod_size):
    for n in range(1, 1025):
        got = plan_mesh(n, pod_size=pod_size)
        want = j_elastic.plan_mesh(n, pod_size=pod_size)
        assert (got.shape, got.axes, got.n_devices) == (
            want.shape, want.axes, want.n_devices), n
    assert plan_mesh(1).shape == (1, 1)
    with pytest.raises(ValueError, match="no healthy devices"):
        plan_mesh(0)


@pytest.mark.parametrize("alpha,threshold", [(0.1, 2.0), (0.5, 1.5)])
def test_step_monitor_flags_the_reference_steps(alpha, threshold):
    rng = np.random.default_rng(0)
    series = rng.lognormal(0.0, 0.4, 400)
    series[rng.choice(400, 12, replace=False)] *= 6.0  # stragglers
    got, want = [], []
    ours = StepMonitor(alpha=alpha, threshold=threshold,
                       on_straggler=lambda s, dt, mu: got.append((s, mu)))
    ref = j_elastic.StepMonitor(alpha=alpha, threshold=threshold,
                                on_straggler=lambda s, dt, mu:
                                want.append((s, mu)))
    for step, dt in enumerate(series):
        assert ours.observe(step, float(dt)) == ref.observe(step, float(dt))
    assert got == want and ours.flagged == ref.flagged and len(got) >= 12
    assert ours.ewma == ref.ewma


def test_step_monitor_times_start_to_stop():
    mon = StepMonitor()
    mon.start()
    dt = mon.stop(0)
    assert dt >= 0.0 and mon.ewma == dt
    with pytest.raises(AssertionError, match="start"):
        mon.stop(1)


def test_elastic_trainer_recovers_from_checkpoint(tmp_path):
    """The reference's recovery test with the port's manager: re-plan to
    fewer devices, restore the state, continue."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, {"w": torch.arange(4.0)}, extra={"data_step": 7})
    built = []

    def build(plan: MeshPlan):
        built.append(plan)
        return (lambda state: {"w": state["w"] + 1}), {"w": torch.zeros(4)}

    trainer = ElasticTrainer(build, mgr, pod_size=4)
    plan, step_fn, state, step = trainer.recover(n_healthy=8)
    assert step == 7 and plan.shape == (2, 1, 4)
    assert torch.equal(state["w"], torch.arange(4.0))
    assert torch.equal(step_fn(state)["w"], torch.arange(4.0) + 1)
    plan2, _, _, step2 = trainer.recover(n_healthy=3)
    assert plan2.n_devices <= 3 and step2 == 7
    assert trainer.rebuilds == 2 and built == [plan, plan2]
    # one card: a (1, 1) plan
    assert trainer.recover(n_healthy=1)[0] == MeshPlan((1, 1),
                                                       ("data", "model"))


def test_recover_without_a_checkpoint_keeps_the_template(tmp_path):
    trainer = ElasticTrainer(lambda plan: (None, {"w": torch.ones(2)}),
                             CheckpointManager(tmp_path))
    _, _, state, step = trainer.recover(1)
    assert step == 0 and torch.equal(state["w"], torch.ones(2))
