"""Elastic re-planning and straggler detection, copied from
``repro/runtime/elastic.py`` (pure Python; the port keeps its own copy).

Recovery is re-plan and restore: ``plan_mesh(n_healthy)`` picks the
largest (pod, data, model) factorization that the healthy devices hold,
the model axis kept largest first; ``ElasticTrainer.recover`` rebuilds the
step for that plan and restores the last committed checkpoint
(``CheckpointManager.restore_latest``) into the template state that its
``build`` returns.  The plan's mesh is ``ElasticTrainer.mesh``:
``launch.mesh.make_mesh(plan.shape, plan.axes, devices)``, which ``build``
reads (``launch.train.build_train(..., mesh=trainer.mesh)``).  On one GPU
``recover(1)`` plans (1, 1), and a larger plan reuses the card for every
position.

``StepMonitor`` keeps an EWMA of step wall time and flags a step slower
than ``threshold`` times it (``launch/train.py`` times every step with
it; call ``stop`` after the step's host synchronization, or a GPU step is
timed by its launches only).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

PREFERRED_MODEL_PAR = (16, 8, 4, 2, 1)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_healthy: int, *, pod_size: int = 256,
              min_model: int = 1) -> MeshPlan:
    """Largest usable (pod, data, model) plan for ``n_healthy`` devices."""
    if n_healthy <= 0:
        raise ValueError("no healthy devices")
    n_pods = max(1, n_healthy // pod_size)
    per_pod = n_healthy if n_pods == 1 else pod_size
    for model in PREFERRED_MODEL_PAR:
        if model < min_model:
            continue
        data = per_pod // model
        if data >= 1 and model * data <= per_pod:
            if n_pods > 1:
                return MeshPlan((n_pods, data, model), ("pod", "data", "model"))
            return MeshPlan((data, model), ("data", "model"))
    return MeshPlan((1, 1), ("data", "model"))


class StepMonitor:
    """EWMA step-time monitor with straggler callbacks."""

    def __init__(self, *, alpha: float = 0.1, threshold: float = 2.0,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: float | None = None
        self.on_straggler = on_straggler
        self.flagged: list[tuple[int, float]] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> float:
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt
        )
        return dt


class ElasticTrainer:
    """The recovery loop's re-plan, rebuild and restore.

    ``build(mesh_plan) -> (step_fn, state)`` builds the train step and a
    template state for a plan (reading ``self.mesh``, the plan's mesh over
    ``devices``); ``recover(n_healthy)`` returns (plan, step_fn, state,
    step): the latest checkpoint restored into the template, or the
    template at step 0 where there is none.
    """

    def __init__(self, build: Callable, checkpoint_mgr, *, pod_size: int = 256,
                 devices=None):
        self.build = build
        self.ckpt = checkpoint_mgr
        self.pod_size = pod_size
        self.devices = devices
        self.plan: MeshPlan | None = None
        self.rebuilds = 0

    @property
    def mesh(self):
        """The mesh of the current plan over ``devices`` (every CUDA device
        when None), built by ``launch.mesh.make_mesh``."""
        from repro_torch.launch.mesh import make_mesh

        if self.plan is None:
            raise ValueError("no plan yet: call recover() first")
        return make_mesh(self.plan.shape, self.plan.axes, self.devices)

    def recover(self, n_healthy: int):
        plan = self.plan = plan_mesh(n_healthy, pod_size=self.pod_size)
        step_fn, state_template = self.build(plan)
        restored = self.ckpt.restore_latest(state_template)
        self.rebuilds += 1
        if restored is None:
            return plan, step_fn, state_template, 0
        step, state, extra = restored
        return plan, step_fn, state, step
