"""Runtime: mesh planning, step-time monitoring and the recovery loop."""
from repro_torch.runtime.elastic import (ElasticTrainer, MeshPlan,
                                         StepMonitor, plan_mesh)

__all__ = ["ElasticTrainer", "MeshPlan", "StepMonitor", "plan_mesh"]
