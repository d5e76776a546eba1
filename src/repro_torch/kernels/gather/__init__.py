"""K9 (the per-row conv-history gather of packed prefill) on Hopper."""
from repro_torch.kernels.gather.boundary import boundary_gather
from repro_torch.kernels.gather.ref import boundary_gather_ref

__all__ = ["boundary_gather", "boundary_gather_ref"]
