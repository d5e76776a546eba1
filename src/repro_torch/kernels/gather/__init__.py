"""The gathers on Hopper: K9 (the per-row conv-history gather of packed
prefill) and K8a, K8b (the page-table gathers of paged KV decode)."""
from repro_torch.kernels.gather.boundary import (boundary_gather,
                                                 boundary_gather_many)
from repro_torch.kernels.gather.paged import paged_gather, paged_gather_quant
from repro_torch.kernels.gather.ref import (boundary_gather_many_ref,
                                            boundary_gather_ref,
                                            paged_gather_quant_ref,
                                            paged_gather_ref)

__all__ = ["boundary_gather", "boundary_gather_many",
           "boundary_gather_many_ref", "boundary_gather_ref", "paged_gather",
           "paged_gather_quant", "paged_gather_quant_ref", "paged_gather_ref"]
