"""K5a (the chunked causal aggregation) and K5b (its dk/dv backward) on
Hopper."""
from repro_torch.kernels.flow_chunk.bwd import (flow_chunk_dkv_parallel,
                                                flow_chunk_dkv_ref)
from repro_torch.kernels.flow_chunk.ops import (flow_chunk_call,
                                                flow_chunk_dkv_call)
from repro_torch.kernels.flow_chunk.ref import (flow_chunk_parallel,
                                                flow_chunk_ref)

__all__ = ["flow_chunk_call", "flow_chunk_dkv_call", "flow_chunk_dkv_parallel",
           "flow_chunk_dkv_ref", "flow_chunk_parallel", "flow_chunk_ref"]
