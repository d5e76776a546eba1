"""K6 (the whole non-causal Flow-Attention pair), K7a (its sink side) and
K7b (K7a's backward) on Hopper."""
from repro_torch.kernels.flow_nc.ops import (flow_attention_nc,
                                             flow_nc_fused_call,
                                             flow_nc_qside_bwd_call,
                                             flow_nc_qside_call)
from repro_torch.kernels.flow_nc.ref import (flow_nc_fused_parallel,
                                             flow_nc_fused_ref,
                                             flow_nc_qside_bwd_parallel,
                                             flow_nc_qside_bwd_ref,
                                             flow_nc_qside_ref)

__all__ = ["flow_attention_nc", "flow_nc_fused_call",
           "flow_nc_fused_parallel", "flow_nc_fused_ref",
           "flow_nc_qside_bwd_call", "flow_nc_qside_bwd_parallel",
           "flow_nc_qside_bwd_ref",
           "flow_nc_qside_call", "flow_nc_qside_ref"]
