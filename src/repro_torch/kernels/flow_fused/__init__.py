"""K1 (strict-causal Flow-Attention forward) and K2 (its backward) on Hopper."""
from repro_torch.kernels.flow_fused.bwd import flow_fused_bwd_call
from repro_torch.kernels.flow_fused.ops import flow_fused_call, flow_fused_forward
from repro_torch.kernels.flow_fused.ref import (flow_fused_bwd_parallel,
                                                flow_fused_bwd_ref,
                                                flow_fused_parallel,
                                                flow_fused_ref)

__all__ = ["flow_fused_bwd_call", "flow_fused_bwd_parallel",
           "flow_fused_bwd_ref", "flow_fused_call", "flow_fused_forward",
           "flow_fused_parallel", "flow_fused_ref"]
