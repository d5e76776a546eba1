"""K1: strict-causal Flow-Attention forward (packed prefill) on Hopper."""
from repro_torch.kernels.flow_fused.ops import flow_fused_call, flow_fused_forward
from repro_torch.kernels.flow_fused.ref import flow_fused_ref

__all__ = ["flow_fused_call", "flow_fused_forward", "flow_fused_ref"]
