"""K3: one batched Flow-Attention decode step, in place, on Hopper."""
from repro_torch.kernels.flow_decode.ops import flow_decode_call, flow_decode_step
from repro_torch.kernels.flow_decode.ref import flow_decode_ref

__all__ = ["flow_decode_call", "flow_decode_ref", "flow_decode_step"]
