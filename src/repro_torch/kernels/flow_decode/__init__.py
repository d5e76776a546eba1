"""K3 and K4: one batched Flow-Attention decode step, in place, on Hopper,
on an fp32 FlowState pool (K3) or an int8 one (K4)."""
from repro_torch.kernels.flow_decode.ops import (flow_decode_call,
                                                 flow_decode_q_step,
                                                 flow_decode_step)
from repro_torch.kernels.flow_decode.quant import flow_decode_q_call
from repro_torch.kernels.flow_decode.ref import (flow_decode_q_ref,
                                                 flow_decode_q_split,
                                                 flow_decode_ref,
                                                 flow_decode_split)

__all__ = ["flow_decode_call", "flow_decode_q_call", "flow_decode_q_ref",
           "flow_decode_q_split", "flow_decode_q_step", "flow_decode_ref",
           "flow_decode_split", "flow_decode_step"]
