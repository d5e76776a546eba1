"""K10a (the SSD chunk scan) and K10b (its backward) on Hopper."""
from repro_torch.kernels.ssd_chunk.bwd import ssd_chunk_bwd_ref
from repro_torch.kernels.ssd_chunk.ops import (SSDChunkDot, ssd_chunk_bwd_call,
                                               ssd_chunk_call, ssd_scan)
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_chunked, ssd_chunk_ref

__all__ = ["SSDChunkDot", "ssd_chunk_bwd_call", "ssd_chunk_bwd_ref",
           "ssd_chunk_call", "ssd_chunk_chunked", "ssd_chunk_ref", "ssd_scan"]
