"""Plain PyTorch version of the Double-VByte block-decode kernel.

This re-exports the device path's plain decode,
``repro_torch.core.device_index.decode_blocks``: the CUDA kernel
(``csrc/dvbyte_decode.cu``) must produce bit-identical (g, f, valid)
triples for any block content the block store can emit.
"""

from ...core.device_index import decode_blocks

__all__ = ["decode_blocks"]
