"""Double-VByte block-decode op (CUDA kernel + plain version)."""

from .ops import as_decode_fn, dvbyte_decode_blocks  # noqa: F401
