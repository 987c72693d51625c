"""Public entry point of the Double-VByte block-decode op.

:func:`dvbyte_decode_blocks` decodes a batch of B-byte blocks: CUDA tensors
launch the kernel (``kernel.py``) and raise if it cannot run; CPU tensors
run the plain version (``ref.py``).  It has the ``decode_fn(blocks, start,
end, F)`` signature of ``core.device_index.query_step``, which calls it
when no other ``decode_fn`` is given; :func:`as_decode_fn` returns it for a
caller that wants to pass it explicitly (``Engine(decode_fn=...)``).
"""

from __future__ import annotations

import torch

from .kernel import dvbyte_decode_kernel
from .ref import decode_blocks


def dvbyte_decode_blocks(blocks: torch.Tensor, start: torch.Tensor,
                         end: torch.Tensor, F: int = 4):
    """(NB, B) uint8 blocks with [start, end) payload bounds → (g, f,
    valid), each (NB, B), zero wherever ``valid`` is False."""
    if blocks.is_cuda:
        return dvbyte_decode_kernel(blocks, start.to(torch.int32),
                                    end.to(torch.int32), F)
    return decode_blocks(blocks, start, end, F)


def as_decode_fn():
    """The op as a ``decode_fn(blocks, start, end, F)`` for ``query_step``."""
    return dvbyte_decode_blocks


from .. import registry  # noqa: E402

registry.register(registry.KernelSpec(
    name="dvbyte_decode", fn=dvbyte_decode_blocks,
    modes=("conjunctive", "ranked_tfidf", "bm25"),
    description="Double-VByte block decode, one CUDA thread per block with "
                "coalesced staging; the decode_fn of query_step"))
