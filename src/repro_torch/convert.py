"""Carry index state across from the JAX package's arrays.

Both functions take plain numpy arrays (and ints), so nothing here imports
JAX: a caller converts a JAX object's fields with ``np.asarray`` first.

* :func:`image_from_arrays` builds the port's :class:`DeviceIndex` or
  :class:`DeltaIndex` on a device from an image's fields — the same images
  can then be fed to both packages' fused query ops;
* :func:`dynamic_index_from_arrays` rebuilds a port
  :class:`~repro_torch.core.index.DynamicIndex` from a dynamic index's
  state, so ``Engine(index=...)`` can adopt an index built elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device_index import DeltaIndex, DeviceIndex, resolve_device
from .core.index import DynamicIndex

_IMAGE_FIELDS = ("blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
                 "term_ft")
_DELTA_FIELDS = ("term_lastd0", "term_dnum0")


def image_from_arrays(arrays: dict, *, num_docs: int, F: int,
                      device=None) -> DeviceIndex | DeltaIndex:
    """A device image from its fields as numpy arrays.

    ``arrays`` maps field names (``blocks``, ``term_slot``, ``term_nblk``,
    ``term_skip``, ``term_nx``, ``term_ft`` and, for a delta image,
    ``term_lastd0`` and ``term_dnum0``) to arrays; the result is a
    :class:`DeltaIndex` exactly when the delta fields are present.
    ``device`` None means the card (see :func:`resolve_device`).
    """
    device = resolve_device(device)

    def put(name):
        a = np.array(arrays[name],
                     dtype=np.uint8 if name == "blocks" else np.int32)
        return torch.from_numpy(a).to(device)

    fields = {n: put(n) for n in _IMAGE_FIELDS}
    if all(n in arrays for n in _DELTA_FIELDS):
        fields.update({n: put(n) for n in _DELTA_FIELDS})
        return DeltaIndex(**fields, num_docs=num_docs, F=F)
    return DeviceIndex(**fields, num_docs=num_docs, F=F)


def dynamic_index_from_arrays(*, I: np.ndarray, nblocks: int,
                              hash: np.ndarray, vocab_size: int,
                              num_docs: int, num_postings: int,
                              num_words: int, tombstones=(), B: int = 64,
                              growth: str = "const", F: int | None = None,
                              word_level: bool = False,
                              expon_k: float = 1.1) -> DynamicIndex:
    """A port :class:`DynamicIndex` holding exactly the given state: the
    block array ``store.I`` (its first ``nblocks`` slots), the vocabulary
    hash array, the counters and the tombstone set, plus the constructor
    arguments that fix the layout."""
    idx = DynamicIndex(B=B, growth=growth, F=F, word_level=word_level,
                       expon_k=expon_k)
    store = idx.store
    used = np.asarray(I, dtype=np.uint8)[: nblocks * B]
    store.I = np.zeros(max(len(store.I), len(used)), np.uint8)
    store.I[: len(used)] = used
    store.nblocks = int(nblocks)
    idx.hash = np.asarray(hash, dtype=np.uint32).copy()
    idx.vocab_size = int(vocab_size)
    idx.num_docs = int(num_docs)
    idx.num_postings = int(num_postings)
    idx.num_words = int(num_words)
    idx.tombstones = set(int(d) for d in tombstones)
    return idx
