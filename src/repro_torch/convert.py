"""Carry index state across from the JAX package's arrays.

Both functions take plain numpy arrays (and ints), so nothing here imports
JAX: a caller converts a JAX object's fields with ``np.asarray`` first.

* :func:`image_from_arrays` builds the port's :class:`DeviceIndex` or
  :class:`DeltaIndex` on a device from an image's fields — the same images
  can then be fed to both packages' fused query ops;
* :func:`dynamic_index_from_arrays` rebuilds a port
  :class:`~repro_torch.core.index.DynamicIndex` from a dynamic index's
  state, so ``Engine(index=...)`` can adopt an index built elsewhere;
* :func:`twotower_from_jax` builds a port
  :class:`~repro_torch.models.recsys.TwoTower` holding the parameters of
  the reference's ``twotower_init`` pytree;
* :func:`recsys_from_jax` carries a recsys model's parameter tree (DLRM,
  SASRec, DIN or two-tower) across as the port's tree of tensors, and
  :func:`gnn_from_jax` SchNet's;
* :func:`lm_from_jax` builds a port :class:`~repro_torch.models.lm.LM`
  holding the parameters of the reference's LM ``init_params`` pytree
  (float32 or bfloat16 leaves);
* :func:`adamw_from_jax` builds a port
  :class:`~repro_torch.optim.adamw.AdamWState` holding the reference's
  ``adamw_init``/``adamw_update`` state (float32 or bfloat16 moments);
* :func:`static_from_jax` builds a port
  :class:`~repro_torch.core.static_index.StaticIndex` from the reference's
  ``StaticIndex.to_arrays()`` output: the same compressed streams, so the
  tier serves the same answers.  (Engine snapshots, ``core/persist.py``,
  are the other way state crosses: the format is shared.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import tree
from .core.device_index import DeltaIndex, DeviceIndex, resolve_device
from .core.index import DynamicIndex
from .core.static_index import StaticIndex
from .models.lm import LM, LMConfig
from .models.recsys import TwoTower, TwoTowerConfig
from .optim.adamw import AdamWState

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


def twotower_from_jax(params: dict, cfg: TwoTowerConfig,
                      device=None) -> TwoTower:
    """A :class:`TwoTower` computing what the reference's two-tower
    functions compute with ``params``: its ``twotower_init`` pytree with
    numpy arrays as leaves (``user_table``, ``item_table`` (rows, D), and
    ``user_tower``/``item_tower`` lists of ``{"w": (in, out), "b": (out,)}``).
    Each ``w`` becomes a ``Linear.weight`` (out, in).  ``device`` None
    means the card (see :func:`resolve_device`)."""
    return TwoTower(cfg, device=device,
                    params=recsys_from_jax(params, device))


def recsys_from_jax(params, device=None):
    """The port's parameter tree of a recsys model (DLRM, SASRec, DIN or
    two-tower) holding the reference's: its ``*_init`` pytree with numpy
    arrays as leaves (``jax.tree.map(np.asarray, params)``).  Lists stay
    lists and dicts keep their keys; each leaf becomes a float32 tensor
    (exact from float32 or bfloat16).  ``device`` None means the card (see
    :func:`resolve_device`)."""
    device = resolve_device(device)
    return tree.tree_map(
        lambda a: _leaf(a).to(device=device, dtype=torch.float32), params)


def gnn_from_jax(params: dict, device=None) -> dict:
    """The port's SchNet parameter tree holding the reference's: its
    ``init_params`` pytree with numpy arrays as leaves (``embed_in``,
    ``read1``, ``read2`` and ``inter``, whose leaves are stacked on a
    leading axis even for one interaction).  Each leaf becomes a tensor of
    its dtype on ``device`` (None means the card, see
    :func:`resolve_device`)."""
    device = resolve_device(device)
    return tree.tree_map(lambda a: _leaf(a).to(device), params)


def _leaf(a) -> torch.Tensor:
    """A tensor of a numpy leaf.  ``np.asarray`` of a bfloat16 JAX array is
    an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects: its
    bits are read as uint16 and reinterpreted.  A read-only or
    non-contiguous array (``np.asarray`` of a JAX array is read-only) is
    copied first; a 0-d array stays 0-d."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()            # C order; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_from_jax(params: dict, cfg: LMConfig, device=None) -> LM:
    """An :class:`LM` computing what the reference's LM functions compute
    with ``params``: its ``init_params`` pytree with numpy arrays as leaves
    (``jax.tree.map(np.asarray, params)``), laid out as the port's
    :func:`~repro_torch.models.lm.param_shapes` (the same layout).  Leaves
    are cast to ``cfg.dtype`` (exact where they have it already).
    ``device`` None means the card (see :func:`resolve_device`)."""
    device = resolve_device(device)

    def put(a):
        return _leaf(a).to(device=device, dtype=cfg.dtype)

    return LM(cfg, device=device, params={
        "embed": put(params["embed"]),
        "layers": {n: put(w) for n, w in params["layers"].items()},
        "ln_f": put(params["ln_f"]),
        "out_proj": put(params["out_proj"])})


def adamw_from_jax(state, device=None) -> AdamWState:
    """The port's AdamW state holding the reference's: its ``AdamWState``
    with numpy arrays as leaves (``jax.tree.map(np.asarray, state)``).
    The moments keep their dtype (bfloat16 bits read by :func:`_leaf`) and
    their tree (dicts with their keys, lists, anything :mod:`.tree` walks);
    the step is a 0-d int32 tensor.  ``device`` None means the card (see
    :func:`resolve_device`)."""
    device = resolve_device(device)

    def put(a):
        return _leaf(a).to(device)

    return AdamWState(step=put(np.asarray(state.step, np.int32)),
                      mu=tree.tree_map(put, state.mu),
                      nu=tree.tree_map(put, state.nu))


def static_from_jax(meta: dict, arrays: dict) -> StaticIndex:
    """The port's :class:`StaticIndex` holding a static tier's streams:
    ``(meta, arrays)`` as the reference's ``StaticIndex.to_arrays()``
    returns them (plain numpy arrays and scalars).  The codec words keep
    their dtypes (``uint32`` words, ``int64`` counts and offsets), so the
    result's own ``to_arrays()`` gives the same bytes back."""
    return StaticIndex.from_arrays(dict(meta), {
        name: np.asarray(a) for name, a in arrays.items()})
