"""Fault-tolerant checkpointing (save/restore with atomic publish).

Ported from the JAX package's ``src/repro/checkpoint/manager.py``, with
its on-disk layout, so that each package restores the other's checkpoints:

  * **atomicity**: a checkpoint is staged under ``.tmp-<step>-<seq>`` and
    published as ``step-%010d`` with a single ``os.rename``, so a crash
    mid-save never corrupts the restore point;
  * **async save**: every leaf is copied to host memory on the caller's
    thread, before the writer thread starts, and only those copies go to
    the thread.  The train step updates its tensors in place, so the next
    step must not change what is being written, and no device tensor is
    handed to another thread;
  * **manifest**: ``manifest.json`` holds ``treedef`` (as
    ``str(jax.tree.structure(...))`` prints it), each leaf's ``shape`` and
    ``dtype``, and ``step``; leaf ``i`` is ``leaf-<i>.npy``, in JAX's
    flatten order (dict keys sorted, NamedTuple fields in order;
    :mod:`..tree`);
  * **bfloat16**: a bf16 leaf is written as its 2-byte payload under the
    header the reference's ``np.save`` writes for it (``'<V2'``), and the
    manifest says ``"bfloat16"``; :meth:`CheckpointManager.restore` reads
    the manifest and gives the leaf back as a bf16 tensor.  The
    reference's own restore returns such a leaf as a raw ``V2`` array,
    which JAX refuses, so it cannot resume a bf16 model; the port needs no
    ``ml_dtypes`` to read one;
  * **retention**: the newest ``keep`` checkpoints are kept, never the
    newest complete one deleted (``keep=0`` keeps the newest only), and
    staging directories orphaned by a crashed writer are swept at the next
    publish;
  * **restore**: ``latest_step()`` + ``restore(step, like=...)`` rebuilds
    the tree of ``like``, each leaf a tensor on the device of ``like``'s
    leaf (a numpy array where ``like``'s leaf is one); the trainer resumes
    from step + 1 and the deterministic data pipeline replays the right
    batch (``data/lm.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from .. import tree as tree_mod

_BF16 = "bfloat16"


def _to_host(x) -> tuple[np.ndarray, str]:
    """(a host copy of leaf ``x``, its manifest dtype).  A bf16 tensor's
    copy holds its bits as int16."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        a = t.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _save_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, a)
        return
    a = np.ascontiguousarray(a)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(a.tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._seq = 0  # per-save staging-dir discriminator

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = True) -> None:
        leaves, treedef = tree_mod.flatten(tree)
        host = [_to_host(x) for x in leaves]
        spec = {"treedef": tree_mod.treedef_str(treedef),
                "leaves": [{"shape": list(a.shape), "dtype": dt}
                           for a, dt in host],
                "step": step}
        # An in-flight async save must finish before the next save stages:
        # otherwise two threads race in the staging area and the publish
        # order (newest wins) is undefined.  The staging dir is additionally
        # unique per save within this process; cross-process leftovers are
        # swept by _gc at the next publish.
        self.wait()
        self._seq += 1
        tmp = os.path.join(self.dir, f".tmp-{step}-{self._seq}")

        def work():
            final = os.path.join(self.dir, f"step-{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (a, dt) in enumerate(host):
                _save_leaf(os.path.join(tmp, f"leaf-{i}.npy"), a, dt)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(spec, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        # the newest complete checkpoint is never deleted, even at keep=0
        steps = self.all_steps()
        drop = steps[:-self.keep] if self.keep > 0 else steps[:-1]
        for s in drop:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:010d}"),
                          ignore_errors=True)
        # sweep staging dirs orphaned by a crashed predecessor.  Running
        # here (we just published, so we are the directory's single writer
        # and saves are serialized through wait(), leaving no live staging
        # of our own) rather than in __init__ keeps restore-only instances
        # from ever deleting an active writer's in-flight staging dir.
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like=None):
        """Rebuild the tree saved at ``step``.

        ``like`` (an example tree) supplies the structure; leaves are loaded
        in flatten order, each as a tensor on the device of ``like``'s leaf,
        or as a numpy array where ``like``'s leaf is not a tensor.  Without
        ``like`` a flat list of CPU tensors is returned."""
        path = os.path.join(self.dir, f"step-{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            spec = json.load(f)
        leaves = [_load_leaf(os.path.join(path, f"leaf-{i}.npy"),
                             leaf["dtype"])
                  for i, leaf in enumerate(spec["leaves"])]
        if like is None:
            return leaves
        like_leaves, treedef = tree_mod.flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint at step {step} holds "
                             f"{len(leaves)} leaves, like has "
                             f"{len(like_leaves)}")
        return tree_mod.unflatten(treedef, [
            t.to(ref.device) if isinstance(ref, torch.Tensor) else t.numpy()
            for t, ref in zip(leaves, like_leaves)])
