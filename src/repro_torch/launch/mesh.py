"""Device meshes over ``torch.distributed``, and a launcher for their ranks.

The reference builds its meshes with ``jax.make_mesh``; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group.  Single pod: (16, 16) = 256 ranks, axes
("data", "model").  Multi-pod: (2, 16, 16) = 512 ranks with a leading
"pod" axis.  Functions, not module constants, so importing this module
touches no process group.

A mesh's device type follows the group's backend: "cuda" for NCCL, whose
collectives take CUDA tensors, and "cpu" for gloo, whose collectives here
take host tensors (the ranks may still compute on a card).

:func:`launch` starts the ranks of one world as spawned processes.  Each
rank joins the process group through a ``file://`` store in a directory
the caller gives (no TCP port, so concurrent worlds cannot collide), with
the backend the caller names and a timeout of 60 s, and leaves it on
every exit path.  A rank that raises or dies makes :func:`launch`
raise; the others are stopped, and none is left running.
"""

from __future__ import annotations

import pickle
import shutil
import time
import uuid
from datetime import timedelta
from pathlib import Path

import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

#: collective backend -> the device type of its meshes' tensors
BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}
#: every collective of a :func:`launch` world must end within this, s
PG_TIMEOUT_S = 60.0


def mesh_device_type() -> str:
    """The device type of meshes over the default process group."""
    backend = dist.get_backend()
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"no mesh device type for backend {backend!r}")
    return BACKEND_DEVICE[backend]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """A ("data", "model") mesh over every rank of the process group
    (tests, one-host runs)."""
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(mesh_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))


def _rank_main(rank: int, fn, world_size: int, backend: str, store: str,
               out_dir: str, args: tuple) -> None:
    dist.init_process_group(backend=backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def launch(fn, world_size: int, *, backend: str, store_dir, args=(),
           deadline_s: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    in one process group; return each rank's result, by rank.

    ``fn`` and ``args`` are pickled by reference, so ``fn`` is a
    module-level function; keep ``args`` small (a path to the data, not
    the data): a rank that dies while it starts would leave this process
    blocked writing a large pickle to it.  ``backend`` ("gloo" or "nccl")
    is used as given.  :data:`PG_TIMEOUT_S` bounds every collective; the
    whole world must end within ``deadline_s`` or its ranks are killed and
    :class:`TimeoutError` is raised.  A rank that raises makes this raise
    with its traceback (``torch.multiprocessing.ProcessRaisedException``).
    """
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend must be one of {sorted(BACKEND_DEVICE)}, "
                         f"not {backend!r}")
    run = Path(store_dir) / f"world-{uuid.uuid4().hex}"
    run.mkdir(parents=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, str(run / "store"),
                          str(run), tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    try:
        end = time.monotonic() + deadline_s
        while not ctx.join(timeout=max(0.0, min(1.0,
                                                end - time.monotonic()))):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world_size} ranks did not end within "
                                   f"{deadline_s} s")
        out = []
        for r in range(world_size):
            with open(run / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(run, ignore_errors=True)
