"""Device meshes over ``torch.distributed``, and a launcher for their ranks.

The reference builds its meshes with ``jax.make_mesh``; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group.  Single pod: (16, 16) = 256 ranks, axes
("data", "model").  Multi-pod: (2, 16, 16) = 512 ranks with a leading
"pod" axis.  Functions, not module constants, so importing this module
touches no process group.

A mesh's device type follows the group's backend: "cuda" for NCCL, whose
collectives take CUDA tensors, and "cpu" for gloo, whose collectives here
take host tensors (the ranks may still compute on a card).  The fake
backend (:func:`fake_world`) carries no tensor, so its caller names the
device type: "cuda" unless "cpu" is asked for, and "cuda" raises where
torch has no CUDA.

:func:`fake_world` starts a process group of 256 or 512 ranks in this one
process, as rank 0, on torch's C++ ``FakeProcessGroup``, whose collectives
return at once without moving data: the dry run
(:mod:`repro_torch.launch.dryrun`) builds the reference's production
meshes on it and traces one rank's share of a step.  The backend is
registered here from ``torch._C._distributed_c10d.FakeProcessGroup``, the
class torch's own ``torch.testing._internal.distributed.fake_pg`` wraps:
that module belongs to torch's test suite, and registering the class takes
one call.

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
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

#: collective backend -> the device type of its meshes' tensors
BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}
#: every collective of a :func:`launch` world must end within this, s
PG_TIMEOUT_S = 60.0
#: the backend of :func:`fake_world`
FAKE_BACKEND = "fake"


def mesh_device_type(device_type: str | None = None) -> str:
    """The device type of meshes over the default process group.  On the
    fake backend it is ``device_type`` ("cuda" when None), and "cuda"
    raises where torch has no CUDA; on gloo or NCCL it is the backend's,
    and a ``device_type`` that differs raises."""
    backend = dist.get_backend()
    if backend == FAKE_BACKEND:
        dev = device_type or "cuda"
        if dev not in ("cuda", "cpu"):
            raise ValueError(f"device type {dev!r} is neither cuda nor cpu")
        if dev == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a fake world on cuda needs torch with CUDA; "
                               "ask for the CPU (device_type='cpu')")
        return dev
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"no mesh device type for backend {backend!r}")
    if device_type is not None and device_type != BACKEND_DEVICE[backend]:
        raise ValueError(f"a {backend} mesh is on {BACKEND_DEVICE[backend]}, "
                         f"not {device_type}")
    return BACKEND_DEVICE[backend]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The reference's (16, 16) ("data", "model") mesh, or (2, 16, 16)
    with a leading "pod" axis, over the default process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(device_type), shape,
                            mesh_dim_names=axes)


def _register_fake_backend() -> None:
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        rank, size = common_opts.group_rank, common_opts.group_size
        if hasattr(FakeProcessGroup, "_create_internal"):   # newer torch
            return FakeProcessGroup._create_internal(rank, size,
                                                     backend_opts)
        return FakeProcessGroup(rank, size)

    if FAKE_BACKEND not in dist.Backend._plugins:
        dist.Backend.register_backend(FAKE_BACKEND, create,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])


@contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, as
    rank 0, for the body of the ``with``; it is destroyed on every exit
    path.  Its collectives move no data: only shapes are meaningful."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    _register_fake_backend()
    dist.init_process_group(FAKE_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
