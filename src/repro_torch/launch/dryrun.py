"""Multi-pod dry run: trace one rank's share of every (arch × shape × mesh)
cell on a fake world of 256 or 512 ranks.

The counterpart of the JAX package's ``src/repro/launch/dryrun.py``, which
lowers and compiles each cell on 512 fake host devices and reads XLA's
memory and cost analyses.  Here the cell (``configs.common``'s ``build``)
runs eagerly on rank 0 of a fake process group (``launch.mesh.fake_world``,
torch's ``FakeProcessGroup``, whose collectives move no data) over the
reference's production meshes, its arguments DTensors whose local shards
are ``FakeTensor``s: no byte of the full-size state is allocated.  A
dispatch mode (:class:`Tracer`) sees every op on the local shards, so the
counts are **per rank**:

* ``hlo_flops``: the matmul-class flops of the local ops, as
  ``torch.utils.flop_counter`` counts them (products, convolutions,
  attention; no elementwise work, which XLA's figure includes).  A
  ``FlopCounterMode`` around DTensor code would count the global op.
* ``hlo_bytes``: the bytes each local op reads and writes (its tensor
  inputs and outputs), unfused; views, allocations and waits move none.
* ``collectives``: the result bytes of every collective DTensor or the
  code issues (``_c10d_functional`` and ``c10d`` ops), by op, and the
  per-rank link bytes under the reference's ring factors
  (:data:`_COLL_FACTOR`).
* ``memory``: ``argument_bytes`` the local shards of the arguments;
  ``output_bytes`` the distinct storages of the outputs; ``temp_bytes``
  the peak of live local bytes less the arguments (storages are tracked
  from the op that makes them to their release, a CUDA allocation
  counted as the caching allocator counts a fresh one,
  :func:`cuda_block_bytes`); ``alias_bytes`` the
  donated arguments updated in place and returned;
  ``generated_code_bytes`` 0.

The trace is eager: every layer, chunk and microbatch runs, where XLA
counts a while body once and the reference's reader multiplies by
``cost_scale``.  Records carry ``whole_step: true`` so that a reader does
not.  What this cannot measure: fusion (each op's bytes are counted as if
it ran alone), the caching allocator's reuse of cached blocks larger than
a request and its fragmentation (each allocation is counted as a fresh
one), workspaces outside the allocator, and the time of any link.  ``lower_s`` is the build of the cell and its fake arguments,
``compile_s`` is 0 (nothing compiles) and ``trace_s`` the traced step.

Ops without a sharded formulation that the models gather whole
(``distributed.sharding.replicate``) are named in the record's ``notes``
after the cell's own.

Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (never
the reference's ``results/dryrun/``); a rerun skips an existing cell
unless ``--force``.  Usage (on the CPU here; the default device is the
card's, ``cuda``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch llama3.2-3b --shape train_4k --probe
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both

Exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import tree
from ..configs import ARCH_IDS, get_arch
from ..distributed.sharding import contiguous_stride, record_redistributes
from .mesh import fake_world, make_production_mesh

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results"
                  / "dryrun_torch")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

# per-chip link-traffic multiplier on the op's result bytes (ring algorithms)
_COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

#: collective op names (``torch.ops`` namespace ``_c10d_functional``,
#: ``c10d`` or ``_dtensor``, without the overload) -> the reference's name
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_":
    "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d", "_dtensor")
#: ops that move no bytes: allocations without a fill, waits
_NO_BYTES = {"empty", "empty_strided", "empty_like", "wait_tensor",
             "barrier", "device", "lift_fresh", "detach", "alias",
             "_to_copy_meta", "sym_size", "sym_stride", "sym_numel"}
_MIB = 1 << 20


def cuda_block_bytes(n: int) -> int:
    """The bytes PyTorch's CUDA caching allocator counts as allocated for
    a fresh request of ``n`` bytes (its default settings): 512 B
    rounding; up to 1 MiB from 2 MiB segments, below 10 MiB from 20 MiB
    ones, both split to the request; from 10 MiB a segment of the request
    rounded up to 2 MiB, kept whole when what would be left over is 1 MiB
    or less (it is split only when more would be left)."""
    if n <= 0:
        return 0
    n = -(-n // 512) * 512
    if n < 10 * _MIB:
        return n
    seg = -(-n // (2 * _MIB)) * 2 * _MIB
    return seg if seg - n <= _MIB else n
#: what stands in for each of the reference's HLO figures
COUNTED_BY = {
    "hlo_flops": "torch.utils.flop_counter formulas (matmul-class ops) "
                 "over the local ops of one rank",
    "hlo_bytes": "bytes read and written by each local op, unfused",
    "collectives": "result bytes of each _c10d_functional/c10d collective "
                   "issued on the fake process group, x _COLL_FACTOR",
    "memory": "local shards of the arguments and outputs; peak of live "
              "local storages (CUDA sizes as the caching allocator counts "
              "a fresh allocation) less the arguments; donated arguments "
              "returned in place",
}


def collective_bytes(records) -> dict:
    """Sum the result bytes of collectives recorded as ``(op, bytes)``
    pairs (the reference's names); returns {"by_op": {...},
    "link_bytes": weighted per-chip traffic}, as the reference's
    ``collective_bytes`` does for an HLO text."""
    by_op: dict[str, float] = {}
    link = 0.0
    for op, b in records:
        by_op[op] = by_op.get(op, 0.0) + b
        link += _COLL_FACTOR[op] * b
    return {"by_op": by_op, "link_bytes": link}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """Whether DTensor is running an op on global fake tensors to learn an
    output's shape (not part of the rank's work)."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class Tracer(TorchDispatchMode):
    """Counts one rank's local ops: flops, bytes, collectives and live
    storage bytes (see the module's docstring).  DTensor ops are left to
    DTensor (``NotImplemented``), which then runs the local ops through
    this mode."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.colls: list[tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}     # id(storage) -> bytes

    @staticmethod
    def storage_bytes(t: torch.Tensor) -> int:
        """The bytes of ``t``'s storage as its device allocates them (a
        fake tensor's storage is on ``meta``: the tensor names the
        device)."""
        n = t.untyped_storage().nbytes()
        return cuda_block_bytes(n) if t.device.type == "cuda" else n

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is released."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = self.storage_bytes(t)
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_sharding_propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in _COLL_NAMESPACES:
            kind = _COLL_OPS.get(op)
            if kind is not None:
                self.colls.append((kind, sum(_nbytes(t)
                                             for t in _tensors(out))))
        elif op not in _NO_BYTES and not func.is_view:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            ins = {id(t): t for t in _tensors((args, kwargs))}
            outs = {id(t): t for t in _tensors(out)}
            self.bytes += sum(_nbytes(t) for t in ins.values())
            self.bytes += sum(_nbytes(t) for t in outs.values())
        for t in _tensors(out):
            self.track(t)
        return out


def _locals(x) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree.leaves(x)]


def fake_arguments(cell, mesh, fake_mode, device: str) -> tuple:
    """The cell's arguments as DTensors laid out by its ``in_shardings``,
    each local shard an uninitialised ``FakeTensor`` on ``device``."""
    out = []
    for arg, pls in zip(cell.args, cell.in_shardings):
        flat, treedef = tree.flatten(arg)
        made = []
        for leaf, pl in zip(flat, pls):
            local, _ = compute_local_shape_and_global_offset(
                leaf.shape, mesh, pl)
            with fake_mode:
                loc = torch.empty(local, dtype=leaf.dtype, device=device)
            made.append(DTensor.from_local(
                loc, mesh, pl, run_check=False, shape=leaf.shape,
                stride=contiguous_stride(leaf.shape)))
        out.append(tree.unflatten(treedef, made))
    return tuple(out)


def _index_call(cell, mesh, fake_mode, device: str):
    """paper_index's cell (``IndexCell``: the rank's step and the stacked
    inputs) as (fn, args): this rank's shard of the stacked index (its
    blocks, per-term arrays and offset) and the whole query batch, decoded
    by the plain decode (a fake tensor launches no kernel)."""
    from ..core.device_index import DeviceIndex
    step = cell.fn
    blocks, *per_term, offsets, qterms, qmask = cell.args
    n = step.num_shards
    with fake_mode:
        def part(t):
            return torch.empty((t.shape[0] // n, *t.shape[1:]),
                               dtype=t.dtype, device=device)
        shard = (part(blocks), *(part(t) for t in per_term))
        q = torch.empty(qterms.shape, dtype=qterms.dtype, device=device)
        m = torch.empty(qmask.shape, dtype=qmask.dtype, device=device)

    def run(shard_, qt, qm):
        img = DeviceIndex(*shard_, num_docs=step.num_docs, F=step.F)
        return step(img, 0, qt, qm)

    return run, (shard, q, m)


def trace_cell(cell, mesh, device: str) -> dict:
    """Run ``cell`` on fake tensors under :class:`Tracer`; the counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    try:    # fake-tensor kernels of the c10d collectives (newer torch)
        import torch.distributed._tools.fake_collectives  # noqa: F401
    except ImportError:
        pass
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.perf_counter()
    if hasattr(cell, "in_shardings"):
        fn, args = cell.fn, fake_arguments(cell, mesh, fake_mode, device)
        donated = cell.donate_argnums
    else:
        fn, args = _index_call(cell, mesh, fake_mode, device)
        donated = ()
    lower_s = time.perf_counter() - t0
    tracer = Tracer()
    arg_locals = _locals(args)
    arg_storages = {id(t.untyped_storage()): i
                    for i, a in enumerate(args) for t in _locals(a)}
    t1 = time.perf_counter()
    with fake_mode, record_redistributes() as notes, tracer:
        for t in arg_locals:
            tracer.track(t)
        argument_bytes = tracer.live
        tracer.peak = tracer.live
        out = fn(*args)
    trace_s = time.perf_counter() - t1
    outs, seen = 0, set()
    alias = 0
    for t in _locals(out):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        n = tracer.storage_bytes(t)
        outs += n
        if arg_storages.get(id(st), -1) in donated:
            alias += n
    return dict(
        hlo_flops=float(tracer.flops), hlo_bytes=float(tracer.bytes),
        collectives=collective_bytes(tracer.colls),
        memory=dict(argument_bytes=int(argument_bytes),
                    output_bytes=int(outs),
                    temp_bytes=int(tracer.peak - argument_bytes),
                    generated_code_bytes=0, alias_bytes=int(alias)),
        redistributes=list(notes), lower_s=lower_s, trace_s=trace_s)


def build_cell(arch_id: str, shape_id: str, mesh, probe_layers=None):
    """``ARCH.build`` of the cell; paper_index's step decodes with the
    plain decode (a fake tensor launches no kernel)."""
    arch = get_arch(arch_id)
    if arch.family == "index":
        from ..core.device_index import decode_blocks
        return arch.build(mesh, shape_id, decode_fn=decode_blocks)
    if probe_layers is not None:
        return arch.build(mesh, shape_id, probe_layers=probe_layers)
    return arch.build(mesh, shape_id)


def run_cell(arch_id: str, shape_id: str, mesh_kind: str,
             out_dir: str = RESULTS_DIR, force: bool = False,
             verbose: bool = True, probe_layers: int | None = None,
             device: str = "cuda") -> dict:
    """Trace one cell on a fake world of 256 ranks (``mesh_kind``
    "single", the (16, 16) mesh) or 512 ("multi", (2, 16, 16)) and write
    its record; probe cells (LM only) run ``probe_layers`` layers on the
    single-pod mesh.  An existing record is returned unless ``force``."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch_id.replace('/', '_')}__{shape_id}__{mesh_kind}"
    if probe_layers is not None:
        tag = f"{arch_id.replace('/', '_')}__{shape_id}__probe{probe_layers}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.perf_counter()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
           "probe_layers": probe_layers, "device": device, "status": "error"}
    try:
        multi = mesh_kind == "multi"
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type=device)
            cell = build_cell(arch_id, shape_id, mesh, probe_layers)
            t_build = time.perf_counter() - t0
            got = trace_cell(cell, mesh, device)
        notes = cell.notes
        if got["redistributes"]:
            notes = "; ".join(([notes] if notes else [])
                              + ["gathered whole: " + n
                                 for n in got["redistributes"]])
        rec.update(
            status="ok", kind=cell.kind, chips=int(mesh.size()),
            model_flops=cell.model_flops,
            cost_scale=getattr(cell, "cost_scale", 1.0),
            hlo_flops=got["hlo_flops"], hlo_bytes=got["hlo_bytes"],
            collectives=got["collectives"], memory=got["memory"],
            lower_s=round(t_build + got["lower_s"], 2), compile_s=0.0,
            trace_s=round(got["trace_s"], 2), notes=notes,
            counted_by=COUNTED_BY, whole_step=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        status = rec["status"]
        extra = (f"flops={rec.get('hlo_flops', 0):.3e} "
                 f"temp={rec.get('memory', {}).get('temp_bytes', 0)/2**30:.2f}"
                 f"GiB" if status == "ok" else rec.get("error", ""))
        print(f"[dryrun] {tag}: {status} ({time.perf_counter()-t0:.1f}s) "
              f"{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="trace the LM probe cells (L=1, 2) instead")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda needs a card)")
    args = ap.parse_args(argv)
    arch_ids = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        shapes = list(arch.shapes) if args.shape == "all" else [args.shape]
        for shape_id in shapes:
            if args.probe:
                if arch.family != "lm":
                    continue  # non-LM cells run every op already
                for pl in (1, 2):
                    rec = run_cell(arch_id, shape_id, "single",
                                   out_dir=args.out, force=args.force,
                                   probe_layers=pl, device=args.device)
                    failures += rec["status"] != "ok"
                continue
            for mesh_kind in meshes:
                rec = run_cell(arch_id, shape_id, mesh_kind,
                               out_dir=args.out, force=args.force,
                               device=args.device)
                failures += rec["status"] != "ok"
    print(f"[dryrun] done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
