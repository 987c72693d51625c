"""The port's device-mesh query step against the JAX package's.

The reference's jitted ``shard_map`` step runs in a subprocess with eight
forced host devices, as ``tests/test_sharded_index.py`` runs it, and writes
its answers to an ``.npz``.  The port's ``make_sharded_query_step`` runs on
a gloo world of eight spawned CPU processes, a (data 4, model 2) mesh,
through ``repro_torch.launch.launch``.  Both read one seeded stream of
term ids.  This file holds the data, the reference's script and the
comparisons for ``test_torch_mesh_unequal.py``,
``test_torch_mesh_pod.py`` and ``test_torch_mesh_config.py`` too; each
file runs its own worlds, so pytest-xdist workers run them side by side.

Cases here: four equal shards with shard-local statistics in ``ranked``,
``ranked_sparse`` and ``conjunctive`` (bitmaps in the reference's tiled
layout and the summed counts); each rank's own model slice;
``stack_images`` and ``shard_doc_offsets``; ``sharded_query_plain``
against the distributed step; and the launcher's failure paths.  Docids
and bitmaps are equal, f32 scores within rtol 1e-6 (the reference's
``ranked_sparse`` within its own rounding, :func:`sparse_atol`).

Every world has the 60 s process-group timeout and a deadline, and the
reference's subprocess a timeout, so a hang fails the tests instead of
stalling the run.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from repro_torch.core.collate import collate
from repro_torch.core.device_index import (build_device_image, query_step,
                                           with_global_stats)
from repro_torch.core.index import DynamicIndex
from repro_torch.core.sharded_index import (make_sharded_query_step,
                                            shard_doc_offsets,
                                            sharded_query_plain,
                                            stack_images, stacked_shard)
from repro_torch.launch import launch, make_host_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
VOCAB = [f"w{i}" for i in range(120)]
#: the reduced build's vocabulary: VOCAB padded to 128 terms
PAD_VOCAB = VOCAB + [f"pad{i}" for i in range(8)]
MODES = ("ranked", "ranked_sparse", "conjunctive")
REDUCED = {
    "query_rank": dict(shard_blocks=512, vocab=128, docs=256, qbatch=8,
                       qterms=4, max_blocks=2),
    "query_conj": dict(shard_blocks=512, vocab=128, docs=256, qbatch=8,
                       qterms=4, max_blocks=2, mode="conjunctive"),
}
DEADLINE_S = 300


def make_data() -> dict:
    """Two seeded streams of term ids: four equal shards of 150 documents
    (shard-local statistics, N = 150) and the unequal sizes [150, 90, 140,
    60] (global statistics, N = 440), each with 8 queries."""
    probs = 1.0 / np.arange(1, 121) ** 1.07
    probs /= probs.sum()

    def case(seed, sizes, hi, T, pool, glob):
        rng = np.random.default_rng(seed)
        docs = [[rng.choice(120, size=int(rng.integers(8, hi)),
                            p=probs).tolist() for _ in range(n)]
                for n in sizes]
        qt = np.zeros((8, T), np.int32)
        qm = np.zeros((8, T), bool)
        for q in range(8):
            terms = rng.choice(pool, size=int(rng.integers(1, T + 1)),
                               replace=False)
            qt[q, :len(terms)] = terms
            qm[q, :len(terms)] = True
        return dict(docs=docs, qt=qt.tolist(), qm=qm.tolist(),
                    num_docs=sum(sizes) if glob else sizes[0],
                    glob=glob)

    return dict(eq=case(7, [150] * 4, 80, 4, 60, False),
                uneq=case(11, [150, 90, 140, 60], 60, 3, 50, True))


def port_images(case: dict, vocab=VOCAB, pad_blocks=None) -> list:
    ims = []
    for docs in case["docs"]:
        idx = DynamicIndex(B=64, growth="const")
        for d in docs:
            idx.add_document([VOCAB[i] for i in d])
        ims.append(build_device_image(collate(idx),
                                      [t.encode() for t in vocab],
                                      pad_blocks=pad_blocks, device="cpu"))
    if case["glob"]:
        gft = np.stack([im.term_ft.numpy() for im in ims]).sum(axis=0)
        ims = [with_global_stats(im, gft, im.num_docs) for im in ims]
    return ims


def max_blocks(ims) -> int:
    return int(max(int(im.term_nblk.max()) for im in ims))


def queries(case: dict):
    return (torch.tensor(case["qt"], dtype=torch.int32),
            torch.tensor(case["qm"], dtype=torch.bool))


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    from unittest import mock
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import paper_index
    from repro.core.collate import collate
    from repro.core.device_index import build_device_image, with_global_stats
    from repro.core.index import DynamicIndex
    from repro.core.sharded_index import (make_sharded_query_step,
                                          shard_doc_offsets,
                                          sharded_input_specs, stack_images)
    from repro.launch import mesh as jmesh

    data = json.load(open(sys.argv[1]))
    part = sys.argv[3]
    VOCAB, PAD_VOCAB, REDUCED = data["vocab"], data["pad_vocab"], \\
        data["reduced"]
    out = {}

    def images(case, vocab=VOCAB, pad_blocks=None):
        ims = []
        for docs in case["docs"]:
            idx = DynamicIndex(B=64, growth="const")
            for d in docs:
                idx.add_document([VOCAB[i] for i in d])
            ims.append(build_device_image(collate(idx),
                                          [t.encode() for t in vocab],
                                          pad_blocks=pad_blocks))
        if case["glob"]:
            gft = np.stack([np.asarray(im.term_ft) for im in ims]).sum(0)
            ims = [with_global_stats(im, gft, im.num_docs) for im in ims]
        return ims

    def run(mesh, fn, ins, outs, img, offs, case):
        jf = jax.jit(fn, in_shardings=ins, out_shardings=outs)
        with mesh:
            a, b = jf(img.blocks, img.term_slot, img.term_nblk,
                      img.term_skip, img.term_nx, img.term_ft, offs,
                      jnp.asarray(np.array(case["qt"], np.int32)),
                      jnp.asarray(np.array(case["qm"], bool)))
        return np.asarray(a), np.asarray(b)

    def steps(cname, mname, mesh):
        case = data[cname]
        ims = images(case)
        img, offs = stack_images(ims), shard_doc_offsets(ims)
        mb = int(max(int(im.term_nblk.max()) for im in ims))
        for mode in ("ranked", "ranked_sparse", "conjunctive"):
            fn, ins, outs = make_sharded_query_step(
                mesh, k=10, max_blocks=mb, num_docs=case["num_docs"],
                mode=mode)
            a, b = run(mesh, fn, ins, outs, img, offs, case)
            out[f"{cname}__{mname}__{mode}__a"] = a
            out[f"{cname}__{mname}__{mode}__b"] = b
        return img, offs

    devs = jax.devices()
    if part in ("eq", "uneq"):
        img, offs = steps(part, "4x2", jax.make_mesh((4, 2),
                                                     ("data", "model")))
        for f in ("blocks", "term_slot", "term_nblk", "term_skip",
                  "term_nx", "term_ft"):
            out[f"stack__{f}"] = np.asarray(getattr(img, f))
        out["stack__num_docs"] = np.asarray(img.num_docs)
        out["stack__offsets"] = np.asarray(offs)
    pod = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                        devices=devs[:4])
    flat = jax.make_mesh((4, 1), ("data", "model"), devices=devs[:4])
    if part == "pod":
        steps("eq", "2x2x1", pod)
    if part == "config":
        shapes = {sid: dict(s) for sid, s in paper_index.INDEX_SHAPES.items()}
        out["index_shapes"] = np.asarray(json.dumps(shapes))
        out["flops"] = np.asarray(json.dumps(
            {sid: paper_index.ARCH.flops(sid) for sid in shapes}))
        out["arch"] = np.asarray(json.dumps(
            [paper_index.ARCH.arch_id, paper_index.ARCH.family,
             list(paper_index.ARCH.shapes)]))
        ims = images(data["eq"], PAD_VOCAB, pad_blocks=512)
        img, offs = stack_images(ims), shard_doc_offsets(ims)
        with mock.patch.dict(paper_index.INDEX_SHAPES, REDUCED):
            for sid in REDUCED:
                cell = paper_index.ARCH.build(flat, sid)
                a, b = run(flat, cell.fn, cell.in_shardings, None, img, offs,
                           data["eq"])
                out[f"build__{sid}__a"], out[f"build__{sid}__b"] = a, b
                out[f"build__{sid}__meta"] = np.asarray(json.dumps(dict(
                    args=[[list(x.shape), str(x.dtype)] for x in cell.args],
                    flops=cell.model_flops, notes=cell.notes,
                    kind=cell.kind, arch=cell.arch_id, shape=cell.shape_id)))
        for mname, mesh in (("4x1", flat), ("2x2x1", pod)):
            specs = sharded_input_specs(mesh, shard_blocks=512, B=64,
                                        vocab=128, qbatch=8, qterms=4)
            out[f"specs__{mname}"] = np.asarray(json.dumps(
                [[list(x.shape), str(x.dtype)] for x in specs]))
        made = []
        with mock.patch.object(jmesh.jax, "make_mesh",
                               lambda shape, axes, **kw: made.append(
                                   [list(shape), list(axes)])):
            jmesh.make_production_mesh(multi_pod=False)
            jmesh.make_production_mesh(multi_pod=True)
        out["production"] = np.asarray(json.dumps(made))
    np.savez(sys.argv[2], **out)
    print("OK")
""")


def _slices(out) -> list:
    return [x.numpy() for x in out]


def _world_steps(rank: int, world: int, data_path: str, cname: str) -> dict:
    """(data 4, model 2): case ``cname`` in every mode.  Rank 0 returns
    the assembled answers; every rank returns its own model slice."""
    torch.set_num_threads(1)
    case = json.loads(Path(data_path).read_text())[cname]
    mesh = make_host_mesh(model=2)
    out = {"slices": {}}
    ims = port_images(case)
    stacked, offs = stack_images(ims), shard_doc_offsets(ims)
    qt, qm = queries(case)
    for mode in MODES:
        step = make_sharded_query_step(
            mesh, k=10, max_blocks=max_blocks(ims),
            num_docs=case["num_docs"], mode=mode)
        img, off = stacked_shard(stacked, offs, step.shard)
        got = step(img, off, qt, qm)
        full = step.assemble(got, dst=0)
        out["slices"][mode] = (step.shard, step.model, _slices(got))
        if full is not None:
            out[f"{cname}__4x2__{mode}"] = _slices(full)
    return out


def _world_hangs(rank: int, world: int) -> None:
    time.sleep(120)


def _world_fails(rank: int, world: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()          # rank 0 would wait here for the whole timeout


def run_both(d: Path, part: str, world, ranks: int) -> dict:
    """The reference's ``part`` ("eq", "uneq", "pod" or "config") in a
    subprocess and ``world(rank, ranks, data_path, part)`` on ``ranks``
    gloo processes, side by side: ``ref`` (the reference's arrays), ``port``
    (every rank's result) and ``data``."""
    data = make_data()
    (d / "data.json").write_text(json.dumps(dict(
        data, vocab=VOCAB, pad_vocab=PAD_VOCAB, reduced=REDUCED)))
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "data.json"),
         str(d / "ref.npz"), part], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    try:
        # the ranks read the data from its file: arguments stay small, so
        # a rank that dies while it starts cannot block the parent's write
        port = launch(world, ranks, backend="gloo", store_dir=d,
                      args=(str(d / "data.json"), part),
                      deadline_s=DEADLINE_S)
        _, err = proc.communicate(timeout=DEADLINE_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    return dict(ref=ref, port=port, data=data)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = run_both(tmp_path_factory.mktemp("mesh"), "eq", _world_steps, 8)
    return dict(r, a=r["port"][0], ranks=[x["slices"] for x in r["port"]])


def ref_answer(ref, key):
    return ref[f"{key}__a"], ref[f"{key}__b"]


def assert_same(mode, got, want):
    """Bitmaps and counts equal; docids equal and f32 scores within rtol
    1e-6 (``-inf`` where ``want`` has it)."""
    ga, gb = (np.asarray(x) for x in got)
    wa, wb = (np.asarray(x) for x in want)
    assert ga.shape == wa.shape
    if mode == "conjunctive":
        assert np.array_equal(ga, wa)
        assert np.array_equal(gb.astype(np.int64), wb.astype(np.int64))
        assert ga.any()
        return
    assert np.array_equal(ga.astype(np.int64), wa.astype(np.int64))
    np.testing.assert_allclose(gb, wb, rtol=1e-6, atol=0)


def sparse_atol(case: dict, max_blocks_: int | None = None) -> np.ndarray:
    """Per-query absolute tolerance of the reference's ``ranked_sparse``
    scores: it takes each docid's score as the difference of two float32
    prefix sums over the whole row (``ROADMAP.md``, the reference's
    quirks), so a score is off by a few ulps of the row's total weight.
    The largest total over the shards, as ``test_torch_dvbyte_decode.py``
    bounds it."""
    ims = port_images(case)
    qt, qm = queries(case)
    tot = np.zeros(qt.shape[0])
    for im in ims:
        _, s = query_step(replace(im, num_docs=case["num_docs"]), qt, qm,
                          k=1 << 20, mode="ranked_sparse",
                          max_blocks=max_blocks_ or max_blocks(ims))
        s = s.numpy()
        tot = np.maximum(tot, np.where(np.isfinite(s), s, 0).sum(axis=1))
    return 4 * np.finfo(np.float32).eps * tot


def assert_matches_reference(mode, got, want, case: dict,
                             max_blocks_: int | None = None):
    """:func:`assert_same`, except that ``ranked_sparse`` scores are held
    within rtol 1e-6 plus :func:`sparse_atol`, and docids equal wherever
    the reference's scores are apart by more than that."""
    if mode != "ranked_sparse":
        assert_same(mode, got, want)
        return
    gd, gs = (np.asarray(x) for x in got)
    wd, ws = (np.asarray(x) for x in want)
    assert gd.shape == wd.shape
    atol = sparse_atol(case, max_blocks_)
    for row in range(gd.shape[0]):
        live = np.isfinite(ws[row])
        assert np.array_equal(np.isfinite(gs[row]), live)
        np.testing.assert_allclose(gs[row][live], ws[row][live], rtol=1e-6,
                                   atol=atol[row])
        tol = 1e-6 * np.abs(ws[row][live]) + atol[row]
        d, dw, sw = gd[row][live], wd[row][live], ws[row][live]
        i = 0
        while i < len(sw):
            j = i + 1
            while j < len(sw) and abs(sw[j] - sw[i]) <= 2 * tol[i]:
                j += 1
            if j < len(sw):
                assert set(d[i:j].tolist()) == set(dw[i:j].tolist())
            i = j


def check_matches_reference(runs, case: str, mode: str) -> None:
    """(data 4, model 2): the port's assembled answer equals the
    reference's ``shard_map`` step."""
    assert_matches_reference(mode, runs["a"][f"{case}__4x2__{mode}"],
                             ref_answer(runs["ref"], f"{case}__4x2__{mode}"),
                             runs["data"][case])


def check_model_slices(runs, case: str, mode: str) -> None:
    """Every rank's own output is its model slice of the whole answer:
    ranked rows equal on every shard, conjunctive columns its own
    bitmap."""
    full = runs["a"][f"{case}__4x2__{mode}"]
    N = runs["data"][case]["num_docs"]
    seen = set()
    for shard, model, (x, y) in (r[mode] for r in runs["ranks"]):
        rows = slice(model * 4, (model + 1) * 4)
        seen.add((shard, model))
        if mode == "conjunctive":
            assert np.array_equal(x, full[0][rows, shard * N:(shard + 1) * N])
        else:
            assert np.array_equal(x, full[0][rows])
        assert np.array_equal(y, full[1][rows])
    assert seen == {(s, m) for s in range(4) for m in range(2)}


def check_stack(runs, case: str) -> None:
    """``stack_images`` and ``shard_doc_offsets`` equal the reference's;
    ``stacked_shard`` hands each shard back its own image and offset."""
    ref = runs["ref"]
    ims = port_images(runs["data"][case])
    stacked, offs = stack_images(ims), shard_doc_offsets(ims)
    for f in ("blocks", "term_slot", "term_nblk", "term_skip", "term_nx",
              "term_ft"):
        got = getattr(stacked, f).numpy()
        assert got.dtype == ref[f"stack__{f}"].dtype
        assert np.array_equal(got, ref[f"stack__{f}"])
    sizes = [len(d) for d in runs["data"][case]["docs"]]
    assert stacked.num_docs == int(ref["stack__num_docs"]) == sum(sizes)
    assert offs.dtype == torch.int32
    assert offs.tolist() == ref["stack__offsets"].tolist() == [
        sum(sizes[:s]) for s in range(len(sizes))]
    for s, im in enumerate(ims):
        part, off = stacked_shard(stacked, offs, s)
        assert off == offs[s] and part.num_docs == im.num_docs
        n = im.blocks.shape[0]
        assert torch.equal(part.blocks[:n], im.blocks)
        assert not part.blocks[n:].any()
        assert torch.equal(part.term_slot, im.term_slot)
        assert torch.equal(part.term_ft, im.term_ft)


def check_plain(runs, case: str, mode: str) -> None:
    """``sharded_query_plain`` in one process equals the distributed
    step."""
    c = runs["data"][case]
    ims = port_images(c)
    qt, qm = queries(c)
    got = sharded_query_plain(ims, shard_doc_offsets(ims), qt, qm, k=10,
                              max_blocks=max_blocks(ims),
                              num_docs=c["num_docs"], mode=mode)
    assert_same(mode, got, runs["a"][f"{case}__4x2__{mode}"])


@pytest.mark.parametrize("mode", MODES)
def test_mesh_step_matches_reference(runs, mode):
    """Four equal shards with shard-local statistics."""
    check_matches_reference(runs, "eq", mode)


@pytest.mark.parametrize("mode", MODES)
def test_each_rank_returns_its_model_slice(runs, mode):
    check_model_slices(runs, "eq", mode)


def test_stack_images_and_offsets_match_reference(runs):
    check_stack(runs, "eq")


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equals_distributed_step(runs, mode):
    check_plain(runs, "eq", mode)


def test_launcher_raises_when_a_rank_fails(tmp_path):
    """A rank that raises makes ``launch`` raise with a rank's traceback
    (the failed rank's, or its peer's whose collective it broke), the
    other rank is stopped long before the process group's timeout, and
    the world's files are gone."""
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException,
                       match="fails on purpose|Connection reset|barrier"):
        launch(_world_fails, 2, backend="gloo", store_dir=tmp_path,
               deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 45
    assert list(tmp_path.iterdir()) == []


def test_launcher_kills_a_world_past_its_deadline(tmp_path):
    """Ranks that outlive the deadline are killed and ``launch`` raises
    :class:`TimeoutError`, leaving no process and no file behind."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(_world_hangs, 2, backend="gloo", store_dir=tmp_path,
               deadline_s=5)
    assert time.monotonic() - t0 < 45
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("backend", ["mpi", None])
def test_launcher_takes_only_an_explicit_known_backend(tmp_path, backend):
    with pytest.raises(ValueError):
        launch(_world_fails, 2, backend=backend, store_dir=tmp_path)
    assert list(tmp_path.iterdir()) == []
