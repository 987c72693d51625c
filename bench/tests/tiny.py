"""Cells of ``BENCHMARK.json``, and those held back from it
(``bench/held_back.json``), cut to a size a CPU test run holds: the same
layers and code paths, a small universe and collection."""

from __future__ import annotations

import copy

from bench import harness


def manifest() -> dict:
    """``BENCHMARK.json`` with the held-back cells and their metrics added:
    a metric both name lists the cells of each."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    held = harness.load_json(harness.BENCH / "held_back.json")
    for key in ("configs", "workloads"):
        spec[key] = spec[key] + held[key]
    for key in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in spec[key]}
        for m in held[key]:
            if m["name"] not in have:
                spec[key].append(m)
            elif "workloads" in have[m["name"]]:
                have[m["name"]]["workloads"] += m["workloads"]
    return spec


MANIFEST = manifest()


def tiny(name: str, n_docs: int = 400, universe: int = 5000) -> harness.Cell:
    c = harness.cell(name, MANIFEST)
    c.cfg, c.mix = copy.deepcopy(c.cfg), copy.deepcopy(c.mix)
    c.cfg["collection"]["universe"] = universe
    c.cfg["n_docs"] = n_docs
    c.cfg["load_chunk"] = 128
    q = c.mix["queries"]
    q["pool"] = 512
    q["batch"] = min(int(q["batch"]), 32)
    c.mix["service"]["max_batch"] = q["batch"]
    c.mix["warmup_batches"] = 2
    c.mix["check"]["sample"] = 200
    if c.mix.get("documents"):
        c.mix["documents"]["per_batch"] = 4
    return c


CELLS = ("wsj1-const.bulk", "wsj1-fleet2.immediate")
