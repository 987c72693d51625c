"""``BENCHMARK.json`` keeps to its schema, and every name it uses
finds its file."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.tests.tiny import MANIFEST

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]


@pytest.mark.parametrize("spec,held", [(SPEC, False), (MANIFEST, True)],
                         ids=["benchmark", "with_held_back"])
def test_names_units_and_texts(spec, held):
    """The held-back cells keep the same form, with no bound set yet."""
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        if m["bound"] is not None or not held:
            assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        names.append(m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}


@pytest.mark.parametrize("spec", [SPEC, MANIFEST],
                         ids=["benchmark", "with_held_back"])
def test_every_name_finds_its_file(spec):
    cfgs = {c["name"]: c for c in spec["configs"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(cfgs)
    for c in cfgs.values():
        assert c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
        assert cfg["name"] == c["name"]
    for w in spec["workloads"]:
        assert (ROOT / "bench" / "mixes" / f"{w['traffic']}.json").is_file()
        cell = harness.cell(w["name"], spec)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]).read)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        "--workload", SPEC["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    if p.returncode == 0:
        pytest.skip("this machine has a CUDA card")
    assert p.stdout.strip() == ""
