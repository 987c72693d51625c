"""The port's training entry point (``python -m repro_torch.launch.train``)
and its example (``examples/train_quickstart_torch.py``), on the CPU.

* ``--device cpu --steps 4`` in a subprocess prints the reference's
  ``[train]`` line: 4 steps of the reduced llama3.2-3b, the loss finite
  and falling (the parameters are drawn by torch's generator, so the
  numbers are not the reference's: ``test_torch_lm_train.py`` holds the
  arithmetic to the reference's).
* The same command with ``--ckpt-dir`` in two runs, 6 steps and then 4
  more, prints the losses of one run of 10 (its first and its last, to
  the printed digit); the second run resumes from step 5, the first run's
  final save.
* The example trains 3 steps and, run again on its checkpoint directory,
  resumes from step 2.
* The ``gnn`` and ``recsys`` arch ids raise "not ported yet", and without
  ``--device`` the entry point asks for the card and raises where there
  is none.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
LINE = re.compile(r"^\[train\] (\S+): loss (\S+) -> (\S+) over (\d+) steps; "
                  r"stragglers=(\d+)$", re.M)


def _env() -> dict:
    # one intra-op thread: the test workers do not oversubscribe the cores
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _run(*args) -> str:
    env = _env()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", *args], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_train_main_runs_on_the_cpu():
    out = _run("--steps", "4")
    m = LINE.search(out)
    assert m, out
    assert m.group(1) == "llama3.2-3b" and m.group(4) == "4"
    first, last = float(m.group(2)), float(m.group(3))
    assert last < first < 10


def test_train_main_resumes_to_the_same_loss(tmp_path):
    straight = LINE.search(_run("--steps", "10")).groups()
    ck = str(tmp_path / "ck")
    a = _run("--steps", "6", "--ckpt-dir", ck)
    b = _run("--steps", "4", "--ckpt-dir", ck)
    assert "resumed" not in a
    assert "[trainer] resumed from step 5" in b
    assert LINE.search(a).group(2) == straight[1]
    assert LINE.search(b).group(3) == straight[2]
    assert sorted(os.listdir(ck)) == ["step-0000000005", "step-0000000009"]


@pytest.mark.parametrize("arch", ["schnet", "dlrm-mlperf", "sasrec", "din",
                                  "two-tower-retrieval"])
def test_other_families_are_not_ported_yet(arch):
    with pytest.raises(KeyError, match="not ported yet"):
        train.main(["--arch", arch, "--device", "cpu", "--steps", "1"])


def test_train_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


def test_quickstart_example_trains_and_resumes(tmp_path):
    env = _env()
    cmd = [sys.executable, str(ROOT / "examples" / "train_quickstart_torch.py"),
           "--device", "cpu", "--steps", "3", "--ckpt", str(tmp_path)]
    first = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
    second = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            timeout=300)
    assert first.returncode == 0 and second.returncode == 0, \
        first.stderr + second.stderr
    assert LINE.search(first.stdout) and LINE.search(second.stdout)
    assert "[trainer] resumed from step 2" in second.stdout
