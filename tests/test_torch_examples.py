"""The port's example twins (adaptaqc_tpu_torch/examples) run as a user
runs them, with `--device cpu`, to the floors of tests/test_examples.py:
overlap > 0.98, > 0.9 for the advanced example, which weakens the
schedule. The 50-qubit and l = 20 MPS examples run on the card
(chip_smoke.py covers the small three there too); here they only show
that without a card they raise instead of falling back."""

import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOORS = {"readme_example": 0.98, "simple_sv_example": 0.98,
          "advanced_sv_example": 0.9}


@pytest.mark.parametrize("name", sorted(FLOORS))
def test_example_twin_runs_and_converges(name):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", f"adaptaqc_tpu_torch.examples.{name}",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = re.search(r"Overlap between circuits is ([0-9.eE+-]+)", proc.stdout)
    assert m, f"no overlap line in output:\n{proc.stdout[-2000:]}"
    assert float(m.group(1)) > FLOORS[name]


@pytest.mark.parametrize("name", sorted(FLOORS) + ["simple_mps_example",
                                                   "advanced_mps_example"])
def test_example_twin_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"adaptaqc_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
