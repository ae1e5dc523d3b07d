"""The port's quickstart, serving and training examples run to their end
in subprocesses: on the CPU at small sizes and, where there is a card,
the LM examples at full width on the card (their default device)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CARD = pytest.mark.gpu


@pytest.mark.parametrize("script,args", [
    pytest.param("torch_quickstart.py", ["--device", "cpu"], id="quickstart"),
    pytest.param("torch_serve_lm.py", ["--device", "cpu"], id="serve_lm"),
    pytest.param("torch_train_lm.py", ["--steps", "8", "--device", "cpu"],
                 id="train_lm"),
    pytest.param("torch_serve_lm.py", [], marks=CARD, id="serve_lm-card"),
    pytest.param("torch_train_lm.py", ["--steps", "8"], marks=CARD,
                 id="train_lm-card")])
def test_examples_run(script, args):
    card = "--device" not in args
    if card and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script)]
                         + args, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "OK"
    if script == "torch_serve_lm.py":
        assert ("(cuda" if card else "(cpu") in out.stdout
    if script == "torch_train_lm.py":
        assert "resumed from step 4" in out.stdout
        assert "training-loss sanity: PASS" in out.stdout
