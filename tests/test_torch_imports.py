"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to run on a CUDA device that is not there."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_port_imports_without_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.db, repro_torch.db.lsm, "
            "repro_torch.kernels.sorted_search, "
            "repro_torch.kernels.merge_rank, repro_torch.data, "
            "repro_torch.obs.export, repro_torch.kernels.segment_reduce, "
            "repro_torch.kernels.spmv, repro_torch.db.schema, "
            "repro_torch.db.naive, repro_torch.db.graphulo\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(bad)\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_file_names_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|from repro\.|from repro import"
                     r"|import repro\b)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    for p in files:
        assert not pat.search(p.read_text()), p


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.db import DBserver, ShardedTable, dbsetup
    from repro_torch.db.lsm import LSMRuns
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dbsetup("nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DBserver("nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedTable("nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LSMRuns(2, 256, 16, "last")
    assert dbsetup("cpu_ok", device="cpu").device.type == "cpu"
