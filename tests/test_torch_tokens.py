"""The port's token pipeline against the JAX package's: ``synthetic_corpus``
gives the same documents for a seed, and ``TokenStore`` (on the CPU, both
read routes) gives the same ``get_doc`` and ``sample_batch`` for the same
corpus and the same generator — including documents longer than the fused
read's 256-wide row merge, which take the engine's wide-row sort. Also
runs the port's example scripts at a tiny size."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.data.tokens import TokenStore as JaxTokenStore
from repro.data.tokens import synthetic_corpus as jax_corpus
from repro_torch.data import TokenStore, synthetic_corpus

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_corpus_matches_jax(seed):
    got = synthetic_corpus(7, 33, 500, seed=seed)
    want = jax_corpus(7, 33, 500, seed=seed)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _host_batch(docs, batch, seq_len, rng):
    """``sample_batch`` over the host corpus: the draw every store must
    reproduce."""
    out = np.zeros((batch, seq_len), np.int32)
    for i, d in enumerate(rng.integers(0, len(docs), batch)):
        toks = docs[int(d)]
        if len(toks) >= seq_len:
            s = rng.integers(0, len(toks) - seq_len + 1)
            out[i] = toks[s:s + seq_len]
        else:
            out[i] = np.tile(toks, -(-seq_len // len(toks)))[:seq_len]
    return out


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["ops", "kernel-route"])
def test_token_store_matches_jax(use_pallas):
    # lengths straddle the 256-wide fused row merge (longer documents
    # take the wide-row sort); half the documents are flushed to a run
    lengths = [3, 420, 5, 300, 120, 256, 257, 40, 1, 64, 399, 200]
    docs = [d[:n] for d, n in zip(synthetic_corpus(12, 420, 1000, seed=2),
                                  lengths)]
    kw = dict(num_shards=4, capacity_per_shard=1 << 18, max_docs=64)
    t = TokenStore(use_pallas=use_pallas, device="cpu", **kw)
    j = JaxTokenStore(**kw)
    for st in (t, j):
        st.ingest(docs[:6])
        st.store.flush()
        st.ingest(docs[6:])
    assert t.num_docs() == j.num_docs() == len(docs)
    assert t.store.device.type == "cpu" and t.store.use_pallas == use_pallas
    for i, d in enumerate(docs):
        got = t.get_doc(i)
        np.testing.assert_array_equal(got, j.get_doc(i))
        np.testing.assert_array_equal(got, d)
    for seq_len in (16, 200, 512):
        rt, rj, rh = (np.random.default_rng(seq_len) for _ in range(3))
        got = t.sample_batch(5, seq_len, rt)
        np.testing.assert_array_equal(got, j.sample_batch(5, seq_len, rj))
        np.testing.assert_array_equal(got, _host_batch(docs, 5, seq_len, rh))
    assert max(len(d) for d in docs) > 256


@pytest.mark.parametrize("script,extra", [
    ("torch_graph_analytics.py", []),
    ("torch_observability.py", ["--out", "OUT"])],
    ids=["graph_analytics", "observability"])
def test_examples_run_on_the_cpu(script, extra, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = [str(tmp_path) if a == "OUT" else a for a in extra]
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         "--scale", "8"] + extra,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "OK" in out.stdout.splitlines()[-1]
