"""Run state carried between the packages: the JAX engine's
``state_arrays()`` loads into the port (``load_jax_state``) and the port's
into the JAX engine (``load_state``); both then give the same reads, and
the keydict travels as its ordered string list."""
import numpy as np
import pytest

from repro.core import StringDict as JaxStringDict
from repro.db.lsm.engine import LSMRuns as JaxRuns
from repro_torch.core import StringDict
from repro_torch.db.lsm.engine import LSMRuns, load_jax_state

GEOM = dict(num_shards=2, capacity_per_shard=256, mem_cap=16,
            combiner="sum", l0_slots=2, fanout=4, id_capacity=64)


def _fill(runs_list, rng, batches=7):
    """The same memtable flushes into every engine (flushes, then a
    compaction once the two L0 slots fill)."""
    import jax.numpy as jnp
    import torch
    for _ in range(batches):
        r = np.full((2, 16), 2 ** 31 - 1, np.int32)
        c = np.full((2, 16), 2 ** 31 - 1, np.int32)
        v = np.zeros((2, 16), np.float32)
        for s in range(2):
            n = int(rng.integers(1, 17))
            r[s, :n] = rng.integers(32 * s, 32 * s + 32, n)
            c[s, :n] = rng.integers(0, 64, n)
            v[s, :n] = rng.integers(1, 9, n)
        for runs in runs_list:
            if isinstance(runs, JaxRuns):
                runs.flush_memtable(jnp.asarray(r), jnp.asarray(c),
                                    jnp.asarray(v))
            else:
                runs.flush_memtable(torch.from_numpy(r), torch.from_numpy(c),
                                    torch.from_numpy(v))


def _reads(runs):
    out = []
    for s in range(2):
        q = np.arange(32 * s, 32 * s + 32, dtype=np.int32)
        out.append(runs.query_shard_fused(s, q, q_tile=16))
        out.append(runs.scan_shard_fused(s, 32 * s + 3, 32 * s + 29))
    return out


def _same_reads(a, b):
    for x, y in zip(a, b):
        for u, w in zip(x, y):
            np.testing.assert_allclose(np.asarray(u), np.asarray(w),
                                       rtol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carried_across_packages(direction):
    rng = np.random.default_rng(7)
    if direction == "jax_to_port":
        src = JaxRuns(name="jax_state_src", **GEOM)
        dst = LSMRuns(name="torch_state_dst", device="cpu", **GEOM)
        _fill([src], rng)
        load_jax_state(dst, src.state_arrays())
    else:
        src = LSMRuns(name="torch_state_src", device="cpu", **GEOM)
        dst = JaxRuns(name="jax_state_dst", **GEOM)
        _fill([src], rng)
        dst.load_state(src.state_arrays())
    assert src.stats["major_compactions"] > 0
    _same_reads(_reads(dst), _reads(src))
    for k, v in src.state_arrays().items():
        np.testing.assert_array_equal(np.asarray(dst.state_arrays()[k]),
                                      np.asarray(v), err_msg=k)
    # blooms and fences are rebuilt bit for bit
    for i, lv in enumerate(dst.levels):
        a = np.asarray(lv["bloom"]).view(np.uint32)
        b = np.asarray(src.levels[i]["bloom"]).view(np.uint32)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(lv["fence"]),
                                      np.asarray(src.levels[i]["fence"]))


def test_same_flushes_give_same_state():
    rng = np.random.default_rng(8)
    j = JaxRuns(name="jax_state_same", **GEOM)
    t = LSMRuns(name="torch_state_same", device="cpu", **GEOM)
    _fill([j, t], rng)
    for k, v in j.state_arrays().items():
        np.testing.assert_array_equal(t.state_arrays()[k], np.asarray(v),
                                      err_msg=k)
    assert t.stats == j.stats
    np.testing.assert_array_equal(
        np.asarray(t.l0_bloom).view(np.uint32), np.asarray(j.l0_bloom))


def test_load_jax_state_rejects_other_geometry():
    src = JaxRuns(name="jax_state_geo", **GEOM)
    dst = LSMRuns(name="torch_state_geo", device="cpu",
                  **{**GEOM, "mem_cap": 32})
    with pytest.raises(ValueError, match="l0_rows"):
        load_jax_state(dst, src.state_arrays())


def test_keydict_carried_as_ordered_strings():
    j = JaxStringDict()
    j.encode(np.asarray(["v3", "v1", "v2", "v1"], dtype=object))
    t = StringDict.from_strings(list(j._to_str))
    ids = np.asarray(["v2", "v3", "v1"], dtype=object)
    np.testing.assert_array_equal(t.encode(ids), j.encode(ids))


def test_store_config_dict_means_the_same():
    import dataclasses
    from repro.db.kvstore import StoreConfig as JaxConfig
    from repro_torch.db.kvstore import StoreConfig
    j = JaxConfig(num_shards=2, memtable_cap=64, use_pallas=True,
                  transpose=True)
    t = StoreConfig(**dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([f.name for f in dataclasses.fields(StoreConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert StoreConfig() == StoreConfig(**dataclasses.asdict(JaxConfig()))


def test_raw_memtable_tail_matches_jax():
    """An unsorted memtable tail handed to the fused reads is sorted and
    combined inside the dispatch, as in the JAX engine."""
    rng = np.random.default_rng(9)
    j = JaxRuns(name="jax_state_raw", **GEOM)
    t = LSMRuns(name="torch_state_raw", device="cpu", **GEOM)
    _fill([j, t], rng, batches=3)
    r = rng.integers(0, 32, 12).astype(np.int32)
    c = rng.integers(0, 64, 12).astype(np.int32)
    v = rng.integers(1, 9, 12).astype(np.float32)
    q = np.arange(32, dtype=np.int32)
    _same_reads([t.query_shard_fused(0, q, mem_host=(r, c, v), q_tile=16),
                 t.scan_shard_fused(0, 2, 30, mem_host=(r, c, v))],
                [j.query_shard_fused(0, q, mem_host=(r, c, v), q_tile=16),
                 j.scan_shard_fused(0, 2, 30, mem_host=(r, c, v))])
