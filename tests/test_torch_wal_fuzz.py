"""Crash-recovery fuzzing of the port against the JAX package and an
oracle, at a small budget (the JAX package's own fuzz in
tests/test_lsm_fuzz.py covers the deep sweep).

Both packages build the same checkpointed store plus post-checkpoint
WAL-only batches (their logs are byte-identical); the log is then cut at
sampled offsets and at every few bytes of the tail frame, and torn or
flipped in the header and mid-file. At each cut the port's recovery must
equal the JAX package's recovery of the same cut and the prefix-consistent
oracle (exactly the batches whose records lie wholly below the cut), for a
single table and for a transpose pair (whose sibling must be the exact
transpose); and a write made after recovery must survive a second crash.
"""
import os
import shutil

import numpy as np
import pytest

from repro.db.kvstore import ShardedTable as JaxTable
from repro.db.lsm import recover as jax_recover
from repro_torch.db.kvstore import ShardedTable as TorchTable
from repro_torch.db.lsm import recover

BATCH_N = 4           # triples per batch -> 8 + 12*4 = 56-byte records
N_PRE, N_POST = 3, 3  # batches before / after the checkpoint
CFG = dict(num_shards=1, capacity_per_shard=512, batch_cap=64,
           id_capacity=1 << 9, combiner="last", memtable_cap=16,
           engine="lsm")


def _build(root, pkg, pair):
    """A checkpointed store plus post-checkpoint WAL-only batches. Returns
    (dir, batches, record_ends, ckpt_offset): ``record_ends[i]`` is the
    byte offset just past post-checkpoint batch i's WAL record."""
    d = os.path.join(root, f"{pkg}_{int(pair)}")
    name = f"fz_{pkg}_{int(pair)}"
    if pkg == "jax":
        st = JaxTable(name, wal_dir=d, transpose=pair, **CFG)
    else:
        st = TorchTable(name, wal_dir=d, transpose=pair, device="cpu", **CFG)
    rng = np.random.default_rng(42)
    batches = []

    def put():
        r = rng.choice(1 << 9, BATCH_N, replace=False).astype(np.int32)
        c = rng.integers(0, 4, BATCH_N).astype(np.int32)
        v = rng.normal(size=BATCH_N).astype(np.float32)
        st.insert(r, c, v)
        batches.append((r, c, v))
        return st._wal.tell()

    for _ in range(N_PRE):
        put()
    st.checkpoint()
    ckpt_off = st._wal.tell()
    ends = [put() for _ in range(N_POST)]
    st._wal.close()  # simulated crash: no further flushes
    return d, batches, ends, ckpt_off


@pytest.fixture(params=[False, True], ids=["single", "pair"])
def built(request, tmp_path):
    """Both packages' directories (same log bytes), the batches, the record
    ends, the checkpoint offset, and whether it is a pair."""
    pair = request.param
    td, batches, ends, ckpt = _build(str(tmp_path), "torch", pair)
    jd, *_ = _build(str(tmp_path), "jax", pair)
    with open(os.path.join(td, "wal.log"), "rb") as f, \
            open(os.path.join(jd, "wal.log"), "rb") as g:
        assert f.read() == g.read()
    return {"torch": td, "jax": jd}, batches, ends, ckpt, pair


def _expected(batches, ends, ckpt_off, cut):
    """Prefix-consistent oracle (combiner last): checkpointed batches
    always survive; a post-checkpoint batch survives iff its whole record
    is below the cut."""
    n_ok = sum(1 for e in ends if e <= max(cut, ckpt_off))
    out = {}
    for r, c, v in batches[:N_PRE + n_ok]:
        for a, b, x in zip(r, c, v):
            out[(int(a), int(b))] = float(x)
    return out


def _scan_dict(st):
    r, c, v = st.scan()
    return {(int(a), int(b)): float(x) for a, b, x in zip(r, c, v)}


def _cut_copies(dirs, tmp_path, tag, edit):
    """Copy both packages' directories and apply ``edit(wal_file)`` to
    each; returns the copies."""
    out = {}
    for pkg, src in dirs.items():
        d = str(tmp_path / f"{tag}_{pkg}")
        shutil.copytree(src, d)
        edit(os.path.join(d, "wal.log"))
        out[pkg] = d
    return out


def _recover_both(copies, want, pair, ctx):
    """The port's and the JAX package's recoveries of the same cut both
    equal the oracle (the sibling its transpose); returns the port's."""
    st = recover(copies["torch"], device="cpu")
    js = jax_recover(copies["jax"])
    got = _scan_dict(st)
    assert got == _scan_dict(js), ctx
    assert got == pytest.approx(want), (ctx, sorted(got), sorted(want))
    if pair:
        sib = _scan_dict(st.t_store)
        assert sib == _scan_dict(js.t_store), ctx
        assert sib == pytest.approx({(b, a): x for (a, b), x in
                                     want.items()}), ctx
    js._wal.close()
    return st


def _second_crash(st, d, want, pair, ctx):
    """A write after recovery survives a second crash (recovery truncated
    the torn tail, so the new record is replayable)."""
    st.insert(np.asarray([500], np.int32), np.asarray([2], np.int32),
              np.asarray([9.5], np.float32))
    st._wal.close()
    st2 = recover(d, device="cpu")
    want2 = dict(want)
    want2[(500, 2)] = 9.5
    assert _scan_dict(st2) == pytest.approx(want2), ctx
    if pair:
        assert _scan_dict(st2.t_store) == pytest.approx(
            {(b, a): x for (a, b), x in want2.items()}), ctx
    st2._wal.close()


def test_wal_truncation_fuzz_matches_jax(built, tmp_path):
    dirs, batches, ends, ckpt, pair = built
    size = os.path.getsize(os.path.join(dirs["torch"], "wal.log"))
    tail_start = ends[-2]  # the final record's frame
    rng = np.random.default_rng(7 + pair)
    cuts = sorted(set(int(x) for x in rng.integers(0, tail_start, 5))
                  | set(range(tail_start, size + 1, 5)) | {size - 1, size}
                  | {e + d for e in ends[:-1] for d in (-1, 0, 1)})
    for i, cut in enumerate(cuts):
        def edit(wal, cut=cut):
            with open(wal, "r+b") as f:
                f.truncate(cut)
        copies = _cut_copies(dirs, tmp_path, f"cut{cut}", edit)
        want = _expected(batches, ends, ckpt, cut)
        st = _recover_both(copies, want, pair, cut)
        if i % 4 == 0:
            _second_crash(st, copies["torch"], want, pair, cut)
        else:
            st._wal.close()


def test_wal_header_and_mid_file_corruption_match_jax(built, tmp_path):
    """A torn HEADER keeps the snapshot, re-anchors the manifest offset
    and lays a fresh header, so a post-recovery write survives the next
    crash; flipped bytes inside an early record drop that record and
    everything after it (CRC framing, not length trust)."""
    dirs, batches, ends, ckpt, pair = built
    for cut in (0, 3, 7):
        def edit(wal, cut=cut):
            with open(wal, "r+b") as f:
                f.truncate(cut)
        copies = _cut_copies(dirs, tmp_path, f"hdr{cut}", edit)
        want = _expected(batches, ends, ckpt, cut)
        st = _recover_both(copies, want, pair, ("header", cut))
        _second_crash(st, copies["torch"], want, pair, ("header", cut))

    def flip(wal):  # corrupt the payload of post-checkpoint batch 1
        with open(wal, "r+b") as f:
            f.seek(ends[0] + 12)
            f.write(b"\xff\xff\xff")
    copies = _cut_copies(dirs, tmp_path, "flip", flip)
    want = _expected(batches, ends, ckpt, ends[0])
    _recover_both(copies, want, pair, "mid-file")._wal.close()


def test_recovery_truncates_torn_tail_so_new_writes_survive(tmp_path):
    """tests/test_lsm.py's double crash on the port: recovery after a torn
    tail must truncate it, or every batch journaled after recovery lands
    past the corrupt bytes and is lost to the NEXT recovery; the JAX
    package recovers the port's directory the same way."""
    d = str(tmp_path / "db")
    st = TorchTable("fz_torn", num_shards=1, capacity_per_shard=2048,
                    batch_cap=256, id_capacity=1 << 10, combiner="last",
                    memtable_cap=64, engine="lsm", wal_dir=d, device="cpu")
    st.insert(np.asarray([1, 2], np.int32), np.asarray([0, 0], np.int32),
              np.asarray([1.0, 2.0], np.float32))
    st.checkpoint()
    st.insert(np.asarray([3], np.int32), np.asarray([0], np.int32),
              np.asarray([3.0], np.float32))
    del st
    wal = os.path.join(d, "wal.log")
    with open(wal, "r+b") as f:  # crash tore the last record mid-payload
        f.truncate(os.path.getsize(wal) - 5)
    rec = recover(d, device="cpu")  # row 3's torn record is gone
    assert set(rec.scan()[0].tolist()) == {1, 2}
    rec.insert(np.asarray([4], np.int32), np.asarray([0], np.int32),
               np.asarray([4.0], np.float32))
    del rec  # second crash, before any checkpoint
    rec2 = recover(d, device="cpu")
    assert set(rec2.scan()[0].tolist()) == {1, 2, 4}
    rec2._wal.close()
    assert set(jax_recover(d).scan()[0].tolist()) == {1, 2, 4}
