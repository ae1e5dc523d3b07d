"""Snapshot manifest + crash recovery for the LSM engine.

The port's counterpart of ``repro.db.lsm.manifest``, file for file the same
format, so a directory written by either package recovers in the other.

Durability contract (Accumulo-shaped):

  * every ingest batch is appended to the WAL before it touches the
    memtable (``ShardedTable.insert`` with ``wal_dir`` set);
  * ``checkpoint()`` minor-compacts the memtable, then atomically writes a
    snapshot of all sorted runs plus ``MANIFEST.json`` recording the WAL
    byte offset the snapshot covers;
  * ``recover(dir)`` rebuilds the table: construct from the manifest's
    config, load the snapshot runs onto the device (blooms and fences are
    rebuilt there), replay only the WAL suffix past the recorded offset. A
    torn WAL tail (simulated crash) is discarded by the WAL's CRC framing.

Formats 1 and 2 read and write (a transpose sibling's arrays ride in the
same npz under the ``t_`` prefix). Format 3 (a dynamic tablet map) is
refused until dynamic tablets are ported.

This module persists the encoded (row_id, col_id, value) store only; the
string dictionaries live one layer up — ``db.connector`` journals them
and ``db.connector.recover_connector`` combines both layers.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Union

import numpy as np
import torch

from .wal import WriteAheadLog

MANIFEST = "MANIFEST.json"
SNAPSHOT = "snapshot.npz"
WAL_FILE = "wal.log"

# transpose-sibling state arrays share the snapshot under this prefix —
# one atomic npz replace covers BOTH tables of a pair
_T_PREFIX = "t_"


def wal_path(dirpath: str) -> str:
    return os.path.join(dirpath, WAL_FILE)


def _write_json(path: str, obj) -> None:
    """Write ``obj`` as the file at ``path`` atomically (tmp, fsync,
    replace)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_snapshot(table, dirpath: str) -> str:
    """Persist ``table``'s run state + manifest; returns the manifest path.

    Caller must have flushed the memtable first (``checkpoint`` does); the
    manifest's ``wal_offset`` then covers everything in the snapshot, so
    recovery replays exactly the post-snapshot suffix.
    """
    os.makedirs(dirpath, exist_ok=True)
    runs = table._runs  # LSM engine only
    state = dict(runs.state_arrays())
    if table.t_store is not None:  # pair: sibling rides in the same npz
        for k, v in table.t_store._runs.state_arrays().items():
            state[_T_PREFIX + k] = v
    snap_tmp = os.path.join(dirpath, SNAPSHOT + ".tmp")
    with open(snap_tmp, "wb") as f:
        np.savez(f, **state)
        f.flush()
        os.fsync(f.fileno())
    os.replace(snap_tmp, os.path.join(dirpath, SNAPSHOT))
    # the StoreConfig round-trips verbatim (StoreConfig.from_manifest);
    # per-table extras (combiner, resolved mem_cap, bloom sizing) ride
    # alongside
    config = dataclasses.asdict(table.config)
    config.update({
        "combiner": table.combiner,
        "mem_cap": table.mem_cap,
        "bloom_bits_per_key": list(runs.bloom_bits),
        "bloom_hashes": list(runs.bloom_hashes),
    })
    man = {
        "format": 2,
        "name": table.name,
        "config": config,
        "snapshot": SNAPSHOT,
        "wal": WAL_FILE,
        "wal_offset": table._wal.tell() if table._wal else 0,
    }
    path = os.path.join(dirpath, MANIFEST)
    _write_json(path, man)
    return path


def recover(dirpath: str, tablet_filter=None,
            device: Union[str, torch.device] = "cuda"):
    """Rebuild a ``ShardedTable`` (engine='lsm') on ``device`` after a crash.

    With a manifest, the snapshot runs load directly and only the WAL
    suffix replays (through ``insert``, so its flushes and compactions run
    on ``device`` with the manifest's ``use_pallas``); a torn tail is
    truncated so that later appends stay replayable. ``tablet_filter``
    (per-tablet replay) and format-3 manifests need dynamic tablets, which
    are not ported yet.
    """
    from ..kvstore import ShardedTable, StoreConfig, _not_yet

    if tablet_filter is not None:
        raise _not_yet("tablet_filter")
    man_path = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(man_path):
        raise FileNotFoundError(
            f"no {MANIFEST} in {dirpath}; call checkpoint() at least once "
            "(WAL-only recovery needs the config the manifest records)")
    with open(man_path) as f:
        man = json.load(f)
    cfg = man["config"]
    if man.get("tablets") or cfg.get("dynamic_tablets"):
        raise _not_yet("manifest format 3")
    table = ShardedTable(
        man.get("name", "recovered"), engine="lsm",
        combiner=cfg["combiner"],
        bloom_bits_per_key=tuple(cfg.get("bloom_bits_per_key", ())) or None,
        bloom_hashes=tuple(cfg.get("bloom_hashes", ())) or None,
        config=StoreConfig.from_manifest(cfg).replace(engine="lsm"),
        device=device)
    snap = os.path.join(dirpath, man["snapshot"])
    if os.path.exists(snap):
        with np.load(snap) as z:
            main_state = {k: z[k] for k in z.files
                          if not k.startswith(_T_PREFIX)}
            table._runs.load_state(main_state)
            if table.t_store is not None:
                t_state = {k[len(_T_PREFIX):]: z[k] for k in z.files
                           if k.startswith(_T_PREFIX)}
                if t_state:
                    table.t_store._runs.load_state(t_state)
    # replay the post-snapshot WAL suffix (torn tail drops at CRC check);
    # tablet-map meta frames only come with dynamic tablets, and a table
    # without a tablet map ignores them, as the JAX package's does
    wal_file = os.path.join(dirpath, man["wal"])
    for item in WriteAheadLog.replay_full(wal_file, start=man["wal_offset"]):
        if item[0] == "meta":
            continue
        _, _tid, rows, cols, vals, _pair = item
        table.insert(rows, cols, vals, _log=False)
    # chop any torn tail BEFORE re-appending: otherwise post-recovery
    # records land after the corrupt bytes and are unreachable next time
    end = WriteAheadLog.truncate_torn_tail(wal_file)
    if end < man["wal_offset"]:
        # the log lost bytes the snapshot already covers (pre-snapshot
        # corruption, possibly the header itself). The data is safe in the
        # snapshot, but appends now land BELOW the recorded offset —
        # invisible to the next replay. Re-anchor the manifest at the
        # truncated end (0 = fully torn: attach_wal lays a fresh header
        # and replay starts over).
        man["wal_offset"] = end
        _write_json(man_path, man)
    # the recovered table keeps journaling to the same WAL
    table.attach_wal(dirpath)
    return table
