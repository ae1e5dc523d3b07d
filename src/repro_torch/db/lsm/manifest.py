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

Formats 1 to 3 read, and 2 and 3 write: a transpose sibling's arrays ride
in the same npz under the ``t_`` prefix, and format 3 adds the
``"tablets"`` record of a store with dynamic tablets (static stores keep
writing format 2).

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
        "format": 3 if table.tablet_map is not None else 2,
        "name": table.name,
        "config": config,
        "snapshot": SNAPSHOT,
        "wal": WAL_FILE,
        "wal_offset": table._wal.tell() if table._wal else 0,
    }
    if table.tablet_map is not None:
        man["tablets"] = table.tablet_map.to_manifest()
    path = os.path.join(dirpath, MANIFEST)
    _write_json(path, man)
    return path


def recover(dirpath: str, tablet_filter=None,
            device: Union[str, torch.device] = "cuda"):
    """Rebuild a ``ShardedTable`` (engine='lsm') on ``device`` after a crash.

    With a manifest, the snapshot runs load directly and only the WAL
    suffix replays (through ``insert``, so its flushes and compactions run
    on ``device`` with the manifest's ``use_pallas``); a torn tail is
    truncated so that later appends stay replayable.

    A format-3 manifest restores the tablet map before the replay; each
    meta frame (split, move, merge) then applies where it sits in the log,
    a move migrating the source shard on ``device``. ``tablet_filter``
    (an iterable of tablet ids, dynamic-tablet stores only) replays only
    the data frames tagged with those tablets — a lost process replays
    its own tablets' suffix — while meta frames always apply, so the
    recovered map is the whole store's.
    """
    from ..kvstore import ShardedTable, StoreConfig

    man_path = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(man_path):
        raise FileNotFoundError(
            f"no {MANIFEST} in {dirpath}; call checkpoint() at least once "
            "(WAL-only recovery needs the config the manifest records)")
    with open(man_path) as f:
        man = json.load(f)
    cfg = man["config"]
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
    # the tablet map restores BEFORE the replay, so suffix data frames
    # route through the topology the live table had at the snapshot point
    if man.get("tablets") and table.tablet_map is not None:
        from ..tablets import TabletMap
        table.tablet_map = TabletMap.from_manifest(man["tablets"])
    # replay the post-snapshot WAL suffix (torn tail drops at CRC check);
    # a table without a tablet map ignores meta frames
    wal_file = os.path.join(dirpath, man["wal"])
    tf = (None if tablet_filter is None
          else {int(t) for t in tablet_filter})
    for item in WriteAheadLog.replay_full(wal_file, start=man["wal_offset"]):
        if item[0] == "meta":
            table._apply_replayed_meta(item[1])
            continue
        _, tid, rows, cols, vals, _pair = item
        if tf is not None and tid is not None and tid not in tf:
            continue  # another process's tablet
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
