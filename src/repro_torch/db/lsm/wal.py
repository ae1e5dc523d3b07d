"""Append-only write-ahead log for triple batches (durability layer).

A copy of the JAX package's ``repro.db.lsm.wal`` (numpy, ``struct`` and
``zlib`` only): the same batches write the same bytes in both packages,
and either package replays the other's log, tagged and meta frames
included (a store with dynamic tablets writes them).

Accumulo logs every mutation to a write-ahead log before it reaches the
in-memory map, so a crashed tablet server replays the tail on restart. The
adaptation logs ingest batches of already-encoded (row_id, col_id, value)
triples; string-dictionary durability is a separate concern (ROADMAP).

Record format (little-endian), one record per ``append``::

    u32 n        number of triples (bits 31/30/29 are flags, below)
    u32 crc      crc32 of (tablet-id bytes if any) + payload
    [u32 tablet] present only when bit 30 is set
    payload      n * int32 rows | n * int32 cols | n * float32 vals

Flag bits in the ``n`` field:

  * bit 31 (``_PAIR_FLAG``) — *pair-ingest* frame: the batch also feeds
    the table's transpose sibling (``A^T`` derives deterministically by
    swapping rows/cols, so the payload is logged ONCE — one record, one
    fsync, and replay can never rebuild half a pair).
  * bit 30 (``_TABLET_FLAG``) — the frame carries a ``u32`` tablet id
    between the crc and the payload: every triple in the batch belongs
    to that tablet, so a recovering process can replay ONLY its own
    tablets' suffix by skipping foreign frames without parsing them.
  * bit 29 (``_META_FLAG``) — the payload is a tablet-map operation
    (UTF-8 JSON padded with spaces to a 12-byte multiple, so ``n`` keeps
    the ``12 * n`` payload-length arithmetic): ``{"op": "split", ...}``,
    ``{"op": "move", ...}`` or ``{"op": "merge", ...}``.
    Replay applies these to the tablet map
    at the same log point the live table did, so data frames after the
    op route identically.

Frames without flags are byte-identical to the original format; tagged
and meta frames only appear when a table runs with ``dynamic_tablets``.
Readers written before a flag treat tagged logs as corrupt rather than
misparsing them, and untagged logs replay identically under the new
reader.

Replay stops at the first torn or corrupt record (crash-consistent: a
partially flushed tail is discarded, never misparsed). ``tell()`` exposes
the byte offset so a snapshot can mark how much of the log it covers and
recovery can replay only the suffix.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from time import perf_counter
from typing import Iterator, Optional, Tuple

import numpy as np

from ...obs import default_registry, default_tracer

_HEADER = b"RLSMWAL1"
_REC = struct.Struct("<II")
_TID = struct.Struct("<I")
_PAIR_FLAG = 0x80000000    # bit 31: dual-ingest frame
_TABLET_FLAG = 0x40000000  # bit 30: frame carries a u32 tablet id
_META_FLAG = 0x20000000    # bit 29: payload is a tablet-map op (JSON)
_N_MASK = _META_FLAG - 1

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _wal_label(path: str) -> str:
    """Metric label for a log file: its parent dir name (the wal_dir is
    per-table), falling back to the basename."""
    return os.path.basename(os.path.dirname(path)) or os.path.basename(path)


def _iter_frames(f) -> Iterator[tuple]:
    """Parse intact frames from an open log positioned past the header.

    Yields ``("meta", op_dict)`` for tablet-map frames and
    ``("data", tablet_id_or_None, rows, cols, vals, pair)`` for triple
    frames. Stops silently at the first torn or corrupt record.
    """
    while True:
        head = f.read(_REC.size)
        if len(head) < _REC.size:
            return
        n_raw, crc = _REC.unpack(head)
        n = n_raw & _N_MASK
        if n_raw & _META_FLAG:
            payload = f.read(12 * n)
            if len(payload) < 12 * n or zlib.crc32(payload) != crc:
                return
            yield "meta", json.loads(payload.decode("utf-8"))
            continue
        extra = b""
        tablet = None
        if n_raw & _TABLET_FLAG:
            extra = f.read(_TID.size)
            if len(extra) < _TID.size:
                return
            tablet = _TID.unpack(extra)[0]
        payload = f.read(12 * n)
        if len(payload) < 12 * n or zlib.crc32(extra + payload) != crc:
            return
        yield ("data", tablet,
               np.frombuffer(payload[: 4 * n], "<i4"),
               np.frombuffer(payload[4 * n: 8 * n], "<i4"),
               np.frombuffer(payload[8 * n:], "<f4"),
               bool(n_raw & _PAIR_FLAG))


class WriteAheadLog:
    """Single-writer append-only log; safe to re-open for replay."""

    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "ab")
        if not exists:
            self._f.write(_HEADER)
            self._f.flush()
        reg = default_registry()
        self._trace = default_tracer()
        log = _wal_label(path)
        self._c_appends = reg.counter("wal_appends", log=log)
        self._c_bytes = reg.counter("wal_append_bytes", log=log)
        self._c_fsyncs = reg.counter("wal_fsyncs", log=log)
        self._h_append = reg.histogram("wal_latency_s", log=log, op="append")
        self._h_fsync = reg.histogram("wal_latency_s", log=log, op="fsync")
        self._g_backlog = reg.gauge("wal_backlog_bytes", log=log)

    # ------------------------------------------------------------ writing
    def append(self, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, pair: bool = False,
               tablet: Optional[int] = None) -> int:
        """Log one batch; returns the byte offset AFTER the record.

        ``pair=True`` tags the frame as a dual-ingest batch: recovery
        re-derives the transpose sibling's triples from the same payload,
        so both tables of a pair commit or vanish together.

        ``tablet`` tags every triple in the frame as belonging to one
        tablet (the caller partitions a mixed batch into per-tablet
        frames), enabling per-tablet suffix replay."""
        t0 = perf_counter()
        with self._trace.span("wal.append", log=_wal_label(self.path),
                              n=len(rows)):
            payload = (np.asarray(rows, "<i4").tobytes()
                       + np.asarray(cols, "<i4").tobytes()
                       + np.asarray(vals, "<f4").tobytes())
            n_field = len(rows) | (_PAIR_FLAG if pair else 0)
            extra = b""
            if tablet is not None:
                n_field |= _TABLET_FLAG
                extra = _TID.pack(int(tablet))
            self._f.write(_REC.pack(n_field, zlib.crc32(extra + payload)))
            if extra:
                self._f.write(extra)
            self._f.write(payload)
            self._f.flush()
            if self.sync:
                t1 = perf_counter()
                os.fsync(self._f.fileno())
                self._c_fsyncs.inc()
                self._h_fsync.observe(perf_counter() - t1)
        self._c_appends.inc()
        self._c_bytes.inc(_REC.size + len(extra) + len(payload))
        self._h_append.observe(perf_counter() - t0)
        return self._f.tell()

    def append_meta(self, op: dict) -> int:
        """Log one tablet-map operation (split/move) as a meta frame;
        returns the byte offset AFTER the record. The op is logged BEFORE
        the in-memory map changes (write-ahead), so replay applies it at
        the same point in the data stream."""
        t0 = perf_counter()
        payload = json.dumps(op, sort_keys=True).encode("utf-8")
        payload += b" " * (-len(payload) % 12)
        n_field = _META_FLAG | (len(payload) // 12)
        self._f.write(_REC.pack(n_field, zlib.crc32(payload)))
        self._f.write(payload)
        self._f.flush()
        if self.sync:
            t1 = perf_counter()
            os.fsync(self._f.fileno())
            self._c_fsyncs.inc()
            self._h_fsync.observe(perf_counter() - t1)
        self._c_appends.inc()
        self._c_bytes.inc(_REC.size + len(payload))
        self._h_append.observe(perf_counter() - t0)
        return self._f.tell()

    def tell(self) -> int:
        return self._f.tell()

    def refresh_backlog_gauge(self, covered_offset: int = 0) -> int:
        """Health gauge: bytes past ``covered_offset`` (the last
        snapshot's ``wal_offset``) — what a crash right now would have to
        replay. Returns the backlog."""
        backlog = max(0, self.tell() - int(covered_offset))
        self._g_backlog.set(backlog)
        return backlog

    def close(self) -> None:
        self._f.close()

    # ------------------------------------------------------------ replay
    @staticmethod
    def valid_end(path: str) -> int:
        """Byte offset after the last intact record (header if empty)."""
        if not os.path.exists(path):
            return 0
        with open(path, "rb") as f:
            if f.read(len(_HEADER)) != _HEADER:
                return 0
            end = f.tell()
            for _ in _iter_frames(f):
                end = f.tell()
            return end

    @staticmethod
    def truncate_torn_tail(path: str) -> int:
        """Drop a torn/corrupt tail so future appends stay reachable by
        replay (a crash mid-append otherwise poisons the log: records
        appended after the torn bytes would never replay). Returns the
        valid end offset. ``end == 0`` means even the header is torn: the
        file truncates to empty so the next writer lays down a fresh
        header (appending after header garbage would be unreplayable)."""
        end = WriteAheadLog.valid_end(path)
        if os.path.exists(path) and os.path.getsize(path) > end:
            with open(path, "r+b") as f:
                f.truncate(end)
        return end

    @staticmethod
    def replay(path: str, start: int = 0, tagged: bool = False) -> Iterator:
        """Yield logged DATA batches from byte offset ``start`` (0 = whole
        log); tablet-map meta frames are skipped (use ``replay_full`` to
        see them).

        Yields ``(rows, cols, vals)`` triples; with ``tagged=True`` each
        item is ``(rows, cols, vals, pair)`` where ``pair`` reports the
        dual-ingest frame flag (pair-aware recovery re-derives ``A^T``
        from the same payload).

        Tolerates a torn tail: a record whose header or payload is short,
        or whose CRC mismatches, ends the iteration (simulated crash).
        """
        for item in WriteAheadLog.replay_full(path, start=start):
            if item[0] != "data":
                continue
            _, _tid, rows, cols, vals, pair = item
            if tagged:
                yield rows, cols, vals, pair
            else:
                yield rows, cols, vals

    @staticmethod
    def replay_full(path: str, start: int = 0) -> Iterator[tuple]:
        """Yield EVERY intact frame from byte offset ``start``:
        ``("data", tablet_id_or_None, rows, cols, vals, pair)`` for
        triple batches and ``("meta", op_dict)`` for tablet-map ops, in
        log order. Tablet-aware recovery filters data frames by tablet id
        and applies meta frames to its map as they stream past."""
        if not os.path.exists(path):
            return
        reg = default_registry()
        log = _wal_label(path)
        c_batches = reg.counter("wal_replay_batches", log=log)
        c_bytes = reg.counter("wal_replay_bytes", log=log)
        h_replay = reg.histogram("wal_latency_s", log=log, op="replay")
        t0 = perf_counter()
        with open(path, "rb") as f:
            if f.read(len(_HEADER)) != _HEADER:
                return
            if start > len(_HEADER):
                f.seek(start)
            pos = f.tell()
            for item in _iter_frames(f):
                c_batches.inc()
                c_bytes.inc(f.tell() - pos)
                pos = f.tell()
                yield item
        h_replay.observe(perf_counter() - t0)
