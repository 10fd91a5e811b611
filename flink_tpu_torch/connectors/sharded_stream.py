"""Sharded replayable stream connector, the Kinesis-consumer role (port
of ``flink_tpu/connectors/sharded_stream.py``, the same files).

- Shard discovery: each subtask re-lists the stream every
  ``DISCOVER_EVERY`` steps and takes the shards created since, each
  shard owned by one subtask by a stable hash.
- Per-shard sequence numbers ride operator union list state: after a
  restore every subtask sees every shard's position and claims its own,
  so a rescale re-routes shards without losing positions (through
  ``initialize_state``).
- Records are (sequence, value): consumption resumes strictly after
  the checkpointed sequence number of each shard.

The stream (:class:`FileShardedStream`) is a directory of append-only
shard files of length-prefixed serialized records.
"""


from __future__ import annotations

import io
import os
import struct
from typing import Any, Dict, List, Optional

from flink_tpu_torch.core.serialization import PickleSerializer, TypeSerializer
from flink_tpu_torch.streaming.sources import SourceFunction

_LEN = struct.Struct(">i")


class FileShardedStream:
    """Producer/admin side: append-only shard files, length-prefixed
    records, sequence number = record index within the shard."""

    def __init__(self, path: str,
                 serializer: Optional[TypeSerializer] = None):
        self.path = path
        self.serializer = serializer or PickleSerializer()
        os.makedirs(path, exist_ok=True)

    # -- admin --------------------------------------------------------
    def create_shard(self, shard_id: str) -> None:
        p = self._shard_path(shard_id)
        if not os.path.exists(p):
            open(p, "ab").close()

    def list_shards(self) -> List[str]:
        return sorted(f[len("shard-"):] for f in os.listdir(self.path)
                      if f.startswith("shard-"))

    def _shard_path(self, shard_id: str) -> str:
        return os.path.join(self.path, f"shard-{shard_id}")

    # -- producer -----------------------------------------------------
    def put(self, shard_id: str, value: Any) -> None:
        data = self.serializer.serialize_to_bytes(value)
        with open(self._shard_path(shard_id), "ab") as f:
            f.write(_LEN.pack(len(data)))
            f.write(data)

    # -- consumer-side reads ------------------------------------------
    def read_from(self, shard_id: str, after_seq: int,
                  max_records: int, start_pos: int = 0,
                  start_seq: int = -1):
        """Records with sequence numbers (after_seq, after_seq + n].

        `start_pos`/`start_seq` are a resume cursor (byte offset +
        the sequence number of the record just before it) so a
        consumer reads each byte once instead of rescanning the shard
        from the beginning every poll; returns
        (records, end_pos, end_seq) — the next call's cursor.  A
        cursor of (0, -1) scans from the start (the
        restore-from-sequence-number-only case, paid once)."""
        out = []
        pos, seq = start_pos, start_seq
        try:
            with open(self._shard_path(shard_id), "rb") as f:
                f.seek(pos)
                while len(out) < max_records:
                    head = f.read(4)
                    if len(head) < 4:
                        break
                    (n,) = _LEN.unpack(head)
                    payload = f.read(n)
                    if len(payload) < n:
                        break  # torn tail of an in-flight append
                    seq += 1
                    pos += 4 + n
                    if seq > after_seq:
                        out.append((seq, self.serializer
                                    .deserialize(io.BytesIO(payload))))
        except FileNotFoundError:
            pass
        return out, pos, seq


def _owner(shard_id: str, num_subtasks: int) -> int:
    from flink_tpu_torch.core.keygroups import stable_hash64
    return stable_hash64(shard_id) % num_subtasks


class ShardedStreamSource(SourceFunction):
    """Consume a :class:`FileShardedStream` with Kinesis-consumer
    semantics: discovered shards, hash-assigned ownership, per-shard
    sequence offsets in UNION operator state, bounded or tailing."""

    OFFSETS_STATE = "shard-offsets"
    #: re-list the stream every N cooperative steps (shard discovery)
    DISCOVER_EVERY = 64

    def __init__(self, path: str,
                 serializer: Optional[TypeSerializer] = None,
                 bounded: bool = True, timestamp_fn=None):
        self.path = path
        self.serializer = serializer
        self.bounded = bounded
        #: record -> event timestamp (None = no timestamps)
        self.timestamp_fn = timestamp_fn
        self._stream: Optional[FileShardedStream] = None
        self._op = None
        #: shard -> last consumed sequence number (own shards only)
        self.offsets: Dict[str, int] = {}
        #: shard -> (byte offset, seq at offset) read cursor — a pure
        #: cache (NOT checkpointed: offsets alone rebuild it with one
        #: scan after restore)
        self._cursors: Dict[str, tuple] = {}
        self._loaded = False
        self._steps = 0
        self._running = True
        self._idle_rounds = 0

    # -- CheckpointedFunction seam ------------------------------------
    def initialize_state(self, op) -> None:
        """Called at operator open with the hosting operator; the
        UNION offset state is read lazily (restore runs after open in
        this runtime) and rewritten at every step boundary."""
        self._op = op

    def _union_state(self):
        return self._op.operator_state_backend.get_union_list_state(
            self.OFFSETS_STATE)

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._stream = FileShardedStream(self.path, self.serializer)
        if self._op is not None:
            n = self._op.num_subtasks
            idx = self._op.subtask_index
            # union state: every subtask sees ALL shards' offsets;
            # claim the ones this subtask now owns (rescale re-routes
            # shards without losing positions)
            for shard, seq in self._union_state().get():
                if _owner(shard, n) == idx:
                    self.offsets[shard] = max(
                        self.offsets.get(shard, -1), seq)
            self._discover()

    def _discover(self) -> None:
        n = self._op.num_subtasks if self._op is not None else 1
        idx = self._op.subtask_index if self._op is not None else 0
        for shard in self._stream.list_shards():
            if _owner(shard, n) == idx and shard not in self.offsets:
                self.offsets[shard] = -1  # TRIM_HORIZON

    def _publish_offsets(self) -> None:
        """Keep the union state current at every step boundary —
        snapshots capture the operator backend before the function
        hook runs, so the state must always be up to date."""
        if self._op is None:
            return
        st = self._union_state()
        st.clear()
        st.add_all(sorted(self.offsets.items()))

    # -- SourceFunction -----------------------------------------------
    def run(self, ctx) -> None:
        while self.emit_step(ctx, 256):
            pass

    def emit_step(self, ctx, max_records: int) -> bool:
        from flink_tpu_torch.streaming.elements import MAX_WATERMARK
        if not self._running:
            return False
        self._ensure_loaded()
        self._steps += 1
        if self._steps % self.DISCOVER_EVERY == 1:
            self._discover()
        emitted = 0
        budget = max(1, max_records // max(1, len(self.offsets)))
        for shard in sorted(self.offsets):
            cur_pos, cur_seq = self._cursors.get(shard, (0, -1))
            records, end_pos, end_seq = self._stream.read_from(
                shard, self.offsets[shard], budget, cur_pos, cur_seq)
            self._cursors[shard] = (end_pos, end_seq)
            for seq, value in records:
                if self.timestamp_fn is not None:
                    ctx.collect_with_timestamp(value,
                                               self.timestamp_fn(value))
                else:
                    ctx.collect(value)
                self.offsets[shard] = seq
                emitted += 1
        self._publish_offsets()
        if emitted:
            self._idle_rounds = 0
            return True
        if self.bounded:
            # bounded mode finishes after one full idle re-discovery
            # pass (everything written so far is consumed)
            self._idle_rounds += 1
            if self._idle_rounds >= 2:
                if self.timestamp_fn is not None:
                    ctx.emit_watermark(MAX_WATERMARK)
                return False
            self._discover()
            return True
        import time
        time.sleep(0.002)  # tailing: idle politely
        return True

    def cancel(self) -> None:
        self._running = False
