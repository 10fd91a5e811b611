"""Edge partitioners: how records and batches pick a downstream channel
(port of ``flink_tpu/streaming/partitioners.py:39-201, 213-330,
352-366``).

Forward, rebalance (round robin), rescale (round robin inside a
pointwise group), shuffle (uniform random), broadcast (every channel),
global (channel 0), the keyBy edge's key-group partitioner, and a
user's ``partitioner(key, num_channels)`` (``partition_custom``).

``select_channels`` returns the target channels of one record;
``split_batch`` routes a whole RecordBatch as (channel, sub-batch)
pairs with rows in their original order inside each channel.  The
key-group split takes the batch's precomputed ``routing`` hashes when
the batch carries them (no operator of the port sets them yet: the
reference's fused ``attach`` mode does, and is not ported), else it
hashes the key column once (splitmix64 over an int64 column,
bit-identical to the per-record hash) and partitions with one stable
argsort.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional

import numpy as np

from flink_tpu_torch.core.functions import KeySelector, _FieldKeySelector
from flink_tpu_torch.core.keygroups import (assign_operator_indexes_np,
                                            assign_to_key_group,
                                            compute_operator_index_for_key_group,
                                            splitmix64_np, stable_hashes_np)
from flink_tpu_torch.streaming.operators import _batch_row_value


class StreamPartitioner:
    #: wired to a contiguous group of downstream subtasks, not to all
    is_pointwise = False

    def select_channels(self, value, num_channels: int) -> list:
        return [0]

    def split_batch(self, batch, num_channels: int):
        """(channel, sub-batch) pairs, or None: no batch split, the
        router boxes the batch and routes per record."""
        return None

    def setup(self, num_channels: int) -> None:  # noqa: B027
        pass


class ForwardPartitioner(StreamPartitioner):
    is_pointwise = True

    def split_batch(self, batch, num_channels):
        return [(0, batch)]

    def __repr__(self):
        return "FORWARD"


class RebalancePartitioner(StreamPartitioner):
    """Round robin; whole batches go round robin too."""

    def __init__(self):
        self._next = -1

    def setup(self, num_channels):
        self._next = random.randrange(num_channels) - 1 if num_channels else -1

    def select_channels(self, value, num_channels):
        self._next = (self._next + 1) % num_channels
        return [self._next]

    def split_batch(self, batch, num_channels):
        self._next = (self._next + 1) % num_channels
        return [(self._next, batch)]

    def __repr__(self):
        return "REBALANCE"


class RescalePartitioner(StreamPartitioner):
    """Round robin over the pointwise group of downstream subtasks this
    upstream subtask is wired to; whole batches go round robin too."""

    is_pointwise = True

    def __init__(self):
        self._next = -1

    def select_channels(self, value, num_channels):
        self._next = (self._next + 1) % num_channels
        return [self._next]

    def split_batch(self, batch, num_channels):
        self._next = (self._next + 1) % num_channels
        return [(self._next, batch)]

    def __repr__(self):
        return "RESCALE"


class ShufflePartitioner(StreamPartitioner):
    """A uniformly random channel per record, and per whole batch."""

    def select_channels(self, value, num_channels):
        return [random.randrange(num_channels)]

    def split_batch(self, batch, num_channels):
        return [(random.randrange(num_channels), batch)]

    def __repr__(self):
        return "SHUFFLE"


class BroadcastPartitioner(StreamPartitioner):
    """Every record to every channel."""

    def select_channels(self, value, num_channels):
        return list(range(num_channels))

    def split_batch(self, batch, num_channels):
        return [(c, batch) for c in range(num_channels)]

    def __repr__(self):
        return "BROADCAST"


class GlobalPartitioner(StreamPartitioner):
    """Everything to subtask 0."""

    def select_channels(self, value, num_channels):
        return [0]

    def split_batch(self, batch, num_channels):
        return [(0, batch)]

    def __repr__(self):
        return "GLOBAL"


class CustomPartitionerWrapper(StreamPartitioner):
    """``partitioner(key, num_channels)`` picks the channel; the key is
    the key selector's, or the whole value without one."""

    def __init__(self, partitioner: Callable[[Any, int], int],
                 key_selector: Optional[KeySelector] = None):
        self.partitioner = partitioner
        self.key_selector = key_selector

    def select_channels(self, value, num_channels):
        key = self.key_selector.get_key(value) if self.key_selector else value
        return [self.partitioner(key, num_channels) % num_channels]

    def __repr__(self):
        return "CUSTOM"


class KeyGroupStreamPartitioner(StreamPartitioner):
    """keyBy edge: hash(key) -> key group -> subtask index."""

    def __init__(self, key_selector: KeySelector, max_parallelism: int):
        self.key_selector = key_selector
        self.max_parallelism = max_parallelism
        #: vectorized selector: None = undecided, True = rides columns
        #: (probe passed), False = per-row keys
        self._key_kernel = None

    def select_channels(self, value, num_channels):
        kg = assign_to_key_group(self.key_selector.get_key(value),
                                 self.max_parallelism)
        return [compute_operator_index_for_key_group(
            self.max_parallelism, num_channels, kg)]

    def split_batch(self, batch, num_channels):
        """One hash pass over the key column, one stable argsort, the
        sub-batch of each channel gathered in row order."""
        n = len(batch)
        if n == 0:
            return []
        pre = batch.routing
        if pre is not None and pre.shape == (n,):
            hashes = pre
        else:
            keys = self._vector_keys(batch, n)
            if keys is not None:
                hashes = splitmix64_np(keys)
            else:
                get_key = self.key_selector.get_key
                hashes = stable_hashes_np([get_key(v)
                                           for v in batch.row_values()])
        idx = assign_operator_indexes_np(hashes, self.max_parallelism,
                                         num_channels)
        order = np.argsort(idx, kind="stable")
        bounds = np.searchsorted(idx[order], np.arange(num_channels + 1))
        out = []
        for c in range(num_channels):
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            if lo < hi:
                out.append((c, batch.take(order[lo:hi])))
        return out

    def _vector_keys(self, batch, n):
        """The int64 key column from the vectorized selector, or None
        (per-row keys).  Only int64 keys qualify: any other key type
        hashes through the scalar stable_hash64."""
        kk = self._key_kernel
        if kk is False:
            return None
        if kk is None and not self._decide_key_kernel():
            return None
        try:
            out = self.key_selector.get_key(batch.value_arrays())
        except Exception:  # noqa: BLE001
            self._key_kernel = False
            return None
        if not (isinstance(out, np.ndarray) and out.shape == (n,)
                and out.dtype == np.int64):
            self._key_kernel = False
            return None
        if kk is None:
            # first batch: the edge rows against the scalar selector
            get_key = self.key_selector.get_key
            for i in (0, n - 1):
                if get_key(_batch_row_value(batch, i)) != int(out[i]):
                    self._key_kernel = False
                    return None
            self._key_kernel = True
        return out

    def _decide_key_kernel(self) -> bool:
        sel = self.key_selector
        if isinstance(sel, _FieldKeySelector) and isinstance(sel._field, int):
            return True
        try:
            from flink_tpu_torch.analysis.liftability import (LIFTABLE,
                                                              analyze_udf)
            fn = getattr(sel, "_fn", None)
            if not callable(fn):
                fn = getattr(sel, "get_key", sel)
            if analyze_udf(fn).verdict == LIFTABLE:
                return True
        except Exception:  # noqa: BLE001
            pass
        self._key_kernel = False
        return False

    def __repr__(self):
        return "HASH"
