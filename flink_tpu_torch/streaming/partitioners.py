"""Edge partitioners (subset of ``flink_tpu/streaming/partitioners.py``).

Slice 1 runs every operator at parallelism 1, so a keyed edge delivers
every record to channel 0; the key-group routing for parallel
subtasks arrives with the keyed-state slice.
"""

from __future__ import annotations


class StreamPartitioner:
    def select_channel(self, record, num_channels: int) -> int:
        return 0


class ForwardPartitioner(StreamPartitioner):
    def __repr__(self):
        return "FORWARD"


class KeyGroupStreamPartitioner(StreamPartitioner):
    """keyBy edge: keys partition by key group across subtasks."""

    def __init__(self, key_selector, max_parallelism: int):
        self.key_selector = key_selector
        self.max_parallelism = max_parallelism

    def __repr__(self):
        return "HASH"
