"""Connectors (port of ``flink_tpu/connectors``): the partitioned,
replayable log with its exactly-once source and transactional sink,
the exactly-once bucketing file sink, and the idempotent upsert sink.
The JDBC connector and the sharded stream come with the modules they
need (``core/formats.py``, ``core/serialization.py``)."""

from flink_tpu_torch.connectors.bucketing_sink import BucketingFileSink
from flink_tpu_torch.connectors.log_connector import (ReplayableLogSource,
                                                      TransactionalLogSink)
from flink_tpu_torch.connectors.partitioned_log import (FilePartitionedLog,
                                                        InMemoryPartitionedLog,
                                                        PartitionedLog)
from flink_tpu_torch.connectors.upsert_sink import (DocumentStore,
                                                    FileDocumentStore,
                                                    UpsertSink)

__all__ = [
    "FilePartitionedLog",
    "InMemoryPartitionedLog",
    "PartitionedLog",
    "ReplayableLogSource",
    "TransactionalLogSink",
    "BucketingFileSink",
    "DocumentStore",
    "FileDocumentStore",
    "UpsertSink",
]
