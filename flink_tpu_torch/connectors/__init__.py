"""Connectors (port of ``flink_tpu/connectors``): the partitioned,
replayable log with its exactly-once source and transactional sink,
the exactly-once bucketing file sink, the idempotent upsert sink, the
JDBC-shaped connector and the sharded replayable stream."""

from flink_tpu_torch.connectors.bucketing_sink import BucketingFileSink
from flink_tpu_torch.connectors.jdbc import (JdbcInputFormat, JdbcOutputFormat,
                                             JdbcSink)
from flink_tpu_torch.connectors.log_connector import (ReplayableLogSource,
                                                      TransactionalLogSink)
from flink_tpu_torch.connectors.partitioned_log import (FilePartitionedLog,
                                                        InMemoryPartitionedLog,
                                                        PartitionedLog)
from flink_tpu_torch.connectors.sharded_stream import (FileShardedStream,
                                                       ShardedStreamSource)
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
    "JdbcInputFormat",
    "JdbcOutputFormat",
    "JdbcSink",
    "FileShardedStream",
    "ShardedStreamSource",
    "DocumentStore",
    "FileDocumentStore",
    "UpsertSink",
]
