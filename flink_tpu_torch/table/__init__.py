"""Table API and streaming SQL of the port (port of
``flink_tpu/table``'s streaming half): ``StreamTableEnvironment``,
``Table`` and the window builders, lowered onto the port's DataStream
operators and window engines.  The batch twin (``BatchTable``,
``BatchTableEnvironment``) comes with the DataSet API."""

from flink_tpu_torch.table.api import (Session, Slide, StreamTableEnvironment,
                                       Table, Tumble)
from flink_tpu_torch.table.expressions import col, lit
from flink_tpu_torch.table.functions import TableFunction
from flink_tpu_torch.table.sql_parser import SqlError

__all__ = [
    "StreamTableEnvironment",
    "Table",
    "TableFunction",
    "Tumble",
    "Slide",
    "Session",
    "col",
    "lit",
    "SqlError",
]
