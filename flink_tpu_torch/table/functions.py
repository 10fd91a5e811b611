"""Built-in SQL aggregate functions (port of
``flink_tpu/table/functions.py``).

COUNT/SUM/MIN/MAX/AVG are the scalar AggregateFunction twins of the
reference's codegen'd GeneratedAggregations
(runtime/aggregate/GeneratedAggregations.scala:27 — accumulate :63,
createAccumulators :79, mergeAccumulatorsPair :95); here they are
plain accumulator classes (no Janino).

APPROX_COUNT_DISTINCT — absent from the reference's 1.5 SQL (the
north-star extension) — is the port's HyperLogLog aggregate at
precision 12 (flink_tpu_torch.ops.sketches.HyperLogLogAggregate): a
DeviceAggregateFunction, so a query whose single aggregate is
APPROX_COUNT_DISTINCT lowers onto the device window engines
(DeviceWindowOperator, or the columnar plan).  COUNT(DISTINCT x)
maps to exact distinct counting with a set accumulator.
"""

from __future__ import annotations

from flink_tpu_torch.core.functions import AggregateFunction
from flink_tpu_torch.table.expressions import AggCall

#: type names of registered-UDAF classes known to be device-eligible
UDAF_DEVICE = {"HyperLogLogAggregate", "CountMinSketchAggregate",
               "QuantileSketchAggregate", "SumAggregate",
               "CountAggregate", "MinAggregate", "MaxAggregate",
               "AvgAggregate"}


class CountAgg(AggregateFunction):
    def create_accumulator(self):
        return 0

    def add(self, value, acc):
        return acc + (0 if value is None else 1)

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        return a + b


class SumAgg(AggregateFunction):
    def create_accumulator(self):
        return None

    def add(self, value, acc):
        if value is None:
            return acc
        return value if acc is None else acc + value

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b


class MinAgg(AggregateFunction):
    def create_accumulator(self):
        return None

    def add(self, value, acc):
        if value is None:
            return acc
        return value if acc is None else min(acc, value)

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)


class MaxAgg(AggregateFunction):
    def create_accumulator(self):
        return None

    def add(self, value, acc):
        if value is None:
            return acc
        return value if acc is None else max(acc, value)

    def get_result(self, acc):
        return acc

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)


class AvgAgg(AggregateFunction):
    def create_accumulator(self):
        return (0.0, 0)

    def add(self, value, acc):
        if value is None:
            return acc
        return (acc[0] + value, acc[1] + 1)

    def get_result(self, acc):
        return acc[0] / acc[1] if acc[1] else None

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


class DistinctAgg(AggregateFunction):
    """DISTINCT modifier: deduplicate inputs in a set accumulator,
    apply the inner aggregate over the distinct values at result time
    (the dataview MapView-backed distinct accumulator role).  The set
    mutates in place — accumulators are owned by the state entry, and
    an O(n) copy per record would make large groups quadratic."""

    def __init__(self, inner: AggregateFunction):
        self.inner = inner

    def create_accumulator(self):
        return set()

    def add(self, value, acc):
        if value is not None:
            acc.add(value)
        return acc

    def get_result(self, acc):
        inner_acc = self.inner.create_accumulator()
        for v in acc:
            inner_acc = self.inner.add(v, inner_acc)
        return self.inner.get_result(inner_acc)

    def merge(self, a, b):
        return a | b


class DistinctCountAgg(DistinctAgg):
    """Exact COUNT(DISTINCT x)."""

    def __init__(self):
        super().__init__(CountAgg())

    def get_result(self, acc):
        return len(acc)


class TableFunction:
    """User-defined table function (UDTF) contract: ``eval(*args)``
    yields zero or more output rows per input row (scalars for a
    single output column, tuples for several) — consumed via
    ``, LATERAL TABLE(fn(...)) AS t(col, ...)`` in SQL
    (ref: flink-table/.../functions/TableFunction.scala:69-90; the
    collect() protocol becomes a plain Python generator)."""

    def eval(self, *args):
        raise NotImplementedError


def make_builtin_agg(call: AggCall):
    name = call.name
    if name == "COUNT":
        if call.distinct:
            return DistinctCountAgg()
        return CountAgg()
    plain = {"SUM": SumAgg, "MIN": MinAgg, "MAX": MaxAgg,
             "AVG": AvgAgg}.get(name)
    if plain is not None:
        agg = plain()
        return DistinctAgg(agg) if call.distinct else agg
    if name == "APPROX_COUNT_DISTINCT":
        from flink_tpu_torch.ops.sketches import HyperLogLogAggregate
        return HyperLogLogAggregate(precision=12)
    raise ValueError(f"unknown aggregate {name}")
