"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain
PyTorch versions.

=================  ==================================================
``hll_update``     HLL register scatter-max (raw or compressed input)
``hll_estimate``   per-slot HLL estimate, dense range or gathered
``scatter_combine``  scatter-add/-min/-max of one f32/i32 column
``clear_rows``     fill slot rows (list or range) with a bit pattern
``merge_rows``     ``state[dst] (op)= state[src]`` row merge (session
                   windows), repeated or unique dst; ``merge_rows_many``
                   merges every component of a state in one launch
``set_rows``       write host/device rows into listed slots (restore,
                   host-tier promotion)
``countmin_update``  Count-Min scatter-add of weights into d hashed
                   columns and the slot total
``countmin_query``   Count-Min point queries (min over the d rows)
``quantile_update``  log-bucket histogram add (quantile sketch)
``quantile_result``  per-slot quantiles by a scan of the histogram,
                   dense range or gathered
``hll_log_finish``   the log tier's HLL finish: per-key estimates from
                   compacted (key-run) cells, float64
``table_insert``   insert-or-lookup of (hi, lo) key lanes in the
                   device hash table (plain or regional probing)
``chain_route``    stable partition of a fused chain's rows by channel
                   (or keep flag), moving their columns and pane starts;
                   with row shards, each shard's block on its own
``shard_pack``     the keyBy exchange's pack: each source shard's rows
                   into per-target buckets, stable, capped, with counts
``gather_segment_sum``  ``out[i] = sum of x[src]`` over the edges into
                   i, on a ``segment_plan`` of the edges built once
                   (PageRank, HITS)
``edge_popcount``  common neighbours per vertex pair from a packed
                   adjacency bitset (triangles, clustering), on a
                   ``popcount_plan`` of the rows' nonzero words and the
                   pairs by their denser row, built each call
``gram_accumulate``  per-row Gram matrices and right-hand sides of an
                   ALS half-step from ratings grouped by row, on a
                   ``gram_plan`` of chunks built once per fit and side
``knn_topk``       k smallest squared distances per query row from a
                   GEMM output, lower index first on ties
=================  ==================================================

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  Nothing builds at import (see
``loader``).
"""

from flink_tpu_torch.kernels.chain_route import (chain_route, chain_route_launch,
                                                 chain_route_plain)
from flink_tpu_torch.kernels.clear_rows import clear_rows, clear_rows_plain
from flink_tpu_torch.kernels.countmin_query import (countmin_query,
                                                    countmin_query_plain)
from flink_tpu_torch.kernels.countmin_update import (countmin_update,
                                                     countmin_update_plain)
from flink_tpu_torch.kernels.edge_popcount import (
    PopcountPlan, edge_pairs, edge_pairs_plain, edge_popcount,
    edge_popcount_plain, popcount_plan, scan_plain)
from flink_tpu_torch.kernels.gather_segment_sum import (
    SegmentPlan, gather_segment_sum, gather_segment_sum_plain, segment_plan)
from flink_tpu_torch.kernels.gram_accumulate import (
    GramPlan, gram_accumulate, gram_accumulate_plain, gram_plan)
from flink_tpu_torch.kernels.hll_estimate import (hll_estimate,
                                                  hll_estimate_plain)
from flink_tpu_torch.kernels.hll_log_finish import (hll_log_finish,
                                                    hll_log_finish_plain)
from flink_tpu_torch.kernels.hll_update import hll_update, hll_update_plain
from flink_tpu_torch.kernels.knn_topk import knn_topk, knn_topk_plain
from flink_tpu_torch.kernels.loader import (KERNELS, LAUNCHES, build_all,
                                            reset_launch_counts)
from flink_tpu_torch.kernels.merge_rows import (merge_rows, merge_rows_many,
                                                merge_rows_many_plain,
                                                merge_rows_plain)
from flink_tpu_torch.kernels.quantile_result import (quantile_result,
                                                     quantile_result_plain)
from flink_tpu_torch.kernels.quantile_update import (quantile_update,
                                                     quantile_update_plain)
from flink_tpu_torch.kernels.scatter_combine import (scatter_combine,
                                                     scatter_combine_plain)
from flink_tpu_torch.kernels.set_rows import set_rows, set_rows_plain
from flink_tpu_torch.kernels.shard_pack import shard_pack, shard_pack_plain
from flink_tpu_torch.kernels.table_insert import (table_insert,
                                                  table_insert_plain)

__all__ = [
    "KERNELS", "LAUNCHES", "build_all", "reset_launch_counts",
    "chain_route", "chain_route_launch", "chain_route_plain",
    "clear_rows", "clear_rows_plain", "countmin_query", "countmin_query_plain",
    "countmin_update", "countmin_update_plain", "edge_popcount",
    "edge_popcount_plain", "PopcountPlan", "popcount_plan", "scan_plain",
    "edge_pairs", "edge_pairs_plain", "gather_segment_sum", "gather_segment_sum_plain",
    "SegmentPlan", "segment_plan",
    "GramPlan", "gram_plan",
    "gram_accumulate", "gram_accumulate_plain", "hll_estimate",
    "hll_estimate_plain", "hll_log_finish", "hll_log_finish_plain",
    "hll_update", "hll_update_plain", "knn_topk", "knn_topk_plain",
    "merge_rows", "merge_rows_many", "merge_rows_many_plain", "merge_rows_plain",
    "quantile_result", "quantile_result_plain", "quantile_update",
    "quantile_update_plain", "scatter_combine", "scatter_combine_plain",
    "set_rows", "set_rows_plain", "shard_pack", "shard_pack_plain",
    "table_insert", "table_insert_plain",
]
