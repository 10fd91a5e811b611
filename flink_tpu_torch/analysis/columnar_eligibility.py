"""Ahead-of-time columnar eligibility of operator instances (port of
``flink_tpu/analysis/columnar_eligibility.py``).

One answer to "will this operator consume RecordBatches without
boxing?", shared by the graph linter's FT184 chain report and the
tests.  Three modes:

- ``kernel``: a map/filter whose UDF the liftability analyzer proved
  LIFTABLE; the operator applies it to numpy columns (after the
  first-batch probe, or without it when the type-flow prover stamped
  ``_static_kernel``).
- ``native``: the operator ingests columns structurally (its own
  ``process_batch``, a sink with ``invoke_batch``).
- ``boxed``: everything else; ``StreamOperator.process_batch`` boxes
  the batch into per-row ``process_element`` calls.

A ``kernel`` operator can still demote itself at run time; a ``boxed``
verdict here is final.  ``chain_report`` adds the fused-chain verdict
(``streaming/chain_fusion.py``'s ``fusion_report``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

KERNEL = "kernel"
NATIVE = "native"
BOXED = "boxed"


def operator_batch_report(op) -> Tuple[str, str]:
    """(mode, reason) for one instantiated operator.  `reason` is
    non-empty only for ``boxed`` — it names what forces the fallback."""
    from flink_tpu_torch.streaming.operators import (
        StreamFilter,
        StreamMap,
        StreamSink,
        TwoInputStreamOperator,
        _udf_liftable,
    )
    from flink_tpu_torch.streaming.sources import StreamSource

    if isinstance(op, (StreamMap, StreamFilter)):
        ok, reason = _udf_liftable(op.user_function, op._KERNEL_ATTR)
        return (KERNEL, "") if ok else (BOXED, reason)
    if isinstance(op, StreamSink):
        if hasattr(op.user_function, "invoke_batch"):
            return NATIVE, ""
        return BOXED, "sink has no invoke_batch"
    if isinstance(op, StreamSource):
        # sources emit, never consume; vectorized emit is a property
        # of the source function, not a consumption mode
        fn = getattr(op, "user_function", None)
        if hasattr(fn, "emit_step") and getattr(fn, "emits_batches",
                                                False):
            return NATIVE, ""
        return BOXED, "source emits per-row"
    if isinstance(op, TwoInputStreamOperator):
        return BOXED, "two-input operator (per-input key contexts)"

    # operators with a process_batch override may still demote
    # themselves structurally (merging assigner, custom trigger,
    # evictor on the window operator) — they know the reason AOT
    elig = getattr(type(op), "_batch_eligibility", None)
    if elig is not None:
        reason = elig(op)
        if reason:
            return BOXED, reason

    # structural consumers declare themselves via a process_batch
    # override — anything still on the StreamOperator default boxes
    from flink_tpu_torch.streaming.operators import StreamOperator
    pb = type(op).process_batch
    if pb is not StreamOperator.process_batch:
        return NATIVE, ""
    return BOXED, f"no batch kernel on {type(op).__name__}"


def operator_decided_by(op) -> str:
    """Who decided this operator's column-kernel path so far:
    ``"static"`` (type-flow verdict, probe-free), ``"probe"``
    (first-batch probe), ``"fused"`` (the operator is a member of a
    fused-chain program that ran at least one batch — see
    streaming/chain_fusion.py), ``"pending"`` (kernel-eligible but no
    batch seen yet; "static" when the typeflow stamp guarantees the
    probe will be skipped), or ``""`` for operators without a kernel
    path."""
    from flink_tpu_torch.streaming.operators import _ColumnKernelMixin
    # fused membership applies to ANY operator type (window operators
    # ride fused chains without the mixin)
    decided = getattr(op, "columnar_decided_by", None)
    if decided == "fused" or getattr(op, "_fused_member", None) is not None:
        return decided or "fused"
    if not isinstance(op, _ColumnKernelMixin):
        return ""
    if decided:
        return decided
    if getattr(op, "_static_kernel", False):
        return "static"
    mode, _ = operator_batch_report(op)
    return "pending" if mode == KERNEL else ""


def chain_report(operators: List) -> dict:
    """Columnar eligibility of one operator chain (head first):
    ``{"modes": [(name, mode, reason)...], "decided_by": [...],
    "eligible": bool, "first_blocker": name | None,
    "prefix_len": int}``.

    ``eligible`` means the HEAD consumes batches (so a batch-mode
    subscription pays off at all); ``prefix_len`` counts how many
    operators a batch survives before the first boxed hop reboxes it;
    ``first_blocker`` names that hop.  ``decided_by`` parallels
    ``modes``: per-operator :func:`operator_decided_by`.

    ``fusion`` is the chain-fusion verdict on top: whether a prefix of
    this chain lowers into ONE fused columnar program
    (streaming/chain_fusion.py), which operators ride it, and the
    first operator that blocks fusion (with the reason)."""
    modes = []
    decided_by = []
    first_blocker: Optional[str] = None
    prefix = 0
    for op in operators:
        mode, reason = operator_batch_report(op)
        name = type(op).__name__
        modes.append((name, mode, reason))
        decided_by.append(operator_decided_by(op))
        if mode == BOXED and first_blocker is None:
            first_blocker = name
        elif first_blocker is None:
            prefix += 1
    from flink_tpu_torch.streaming.chain_fusion import fusion_report
    return {
        "modes": modes,
        "decided_by": decided_by,
        "eligible": bool(modes) and modes[0][1] != BOXED,
        "first_blocker": first_blocker,
        "prefix_len": prefix,
        "fusion": fusion_report(operators),
    }


def subtask_accepts_batches(subtask) -> bool:
    """Does this consumer's chain head take batches without boxing?
    (The reference asks it before a remote subscription in batch mode;
    the port has no network channel yet and no pipeline kill switch.)"""
    try:
        mode, _ = operator_batch_report(subtask.head)
    except Exception:  # noqa: BLE001
        return False
    return mode != BOXED
