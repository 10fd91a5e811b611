"""Windowed join, coGroup and the interval join (port of
``flink_tpu/streaming/joining.py``).

Both inputs map into (tag, value) carriers, union, and key by their
side's key selector.  ``join`` and ``co_group`` then run a window apply
over the buffered window contents, which splits the tags apart again
(``join`` pairs the two groups, ``co_group`` hands both lists to the
function).  ``interval_join`` runs a keyed process function that keeps
each side's rows by timestamp in value state, pairs a new row with the
other side's rows inside the bound, and drops rows at event-time timers
once the watermark has passed the last time they could pair.  No
two-input operator is needed.
"""

from __future__ import annotations

from typing import Any, Callable

from flink_tpu_torch.core.functions import as_key_selector


class JoinedStreams:
    """stream1.join(stream2).where(k1).equal_to(k2).window(w).apply(f)"""

    def __init__(self, first, second, cogroup: bool = False):
        self.first = first
        self.second = second
        self._cogroup = cogroup

    def where(self, key_selector) -> "_Where":
        return _Where(self, as_key_selector(key_selector))


class CoGroupedStreams(JoinedStreams):
    def __init__(self, first, second):
        super().__init__(first, second, cogroup=True)


class _Where:
    def __init__(self, joined: JoinedStreams, ks1):
        self.joined = joined
        self.ks1 = ks1

    def equal_to(self, key_selector) -> "_EqualTo":
        return _EqualTo(self.joined, self.ks1,
                        as_key_selector(key_selector))


class _EqualTo:
    def __init__(self, joined, ks1, ks2):
        self.joined = joined
        self.ks1 = ks1
        self.ks2 = ks2

    def window(self, assigner) -> "_WithWindow":
        return _WithWindow(self.joined, self.ks1, self.ks2, assigner)


class _WithWindow:
    def __init__(self, joined, ks1, ks2, assigner):
        self.joined = joined
        self.ks1 = ks1
        self.ks2 = ks2
        self.assigner = assigner
        self._trigger = None
        self._evictor = None
        self._lateness = 0

    def trigger(self, trigger) -> "_WithWindow":
        self._trigger = trigger
        return self

    def evictor(self, evictor) -> "_WithWindow":
        self._evictor = evictor
        return self

    def allowed_lateness(self, lateness) -> "_WithWindow":
        self._lateness = lateness
        return self

    def apply(self, fn: Callable[..., Any], name: str = None):
        """join: fn(left, right) per pair; coGroup: fn(lefts, rights)
        returning an iterable of outputs."""
        joined = self.joined
        keyed = _tagged_union_keyed(joined.first, joined.second,
                                    self.ks1, self.ks2, "join")
        win = keyed.window(self.assigner)
        if self._trigger is not None:
            win = win.trigger(self._trigger)
        if self._evictor is not None:
            win = win.evictor(self._evictor)
        if self._lateness:
            win = win.allowed_lateness(self._lateness)
        cogroup = joined._cogroup

        def window_fn(key, window, elements):
            lefts = [v for t, v in elements if t == 0]
            rights = [v for t, v in elements if t == 1]
            if cogroup:
                out = fn(lefts, rights)
                return list(out) if out is not None else []
            return [fn(a, b) for a in lefts for b in rights]

        return win.apply(window_fn,
                         name=name or ("co_group" if cogroup else "join"))


def _tagged_union_keyed(first, second, ks1, ks2, prefix: str):
    """TaggedUnion construction shared by the window join and the
    interval join (CoGroupedStreams.java's TaggedUnion +
    UnionKeySelector): both inputs map into (tag, value) carriers,
    union, and key by the side's key selector."""
    tagged1 = first.map(lambda v: (0, v), name=f"{prefix}_tag_left")
    tagged2 = second.map(lambda v: (1, v), name=f"{prefix}_tag_right")
    return tagged1.union(tagged2).key_by(
        lambda tv: ks1.get_key(tv[1]) if tv[0] == 0
        else ks2.get_key(tv[1]))


# ---------------------------------------------------------------------
# Interval (time-bounded stream-stream) join
# (ref: the Table layer's windowed join — WindowJoinUtil.scala bounds
# analysis + the time-bounded join ProcessFunction family; surfaced in
# later reference versions as DataStream.intervalJoin)
# ---------------------------------------------------------------------

class IntervalJoinedStreams:
    """left.interval_join(right).where(k1).equal_to(k2)
    .between(lower_ms, upper_ms).apply(fn): emits fn(l, r) for every
    pair with r.ts - l.ts in [lower, upper] and equal keys, with the
    pair's max timestamp; state is cleaned by event-time timers."""

    def __init__(self, first, second):
        self.first = first
        self.second = second

    def where(self, key_selector):
        return _IvWhere(self, as_key_selector(key_selector))


class _IvWhere:
    def __init__(self, joined, ks1):
        self.joined = joined
        self.ks1 = ks1

    def equal_to(self, key_selector):
        return _IvEqual(self.joined, self.ks1,
                        as_key_selector(key_selector))


class _IvEqual:
    def __init__(self, joined, ks1, ks2):
        self.joined = joined
        self.ks1 = ks1
        self.ks2 = ks2

    def between(self, lower_ms: int, upper_ms: int):
        if lower_ms > upper_ms:
            raise ValueError("interval join: lower bound > upper bound")
        return _IvBetween(self.joined, self.ks1, self.ks2,
                          lower_ms, upper_ms)


class _IvBetween:
    def __init__(self, joined, ks1, ks2, lower, upper):
        self.joined = joined
        self.ks1 = ks1
        self.ks2 = ks2
        self.lower = lower
        self.upper = upper

    def apply(self, fn, name: str = None):
        from flink_tpu_torch.core.state import ValueStateDescriptor
        from flink_tpu_torch.streaming.operators import ProcessFunction

        lower, upper = self.lower, self.upper
        left_desc = ValueStateDescriptor("iv_join_left")
        right_desc = ValueStateDescriptor("iv_join_right")

        class _IvJoinFn(ProcessFunction):
            def process_element(self, value, ctx, out):
                tag, v = value
                ts = ctx.timestamp()
                mine = left_desc if tag == 0 else right_desc
                other = right_desc if tag == 0 else left_desc
                buf = ctx.get_state(mine).value() or {}
                buf.setdefault(ts, []).append(v)
                ctx.get_state(mine).update(buf)
                # this row stays joinable until the watermark passes
                # the last other-side timestamp it could pair with
                cleanup = ts + (upper if tag == 0 else -lower)
                ctx.register_event_time_timer(max(cleanup, ts))
                obuf = ctx.get_state(other).value() or {}
                if tag == 0:
                    lo, hi = ts + lower, ts + upper
                else:
                    lo, hi = ts - upper, ts - lower
                for ots, rows in obuf.items():
                    if lo <= ots <= hi:
                        out.set_absolute_timestamp(max(ts, ots))
                        for o in rows:
                            out.collect(fn(v, o) if tag == 0
                                        else fn(o, v))

            def on_timer(self, timestamp, ctx, out):
                wm = timestamp
                for desc, horizon in ((left_desc, upper),
                                      (right_desc, -lower)):
                    st = ctx.get_state(desc)
                    buf = st.value()
                    if not buf:
                        continue
                    kept = {t: r for t, r in buf.items()
                            if t + horizon > wm}
                    if len(kept) != len(buf):
                        st.update(kept)

        joined = self.joined
        keyed = _tagged_union_keyed(joined.first, joined.second,
                                    self.ks1, self.ks2, "iv_join")
        return keyed.process(_IvJoinFn(), name=name or "interval_join")
