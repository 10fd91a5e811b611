"""The port's device hash table (ops/device_table.py, the table_insert
plain version on the CPU) against the JAX package's
(tests/test_parallel.py's table cases).  The plain version replays the
JAX claim rounds, so tables, slots and ok flags are equal position for
position, in the plain and the regional form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_tpu.core.keygroups import splitmix64_np
from flink_tpu.ops import device_table as jt
from flink_tpu_torch.ops import device_table as tt


def _lanes(h64):
    h64 = np.asarray(h64, np.uint64)
    return ((h64 >> np.uint64(32)).astype(np.uint32),
            (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _both_insert(cap, hi, lo, mask, max_probes=64, region=None, region_size=0,
                 tables=None):
    jtab, ttab = tables or (jt.make_table(cap), tt.make_table(cap, device="cpu"))
    if region is None:
        jtab, js, jok = jt.insert_or_lookup(jtab, jnp.asarray(hi), jnp.asarray(lo),
                                            jnp.asarray(mask), max_probes=max_probes)
        ttab, ts, tok = tt.insert_or_lookup(ttab, hi, lo, mask, max_probes)
    else:
        jtab, js, jok = jt.insert_or_lookup_regions_impl(
            jtab, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(region),
            jnp.asarray(mask), region_size, max_probes)
        ttab, ts, tok = tt.insert_or_lookup_regions(ttab, hi, lo, region, mask,
                                                    region_size, max_probes)
    for a, b in zip((np.asarray(x) for x in jtab), tt.table_to_numpy(ttab)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    return (jtab, ttab), ts.numpy(), tok.numpy()


def test_insert_and_dedup_equal_to_reference():
    h = splitmix64_np(np.arange(10, dtype=np.uint64))
    hi, lo = _lanes(h)
    tables, slots, ok = _both_insert(64, hi, lo, np.ones(10, bool))
    assert ok.all() and len(set(slots.tolist())) == 10
    # the same keys again: the same slots
    tables, slots2, _ = _both_insert(64, hi, lo, np.ones(10, bool), tables=tables)
    np.testing.assert_array_equal(slots2, slots)
    # duplicates within one batch: one slot
    _, dslots, _ = _both_insert(64, np.repeat(hi[:1], 5), np.repeat(lo[:1], 5),
                                np.ones(5, bool), tables=tables)
    assert set(dslots.tolist()) == {slots[0]}


def test_key_zero_is_a_key():
    hi = np.array([0, 0, 1, 0], np.uint32)
    lo = np.array([0, 0, 0, 7], np.uint32)
    (_, ttab), slots, ok = _both_insert(16, hi, lo, np.ones(4, bool))
    assert ok.all() and slots[0] == slots[1] and len(set(slots.tolist())) == 3
    assert int(ttab.occupied.sum()) == 3


def test_host_lookup_agrees():
    h = splitmix64_np(np.arange(40, dtype=np.uint64))
    hi, lo = _lanes(h)
    (jtab, ttab), slots, _ = _both_insert(128, hi, lo, np.ones(40, bool))
    np.testing.assert_array_equal(tt.lookup_np(ttab, h), slots)
    np.testing.assert_array_equal(tt.lookup_np(ttab, h), jt.lookup_np(jtab, h))
    missing = splitmix64_np(np.arange(1000, 1010, dtype=np.uint64))
    assert (tt.lookup_np(ttab, missing) == -1).all()


@pytest.mark.parametrize("cap, n, max_probes", [(8, 32, 8), (64, 80, 4), (500, 490, 16)])
def test_overflow_signals(cap, n, max_probes):
    """Overflow is reported, never lost, and at most capacity keys
    resolve.  (The kernel bounds probe positions where the JAX package
    bounds claim rounds, so on the card the two may disagree on which
    keys overflow near capacity; tests/test_torch_kernels_gpu.py holds
    the kernel to these same invariants.)"""
    h = splitmix64_np(np.arange(n, dtype=np.uint64))
    hi, lo = _lanes(h)
    (_, ttab), slots, ok = _both_insert(cap, hi, lo, np.ones(n, bool), max_probes)
    assert ok.sum() <= cap
    assert (~ok).any()
    assert ((slots >= 0) == ok).all()
    assert int(ttab.occupied.sum()) == len(set(slots[ok].tolist()))


def test_overflow_count_on_the_device_counter():
    table = tt.make_table(8, device="cpu")
    hi, lo = _lanes(splitmix64_np(np.arange(32, dtype=np.uint64)))
    counter = torch.zeros(1, dtype=torch.int64)
    slots = tt.table_insert(table.key_hi, table.key_lo, table.occupied,
                            torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(lo.view(np.int32)), 32, 8,
                            overflow=counter)
    assert int(counter) == int((slots < 0).sum()) > 0


def test_padding_not_inserted():
    hi, lo = _lanes(splitmix64_np(np.arange(4, dtype=np.uint64)))
    mask = np.array([True, True, False, False])
    (_, ttab), slots, ok = _both_insert(32, hi, lo, mask)
    assert int(ttab.occupied.sum()) == 2
    assert (slots[2:] == -1).all() and ok.all()
    # rows at or beyond n are padding as well
    table = tt.make_table(32, device="cpu")
    tt.table_insert(table.key_hi, table.key_lo, table.occupied,
                    torch.from_numpy(hi.view(np.int32)),
                    torch.from_numpy(lo.view(np.int32)), 1)
    assert int(table.occupied.sum()) == 1


def test_regions_equal_to_reference():
    rng = np.random.default_rng(3)
    n, regions, size = 600, 4, 256
    h = splitmix64_np(rng.integers(0, 300, n).astype(np.uint64))
    hi, lo = _lanes(h)
    region = rng.integers(0, regions, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    (_, ttab), slots, ok = _both_insert(regions * size, hi, lo, mask, 64,
                                        region, size)
    live = slots >= 0
    assert ok.all()
    assert ((slots[live] // size) == region[live]).all()


def test_clear_entries_frees_positions():
    h = splitmix64_np(np.arange(20, dtype=np.uint64))
    hi, lo = _lanes(h)
    (jtab, ttab), slots, _ = _both_insert(64, hi, lo, np.ones(20, bool))
    jtab = jt.clear_entries(jtab, jnp.asarray(slots[:5]))
    ttab = tt.clear_entries(ttab, slots[:5])
    np.testing.assert_array_equal(np.asarray(jtab.occupied),
                                  tt.table_to_numpy(ttab)[2])
    assert int(ttab.occupied.sum()) == 15
    # no tombstones: a key whose chain runs through a freed position is
    # not found until it is inserted again (as in the JAX package)
    np.testing.assert_array_equal(tt.lookup_np(ttab, h), jt.lookup_np(jtab, h))
    assert (tt.lookup_np(ttab, h[:5]) == -1).all()


def test_table_round_trips_through_numpy_and_the_reference():
    h = splitmix64_np(np.arange(30, dtype=np.uint64))
    hi, lo = _lanes(h)
    (jtab, _), slots, _ = _both_insert(64, hi, lo, np.ones(30, bool))
    ttab = tt.table_from_numpy(*(np.asarray(a) for a in jtab), device="cpu")
    for a, b in zip((np.asarray(x) for x in jtab), tt.table_to_numpy(ttab)):
        np.testing.assert_array_equal(a, b)
    assert ttab.occupied.untyped_storage().nbytes() % 4 == 0
    np.testing.assert_array_equal(tt.lookup_np(ttab, h), slots)


def _faulty(ttab, slots, hi, lo, fault):
    """A copy of (table, slots) with one fault of the named kind."""
    key_hi, key_lo, occ = (a.copy() for a in tt.table_to_numpy(ttab))
    slots = slots.copy()
    # free positions by their distance ahead of key 3's, along its chain
    ahead = (np.nonzero(~occ)[0] - slots[3]) % len(occ)
    near = int((slots[3] + ahead[ahead < 64].min()) % len(occ))
    far = int((slots[3] + ahead[ahead > 64].min()) % len(occ))
    if fault == "wrong_key":
        key_lo[slots[3]] ^= 1
    elif fault == "padding":
        slots[-1] = slots[0]
    elif fault == "off_chain":                    # move key 3 off its chain
        free = far
        key_hi[free], key_lo[free], occ[free] = hi[3], lo[3], True
        occ[slots[3]] = False
        slots[3] = free
    elif fault == "split":                        # key 3 again, further on its chain
        free = near
        key_hi[free], key_lo[free], occ[free] = hi[3], lo[3], True
        slots[4], hi, lo = free, hi.copy(), lo.copy()
        hi[4], lo[4] = hi[3], lo[3]
    return tt.table_from_numpy(key_hi, key_lo, occ, device="cpu"), slots, hi, lo


@pytest.mark.parametrize("fault", ["none", "wrong_key", "padding", "off_chain", "split"])
def test_key_map_faults_counts_each_fault(fault):
    """The key -> slot check that holds the kernel's table on the card
    finds no fault in the plain version's table, and each planted one."""
    h = splitmix64_np(np.arange(300, dtype=np.uint64))
    hi, lo = _lanes(h)
    live = np.arange(300) < 290                   # a padded tail
    (_, ttab), slots, _ = _both_insert(1024, hi, lo, live)
    ref = tt.table_from_numpy(*tt.table_to_numpy(ttab), device="cpu")
    tab, s, fh, fl = _faulty(ttab, slots, hi, lo, fault) if fault != "none" \
        else (ttab, slots, hi, lo)
    faults, probes = tt.key_map_faults(tab, fh, fl, s, live=live,
                                       reference=ref)
    want = {k: 0 for k in ("padding", "wrong_key", "off_chain", "split", "key_set")}
    if fault != "none":
        want[fault] = 1
    if fault == "wrong_key":
        want["key_set"] = 2                       # one key gone, one new
    assert faults == want
    if fault == "none":
        # a probe walks to its key's position: lookup_np agrees
        np.testing.assert_array_equal(tt.lookup_np(ttab, h)[live], slots[live])
        assert probes >= live.sum()


def test_key_map_faults_regions():
    h = splitmix64_np(np.arange(200, dtype=np.uint64))
    hi, lo = _lanes(h)
    region = (np.arange(200) % 4).astype(np.int32)
    hi[100:], lo[100:], region[100:] = hi[:100], lo[:100], (region[:100] + 1) % 4
    (_, ttab), slots, ok = _both_insert(4 * 128, hi, lo, np.ones(200, bool),
                                        region=region, region_size=128)
    assert ok.all()
    ref = tt.table_from_numpy(*tt.table_to_numpy(ttab), device="cpu")
    faults, _ = tt.key_map_faults(ttab, hi, lo, slots, region=region,
                                  region_size=128, reference=ref)
    assert faults == {"padding": 0, "wrong_key": 0, "off_chain": 0, "split": 0,
                      "key_set": 0}
    # the same slots read as one flat table: keys sit off their flat chains
    flat, _ = tt.key_map_faults(ttab, hi, lo, slots)
    assert flat["off_chain"] > 0
