// Host runtime of flink_tpu_torch: the C++ the log-structured window
// tier, the slot index and the string interner run on.
//
// A copy of the JAX package's native/host_runtime.cpp, kept in this
// package so that the port never loads the reference's library: the
// persistent slot index, splitmix64 and key groups, the radix sort and
// the HLL / Sum / sum-table / quantile / session log functions, the
// string interner, the per-window word sums, the fused intern+sum and
// the generic aggregate tier's grouping (fold_prep, group_cols,
// argsort_u64) and the interval join's batched core (ft_ivjoin_*).
// The compiled per-record baselines and CEP are not part of it.  The
// functions are the reference's, unchanged, so both packages give
// bit-equal results on the same inputs.
//
// Build: g++ -O3 -march=native -shared -fPIC (flink_tpu_torch/native
// loader, at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <memory>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

inline double now_s() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch())
      .count();
}

// Open-addressing table: the hashmap-probe half of the reference's
// per-record heap-backend work.  Value payload is caller-defined via a
// parallel array addressed by the returned dense slot.
struct ProbeTable {
  std::vector<uint64_t> hash;  // 0 = empty
  std::vector<int64_t> slot;
  uint64_t mask;
  int64_t next_slot = 0;

  explicit ProbeTable(int64_t capacity_pow2)
      : hash(capacity_pow2, 0), slot(capacity_pow2, -1),
        mask(static_cast<uint64_t>(capacity_pow2) - 1) {}

  inline int64_t get_or_insert(uint64_t h) {
    if (h == 0) h = 0x9E3779B97F4A7C15ull;
    uint64_t pos = (h ^ (h >> 32)) & mask;
    for (;;) {
      uint64_t cur = hash[pos];
      if (cur == h) return slot[pos];
      if (cur == 0) {
        hash[pos] = h;
        slot[pos] = next_slot;
        return next_slot++;
      }
      pos = (pos + 1) & mask;
    }
  }

  // callers with unbounded key universes must grow (a full
  // fixed-capacity table makes get_or_insert spin forever); the
  // presized baselines never trigger it
  void grow_if_needed(int64_t incoming) {
    if ((next_slot + incoming) * 5
        <= static_cast<int64_t>(hash.size()) * 3)
      return;
    size_t new_cap = hash.size();
    while ((next_slot + incoming) * 5 > static_cast<int64_t>(new_cap) * 3)
      new_cap *= 2;
    std::vector<uint64_t> oh(std::move(hash));
    std::vector<int64_t> os(std::move(slot));
    hash.assign(new_cap, 0);
    slot.assign(new_cap, -1);
    mask = new_cap - 1;
    for (size_t i = 0; i < oh.size(); ++i) {
      if (oh[i] == 0) continue;
      uint64_t pos = (oh[i] ^ (oh[i] >> 32)) & mask;
      while (hash[pos] != 0) pos = (pos + 1) & mask;
      hash[pos] = oh[i];
      slot[pos] = os[i];
    }
  }
};

}  // namespace

// ---- persistent slot index -------------------------------------------------
// The native twin of flink_tpu.streaming.vectorized.VectorizedSlotIndex:
// hash64 -> dense slot, slots handed out by the caller (two-phase insert
// so the Python-side arena stays the single slot allocator).

struct FtIndex {
  std::vector<uint64_t> hash;   // 0 = empty
  std::vector<int64_t> slot;
  uint64_t mask;
  int64_t n = 0;
  // phase-1 scratch: table positions of new uniques + of unresolved rows
  std::vector<int64_t> new_pos;
  std::vector<int64_t> pending_row;
  std::vector<int64_t> pending_tablepos;

  explicit FtIndex(int64_t cap) : hash(cap, 0), slot(cap, -1),
                                  mask(static_cast<uint64_t>(cap) - 1) {}

  void grow_if_needed(int64_t incoming) {
    if ((n + incoming) * 5 <= static_cast<int64_t>(hash.size()) * 3) return;
    size_t new_cap = hash.size();
    while ((n + incoming) * 5 > static_cast<int64_t>(new_cap) * 3)
      new_cap *= 2;
    std::vector<uint64_t> oh(std::move(hash));
    std::vector<int64_t> os(std::move(slot));
    hash.assign(new_cap, 0);
    slot.assign(new_cap, -1);
    mask = new_cap - 1;
    for (size_t i = 0; i < oh.size(); ++i) {
      if (oh[i] == 0) continue;
      uint64_t h = oh[i];
      uint64_t pos = (h ^ (h >> 32)) & mask;
      while (hash[pos] != 0) pos = (pos + 1) & mask;
      hash[pos] = h;
      slot[pos] = os[i];
    }
  }
};

extern "C" {

void* ft_index_new(int64_t capacity_pow2) {
  return new FtIndex(capacity_pow2 < 16 ? 16 : capacity_pow2);
}

void ft_index_free(void* p) { delete static_cast<FtIndex*>(p); }

int64_t ft_index_size(void* p) { return static_cast<FtIndex*>(p)->n; }

// Phase 1: resolve existing keys; new uniques get slot -1 and their
// batch position recorded in first_idx (insertion order).  Returns the
// number of new uniques.  Phase 2 must follow before the next batch.
int64_t ft_index_probe(void* p, const uint64_t* hashes, int64_t n,
                       int64_t* slots_out, int64_t* first_idx) {
  FtIndex& ix = *static_cast<FtIndex*>(p);
  ix.grow_if_needed(n);
  ix.new_pos.clear();
  ix.pending_row.clear();
  ix.pending_tablepos.clear();
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = hashes[i];
    if (h == 0) h = 0x9E3779B97F4A7C15ull;
    uint64_t pos = (h ^ (h >> 32)) & ix.mask;
    for (;;) {
      uint64_t cur = ix.hash[pos];
      if (cur == h) {
        int64_t s = ix.slot[pos];
        slots_out[i] = s;
        if (s < 0) {  // duplicate of a new-in-this-batch key
          ix.pending_row.push_back(i);
          ix.pending_tablepos.push_back(static_cast<int64_t>(pos));
        }
        break;
      }
      if (cur == 0) {
        ix.hash[pos] = h;
        ix.slot[pos] = -1;
        ix.n++;
        slots_out[i] = -1;
        first_idx[n_new++] = i;
        ix.new_pos.push_back(static_cast<int64_t>(pos));
        ix.pending_row.push_back(i);
        ix.pending_tablepos.push_back(static_cast<int64_t>(pos));
        break;
      }
      pos = (pos + 1) & ix.mask;
    }
  }
  return n_new;
}

// Phase 2: assign caller-allocated slots to the phase-1 uniques (in
// first_idx order) and patch every unresolved row in slots_out.
void ft_index_assign(void* p, const int64_t* new_slots, int64_t n_new,
                     int64_t* slots_out) {
  FtIndex& ix = *static_cast<FtIndex*>(p);
  for (int64_t k = 0; k < n_new; ++k)
    ix.slot[ix.new_pos[k]] = new_slots[k];
  for (size_t k = 0; k < ix.pending_row.size(); ++k)
    slots_out[ix.pending_row[k]] = ix.slot[ix.pending_tablepos[k]];
}

// Bulk load (snapshot restore): insert hash->slot pairs directly.
void ft_index_set(void* p, const uint64_t* hashes, const int64_t* slots,
                  int64_t n) {
  FtIndex& ix = *static_cast<FtIndex*>(p);
  ix.grow_if_needed(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = hashes[i];
    if (h == 0) h = 0x9E3779B97F4A7C15ull;
    uint64_t pos = (h ^ (h >> 32)) & ix.mask;
    for (;;) {
      uint64_t cur = ix.hash[pos];
      if (cur == h) { ix.slot[pos] = slots[i]; break; }
      if (cur == 0) {
        ix.hash[pos] = h;
        ix.slot[pos] = slots[i];
        ix.n++;
        break;
      }
      pos = (pos + 1) & ix.mask;
    }
  }
}

// Export occupied (hash, slot) pairs; returns count (buffers sized >= n).
int64_t ft_index_export(void* p, uint64_t* hashes_out, int64_t* slots_out) {
  FtIndex& ix = *static_cast<FtIndex*>(p);
  int64_t k = 0;
  for (size_t i = 0; i < ix.hash.size(); ++i) {
    if (ix.hash[i] != 0) {
      hashes_out[k] = ix.hash[i];
      slots_out[k] = ix.slot[i];
      ++k;
    }
  }
  return k;
}

// ---- hot host-path kernels -------------------------------------------------

void ft_splitmix64(const uint64_t* in, uint64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = splitmix64(in[i]);
}

// key hash -> key group -> shard index (KeyGroupRangeAssignment twin)
void ft_key_groups(const uint64_t* kh, int32_t* out, int64_t n,
                   int32_t max_parallelism, int32_t n_shards) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t lo = static_cast<uint32_t>(kh[i]);
    // fmix32 finalizer (same as ops/hashing.py)
    uint32_t h = lo;
    h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u;
    h ^= h >> 16;
    int32_t kg = static_cast<int32_t>(h % static_cast<uint32_t>(max_parallelism));
    out[i] = static_cast<int32_t>(
        (static_cast<int64_t>(kg) * n_shards) / max_parallelism);
  }
}

}  // extern "C" (reopened below — the log-engine templates need C++ linkage)

// ---- log-structured window engine support ---------------------------------
// The combiner tier of the windowed-aggregation engines (the role of
// the reference's pre-aggregation seam, AggregateUtil.scala:1028 /
// chained combiners): ingest appends (key, cell, payload) triples to a
// per-window log; the fire turns random per-record state RMW into
// sort + segmented dense reduction.  The sort is an adaptive LSD radix
// (skips constant high bits of the key range); per-key dedup uses an
// L1-resident scratch register file.  The estimate math mirrors
// flink_tpu/ops/sketches.py HyperLogLogAggregate._estimate exactly.

namespace {

struct HllRec {
  uint64_t key;
  uint32_t aux;  // reg (low 16) | rank << 16
};

struct SumRec {
  uint64_t key;
  double value;
};

// Adaptive LSD radix sort by .key (stable).  Sorts in place via a
// ping-pong scratch; returns pointer to the sorted buffer (either
// recs or scratch).
template <typename Rec>
Rec* radix_sort_by_key(Rec* recs, Rec* scratch, int64_t n) {
  if (n <= 1) return recs;
  uint64_t key_or = 0;
  for (int64_t i = 0; i < n; ++i) key_or |= recs[i].key;
  int bits = 64 - (key_or ? __builtin_clzll(key_or) : 63);
  // small key domains (dictionary ids, modest raw keys) sort in ONE
  // counting pass with a wider histogram instead of two 11-bit
  // passes — but only when the batch is large relative to the
  // histogram (a 2 MB zeroed counts array would dominate a small
  // sort)
  // (r5) widened to 20 bits with a relaxed batch-size floor: a 1M-key
  // domain at fire sizes saves a whole 16B-per-record scatter pass
  // for the cost of one zeroed 8 MB histogram
  const int DIGIT = (bits > 11 && bits <= 20
                     && n >= (int64_t(1) << (bits > 18 ? bits - 2 : bits)))
                        ? bits : 11;
  const int R = 1 << DIGIT;
  int passes = (bits + DIGIT - 1) / DIGIT;
  if (passes == 0) passes = 1;
  // one counting pass for all digit histograms
  std::vector<int64_t> counts(static_cast<size_t>(passes) * R, 0);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t k = recs[i].key;
    for (int p = 0; p < passes; ++p)
      ++counts[static_cast<size_t>(p) * R + ((k >> (p * DIGIT)) & (R - 1))];
  }
  Rec* src = recs;
  Rec* dst = scratch;
  for (int p = 0; p < passes; ++p) {
    int64_t* c = &counts[static_cast<size_t>(p) * R];
    int64_t sum = 0;
    for (int d = 0; d < R; ++d) {
      int64_t t = c[d];
      c[d] = sum;
      sum += t;
    }
    int shift = p * DIGIT;
    for (int64_t i = 0; i < n; ++i)
      dst[c[(src[i].key >> shift) & (R - 1)]++] = src[i];
    Rec* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Sort an HLL cell log by key (stable radix) and walk each key's run,
// deduping (reg) -> max(rank) through an L1-resident scratch register
// file.  Calls per_key(key, touched_regs, reg_max) once per distinct
// key; reg_max entries for the touched regs are cleared afterwards.
// Safe because ranks are always >= 1 (compress_value_hash contract,
// flink_tpu/ops/sketches.py) so reg_max == 0 means "not touched".
template <typename PerKey>
void hll_log_scan(const uint64_t* keys, const uint16_t* regs,
                  const uint8_t* ranks, int64_t n, int64_t m,
                  PerKey&& per_key) {
  std::vector<HllRec> buf(n), scratch(n);
  for (int64_t i = 0; i < n; ++i)
    buf[i] = {keys[i], static_cast<uint32_t>(regs[i]) |
                           (static_cast<uint32_t>(ranks[i]) << 16)};
  HllRec* sorted = radix_sort_by_key(buf.data(), scratch.data(), n);
  std::vector<uint8_t> reg_max(m, 0);
  std::vector<uint16_t> touched;
  touched.reserve(1024);
  int64_t i = 0;
  while (i < n) {
    uint64_t k = sorted[i].key;
    touched.clear();
    for (; i < n && sorted[i].key == k; ++i) {
      uint16_t r = static_cast<uint16_t>(sorted[i].aux & 0xFFFF);
      uint8_t rk = static_cast<uint8_t>(sorted[i].aux >> 16);
      if (reg_max[r] == 0) touched.push_back(r);
      if (reg_max[r] < rk) reg_max[r] = rk;
    }
    per_key(k, touched, reg_max);
    for (uint16_t r : touched) reg_max[r] = 0;
  }
}

}  // namespace

extern "C" {

// Sort an HLL window log by key (stable), dedup each key's (reg) cells
// to the max rank.  Outputs compacted triples in key-sorted order plus
// the exclusive end of each key's cell run.  Returns n_keys and writes
// the compacted cell count to *n_cells_out.  Output buffers must hold
// n entries.  precision <= 16 (reg is u16 — the compress_value_hash
// contract, flink_tpu/ops/sketches.py).
int64_t ft_hll_log_compact(const uint64_t* keys, const uint16_t* regs,
                           const uint8_t* ranks, int64_t n, int precision,
                           uint64_t* out_keys, uint16_t* out_regs,
                           uint8_t* out_ranks, int32_t* out_ends,
                           int64_t* n_cells_out) {
  int64_t n_keys = 0, n_cells = 0;
  hll_log_scan(keys, regs, ranks, n, 1ll << precision,
               [&](uint64_t k, const std::vector<uint16_t>& touched,
                   const std::vector<uint8_t>& reg_max) {
    for (uint16_t r : touched) {
      out_keys[n_cells] = k;   // key repeated per cell (engine slices)
      out_regs[n_cells] = r;
      out_ranks[n_cells] = reg_max[r];
      ++n_cells;
    }
    out_ends[n_keys++] = static_cast<int32_t>(n_cells);
  });
  *n_cells_out = n_cells;
  return n_keys;
}

// Host-tier fire: per distinct key, the HLL estimate (same formula as
// sketches.py _estimate: alpha_m bias correction + linear counting).
// Outputs are in key-sorted order.  Returns n_keys.
int64_t ft_hll_log_fire(const uint64_t* keys, const uint16_t* regs,
                        const uint8_t* ranks, int64_t n, int precision,
                        uint64_t* out_keys, double* out_est) {
  const int64_t m = 1ll << precision;
  double alpha;
  if (m == 16) alpha = 0.673;
  else if (m == 32) alpha = 0.697;
  else if (m == 64) alpha = 0.709;
  else alpha = 0.7213 / (1.0 + 1.079 / static_cast<double>(m));
  double inv_tab[64];
  for (int j = 0; j < 64; ++j) inv_tab[j] = 1.0 / ldexp(1.0, j);
  const double mf = static_cast<double>(m);
  int64_t n_keys = 0;
  hll_log_scan(keys, regs, ranks, n, m,
               [&](uint64_t k, const std::vector<uint16_t>& touched,
                   const std::vector<uint8_t>& reg_max) {
    // registers not present contribute 2^-0 = 1 each
    double inv_sum = mf - static_cast<double>(touched.size());
    for (uint16_t r : touched) inv_sum += inv_tab[reg_max[r]];
    double est = alpha * mf * mf / inv_sum;
    double zeros = mf - static_cast<double>(touched.size());
    if (est <= 2.5 * mf && zeros > 0.0)
      est = mf * (__builtin_log(mf) - __builtin_log(zeros));
    out_keys[n_keys] = k;
    out_est[n_keys] = est;
    ++n_keys;
  });
  return n_keys;
}

// HLL cell precompute: (register, rank) from 64-bit value hashes in
// one pass (rank = clz of the high 32 bits + 1; register = low bits
// masked) — the numpy twin (compress_value_hash) pays ~8 array
// passes incl. a float log2 for the same result.
void ft_hll_make_cells(const uint64_t* vh, int64_t n, int precision,
                       uint16_t* regs, uint8_t* ranks) {
  const uint32_t mask = (1u << precision) - 1u;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = vh[i];
    uint32_t hi = static_cast<uint32_t>(h >> 32);
    ranks[i] = static_cast<uint8_t>(
        (hi == 0 ? 32 : __builtin_clz(hi)) + 1);
    regs[i] = static_cast<uint16_t>(static_cast<uint32_t>(h) & mask);
  }
}


// Sum-log fire (word-count / rolling-sum shape): per distinct key, the
// sum of its logged values.  Returns n_keys; outputs key-sorted.
int64_t ft_sum_log_fire(const uint64_t* keys, const double* values,
                        int64_t n, uint64_t* out_keys, double* out_sum) {
  std::vector<SumRec> buf(n), scratch(n);
  for (int64_t i = 0; i < n; ++i) buf[i] = {keys[i], values[i]};
  SumRec* sorted = radix_sort_by_key(buf.data(), scratch.data(), n);
  int64_t n_keys = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t k = sorted[i].key;
    double s = 0.0;
    for (; i < n && sorted[i].key == k; ++i) s += sorted[i].value;
    out_keys[n_keys] = k;
    out_sum[n_keys] = s;
    ++n_keys;
  }
  return n_keys;
}

// Dense sum accumulator (the hash-combiner tier for Sum aggregates):
// per-window open-addressing key -> running sum, used by the log
// engines while the distinct-key count stays cache-resident; the
// engine switches to log appends past the cap (export + re-ingest
// as a compacted log).  Per record this is exactly the baseline's
// probe+add — embedded as the framework's ingest combiner.
struct FtSumTab {
  ProbeTable table;
  std::vector<double> sums;
  std::vector<uint64_t> keys;  // original key per slot
  // key 0 is held out of the probe table entirely (ProbeTable remaps
  // a zero hash internally, which would merge user key 0 with the
  // remap constant — grouping here must be EXACT on raw keys)
  double zero_sum = 0.0;
  bool has_zero = false;
  explicit FtSumTab(int64_t cap)
      : table(cap), sums(cap, 0.0) {}

  int64_t distinct() const {
    return table.next_slot + (has_zero ? 1 : 0);
  }

  void grow_if_needed() {
    if (table.next_slot * 5 <= static_cast<int64_t>(table.hash.size()) * 3)
      return;
    size_t new_cap = table.hash.size() * 2;
    table.hash.assign(new_cap, 0);
    table.slot.assign(new_cap, -1);
    table.mask = new_cap - 1;
    int64_t n = table.next_slot;
    table.next_slot = 0;
    sums.resize(new_cap, 0.0);
    for (int64_t s = 0; s < n; ++s)
      table.get_or_insert(keys[s]);  // reinsert: slot ids stay stable
  }
};

void* ft_sumtab_new(int64_t capacity_pow2) {
  return new FtSumTab(capacity_pow2 < 16 ? 16 : capacity_pow2);
}

void ft_sumtab_free(void* p) { delete static_cast<FtSumTab*>(p); }

int64_t ft_sumtab_size(void* p) {
  return static_cast<FtSumTab*>(p)->distinct();
}

// Accumulate until the distinct-key count would exceed max_distinct;
// returns the number of records consumed (== n unless the cap was
// hit — the engine then switches this window to log representation).
// The table grows geometrically below the cap (starts small; a
// window with few keys stays small).
int64_t ft_sumtab_ingest(void* p, const uint64_t* keys,
                         const double* vals, int64_t n,
                         int64_t max_distinct) {
  FtSumTab& st = *static_cast<FtSumTab*>(p);
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] == 0) {
      if (!st.has_zero) {
        if (st.distinct() + 1 > max_distinct) return i;
        st.has_zero = true;
      }
      st.zero_sum += vals[i];
      continue;
    }
    st.grow_if_needed();
    int64_t before = st.table.next_slot;
    int64_t s = st.table.get_or_insert(keys[i]);
    if (st.table.next_slot != before) {
      if (st.distinct() > max_distinct) {
        // undo the overflowing insert and stop
        uint64_t h = keys[i];
        uint64_t pos = (h ^ (h >> 32)) & st.table.mask;
        while (st.table.hash[pos] != h) pos = (pos + 1) & st.table.mask;
        st.table.hash[pos] = 0;
        st.table.slot[pos] = -1;
        st.table.next_slot = before;
        return i;
      }
      st.keys.push_back(keys[i]);
    }
    st.sums[s] += vals[i];
  }
  return n;
}

// Export (key, sum) pairs in slot (first-seen) order; returns count.
int64_t ft_sumtab_export(void* p, uint64_t* keys_out, double* sums_out) {
  FtSumTab& st = *static_cast<FtSumTab*>(p);
  int64_t k = 0;
  for (; k < st.table.next_slot; ++k) {
    keys_out[k] = st.keys[k];
    sums_out[k] = st.sums[k];
  }
  if (st.has_zero) {
    keys_out[k] = 0;
    sums_out[k] = st.zero_sum;
    ++k;
  }
  return k;
}

// Quantile-sketch log fire (DDSketch log-histogram, the t-digest role —
// flink_tpu/ops/sketches.py QuantileSketchAggregate).  Cells are
// (key, bucket) with +1 counts; per distinct key the requested
// quantiles are answered by an ascending scan of an L1-resident bucket
// scratch.  bucket value = exp((b - 0.5 + offset) * log_gamma) *
// mid_corr, bucket 0 = 0 (same formula as QuantileSketchAggregate
// .result).  out_q is [n_keys x n_q] row-major.  Returns n_keys.
// Count-combining compaction for the quantile log: (key, bucket)
// duplicates collapse into one cell carrying a count, bounding a
// window's log at keys x buckets cells regardless of event volume
// (the count-compaction the round-2 notes flagged as missing — the
// chained-combiner role of AggregateUtil.scala's pre-aggregation for
// the DDSketch decomposition).  `counts` may be null (raw cells,
// weight 1).  Returns the compacted cell count; output buffers
// sized n.
int64_t ft_qsketch_log_compact(const uint64_t* keys,
                               const uint16_t* buckets,
                               const uint32_t* counts, int64_t n,
                               int n_buckets,
                               uint64_t* out_keys, uint16_t* out_buckets,
                               uint32_t* out_counts) {
  struct KI { uint64_t key; int64_t idx; };
  std::vector<KI> buf(n), scratch(n);
  for (int64_t j = 0; j < n; ++j) buf[j] = {keys[j], j};
  KI* sorted = radix_sort_by_key(buf.data(), scratch.data(), n);
  std::vector<int64_t> acc(n_buckets, 0);
  std::vector<uint16_t> touched;
  touched.reserve(256);
  int64_t out = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t k = sorted[i].key;
    touched.clear();
    for (; i < n && sorted[i].key == k; ++i) {
      int64_t idx = sorted[i].idx;
      uint16_t b = buckets[idx];
      if (acc[b] == 0) touched.push_back(b);
      acc[b] += counts ? static_cast<int64_t>(counts[idx]) : 1;
    }
    std::sort(touched.begin(), touched.end());
    for (uint16_t b : touched) {
      int64_t c = acc[b];
      acc[b] = 0;
      // u32 count cells: counts beyond 2^32-1 split across cells
      // (exact; astronomically rare)
      while (c > 0) {
        uint32_t take = static_cast<uint32_t>(
            c > 0xFFFFFFFFll ? 0xFFFFFFFFll : c);
        out_keys[out] = k;
        out_buckets[out] = b;
        out_counts[out] = take;
        ++out;
        c -= take;
      }
    }
  }
  return out;
}

// Weighted quantile fire: `cell_counts` may be null (raw cells,
// weight 1 — the original path).
int64_t ft_qsketch_log_fire2(const uint64_t* keys, const uint16_t* buckets,
                             const uint32_t* cell_counts,
                             int64_t n, int n_buckets,
                             const double* quantiles, int n_q,
                             double log_gamma, int64_t offset,
                             double mid_corr,
                             uint64_t* out_keys, double* out_q) {
  // raw cells ride the sort as (key, bucket) records — sequential
  // reads in the walk; weighted (compacted) cells are few, so the
  // per-cell index gather there is cheap
  std::vector<HllRec> buf(n), scratch(n);
  for (int64_t j = 0; j < n; ++j) {
    uint32_t aux = cell_counts
        ? static_cast<uint32_t>(j)                 // index of the cell
        : static_cast<uint32_t>(buckets[j]);       // the bucket itself
    buf[j] = {keys[j], aux};
  }
  HllRec* sorted = radix_sort_by_key(buf.data(), scratch.data(), n);
  // bucket midpoint values precomputed once (one exp per BUCKET, not
  // one per key x quantile — singleton-heavy fires are exp-bound
  // otherwise)
  std::vector<double> bucket_val(n_buckets);
  bucket_val[0] = 0.0;
  for (int b = 1; b < n_buckets; ++b)
    bucket_val[b] = __builtin_exp(
        (static_cast<double>(b) - 0.5 + static_cast<double>(offset)) *
        log_gamma) * mid_corr;
  std::vector<int64_t> counts(n_buckets, 0);
  std::vector<uint16_t> touched;
  touched.reserve(256);
  int64_t n_keys = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t k = sorted[i].key;
    touched.clear();
    int64_t total = 0;
    for (; i < n && sorted[i].key == k; ++i) {
      uint16_t b;
      int64_t w;
      if (cell_counts) {
        int64_t idx = static_cast<int64_t>(sorted[i].aux);
        b = buckets[idx];
        w = static_cast<int64_t>(cell_counts[idx]);
      } else {
        b = static_cast<uint16_t>(sorted[i].aux & 0xFFFF);
        w = 1;
      }
      if (counts[b] == 0) touched.push_back(b);
      counts[b] += w;
      total += w;
    }
    if (touched.size() == 1) {
      // all mass in one bucket: every quantile answers it
      double v = bucket_val[touched[0]];
      for (int q = 0; q < n_q; ++q) out_q[n_keys * n_q + q] = v;
    } else {
      // accumulate over the key's touched buckets only, ascending
      // (absent buckets hold zero count — skipping them is exact)
      std::sort(touched.begin(), touched.end());
      for (int q = 0; q < n_q; ++q) {
        double target = quantiles[q] * static_cast<double>(total);
        if (target < 1.0) target = 1.0;
        int64_t acc = 0;
        uint16_t sel = touched.back();
        for (uint16_t b : touched) {
          acc += counts[b];
          if (static_cast<double>(acc) >= target) { sel = b; break; }
        }
        out_q[n_keys * n_q + q] = bucket_val[sel];
      }
    }
    out_keys[n_keys++] = k;
    for (uint16_t b : touched) counts[b] = 0;
  }
  return n_keys;
}

// Unweighted compatibility entry (the original symbol).
int64_t ft_qsketch_log_fire(const uint64_t* keys, const uint16_t* buckets,
                            int64_t n, int n_buckets,
                            const double* quantiles, int n_q,
                            double log_gamma, int64_t offset,
                            double mid_corr,
                            uint64_t* out_keys, double* out_q) {
  return ft_qsketch_log_fire2(keys, buckets, nullptr, n, n_buckets,
                              quantiles, n_q, log_gamma, offset,
                              mid_corr, out_keys, out_q);
}

// Session-window fire over an event log (config #4 shape:
// EventTimeSessionWindows + Count-Min totals, MergingWindowSet.java:156
// semantics with lateness 0).  Sorts the log by (key, ts); each key
// run splits into sessions at gaps > gap_ms; sessions whose end-1 <=
// watermark are CLOSED: their Count-Min sketch is built in an
// L1-resident scratch (depth hashed increments per event — the same
// per-record work the reference pays, but against a session-local 4KB
// table instead of an all-keys-live state backend) and the session
// (key, start, end, total) is emitted.  Open sessions' events are
// copied to the retained log.  Returns n_closed; *n_retained gets the
// retained count.  Output buffers sized n.
// Two-segment session fire: `keys..vhs` is the batch feed (usually
// ts-sorted — sources emit in event-time order), `rkeys..rvhs` is the
// RETAINED set carried from the previous fire, in (key, ts) order —
// exactly the order the walk emits, so retained rows are NEVER
// re-sorted: each fire radix-sorts only the NEW rows and merges two
// key-major streams.  That keeps long-gap workloads linear (a
// ts-ordered retained contract re-sorted the whole open set every
// fire — measured 0.39x at gap 5s before this shape).
int64_t ft_session_log_fire2(const uint64_t* keys, const int64_t* ts,
                             const float* weights, const uint64_t* vhs,
                             int64_t n_new,
                             const uint64_t* rkeys, const int64_t* rts,
                             const float* rw, const uint64_t* rvhs,
                             int64_t n_ret_in,
                             int64_t gap_ms, int64_t watermark,
                             int depth, int width,
                             uint64_t* out_keys, int64_t* out_start,
                             int64_t* out_end, double* out_total,
                             uint64_t* ret_keys, int64_t* ret_ts,
                             float* ret_w, uint64_t* ret_vh,
                             int64_t* n_retained) {
  const int64_t n = n_new + n_ret_in;
  struct Ev { uint64_t key; int64_t idx; };
  // NEW rows: target order (key, ts).  The feed is usually already
  // ts-sorted, so ONE stable radix sort by key suffices — the ts
  // pass runs only when a linear scan finds disorder.  (Measured
  // alternative: carrying the 32-byte payload through the sort loses
  // to the 16-byte (key, idx) sort + one materialize pass at the
  // chunked sizes the engine feeds.)  Retained ts precede new ts for
  // any key (the feed is globally event-time ordered), so per-key
  // concatenation retained-then-new stays ts-sorted.
  bool new_sorted = true;
  for (int64_t i = 1; i < n_new; ++i)
    if (ts[i] < ts[i - 1]) { new_sorted = false; break; }
  if (new_sorted && n_ret_in && n_new) {
    // per-key retained-then-new concatenation is ts-ordered only if
    // no new row predates a retained row (holds for in-order feeds:
    // each batch starts at or after the previous batch's max ts)
    int64_t ret_max = rts[0];
    for (int64_t i = 1; i < n_ret_in; ++i)
      ret_max = std::max(ret_max, rts[i]);
    if (ts[0] < ret_max) new_sorted = false;
  }
  std::vector<Ev> buf, scratch;
  std::vector<int64_t> sts;
  std::vector<float> sw;
  std::vector<uint64_t> svh;
  Ev* sorted = nullptr;
  int64_t n_sorted;
  if (new_sorted) {
    n_sorted = n_new;
    buf.resize(n_new);
    scratch.resize(n_new);
    for (int64_t i = 0; i < n_new; ++i) buf[i] = {keys[i], i};
    sorted = radix_sort_by_key(buf.data(), scratch.data(), n_new);
    sts.resize(n_new);
    sw.resize(n_new);
    svh.resize(n_new);
    for (int64_t i = 0; i < n_new; ++i) {
      int64_t idx = sorted[i].idx;
      sts[i] = ts[idx];
      sw[i] = weights[idx];
      svh[i] = vhs[idx];
    }
  } else {
    // out-of-order feed (rare): pool BOTH segments and (ts, key)
    // double-sort — correctness path, not the fast one
    n_sorted = n;
    std::vector<int64_t> mts(n);
    std::vector<float> mw(n);
    std::vector<uint64_t> mkeys(n), mvh(n);
    std::memcpy(mts.data(), ts, sizeof(int64_t) * n_new);
    std::memcpy(mw.data(), weights, sizeof(float) * n_new);
    std::memcpy(mkeys.data(), keys, sizeof(uint64_t) * n_new);
    std::memcpy(mvh.data(), vhs, sizeof(uint64_t) * n_new);
    if (n_ret_in) {
      std::memcpy(mts.data() + n_new, rts, sizeof(int64_t) * n_ret_in);
      std::memcpy(mw.data() + n_new, rw, sizeof(float) * n_ret_in);
      std::memcpy(mkeys.data() + n_new, rkeys,
                  sizeof(uint64_t) * n_ret_in);
      std::memcpy(mvh.data() + n_new, rvhs,
                  sizeof(uint64_t) * n_ret_in);
    }
    buf.resize(n);
    scratch.resize(n);
    for (int64_t i = 0; i < n; ++i)
      buf[i] = {static_cast<uint64_t>(mts[i]) ^ 0x8000000000000000ull, i};
    Ev* s1 = radix_sort_by_key(buf.data(), scratch.data(), n);
    Ev* other = (s1 == buf.data()) ? scratch.data() : buf.data();
    for (int64_t i = 0; i < n; ++i)
      other[i] = {mkeys[s1[i].idx], s1[i].idx};
    sorted = radix_sort_by_key(other, s1, n);
    sts.resize(n);
    sw.resize(n);
    svh.resize(n);
    for (int64_t i = 0; i < n; ++i) {
      int64_t idx = sorted[i].idx;
      sts[i] = mts[idx];
      sw[i] = mw[idx];
      svh[i] = mvh[idx];
    }
    n_ret_in = 0;  // pooled above; the merge below sees one stream
  }

  std::vector<int32_t> cm(static_cast<size_t>(depth) * width, 0);
  std::vector<int32_t> cm_touched;
  cm_touched.reserve(1024);
  // per-key scratch run: retained rows of the key, then new rows
  std::vector<int64_t> run_ts;
  std::vector<float> run_w;
  std::vector<uint64_t> run_vh;
  int64_t n_closed = 0, n_ret = 0;
  int64_t ia = 0, ib = 0;  // cursors: retained stream / sorted new
  while (ia < n_ret_in || ib < n_sorted) {
    uint64_t k;
    if (ia >= n_ret_in) k = sorted[ib].key;
    else if (ib >= n_sorted) k = rkeys[ia];
    else k = std::min(rkeys[ia], sorted[ib].key);
    run_ts.clear();
    run_w.clear();
    run_vh.clear();
    while (ia < n_ret_in && rkeys[ia] == k) {
      run_ts.push_back(rts[ia]);
      run_w.push_back(rw[ia]);
      run_vh.push_back(rvhs[ia]);
      ++ia;
    }
    while (ib < n_sorted && sorted[ib].key == k) {
      run_ts.push_back(sts[ib]);
      run_w.push_back(sw[ib]);
      run_vh.push_back(svh[ib]);
      ++ib;
    }
    const int64_t run_n = static_cast<int64_t>(run_ts.size());
    // split the run into sessions at gaps
    int64_t a = 0;
    while (a < run_n) {
      int64_t b = a + 1;
      int64_t last = run_ts[a];
      while (b < run_n && run_ts[b] - last <= gap_ms) {
        last = run_ts[b];
        ++b;
      }
      int64_t sess_start = run_ts[a];
      int64_t sess_end = last + gap_ms;
      if (sess_end - 1 <= watermark) {
        double total = 0.0;
        for (int64_t j = a; j < b; ++j) {
          total += static_cast<double>(run_w[j]);
          uint64_t h = run_vh[j];
          for (int d = 0; d < depth; ++d) {
            uint64_t hd = splitmix64(h + 0x9E3779B97F4A7C15ull *
                                     static_cast<uint64_t>(d));
            int32_t pos = static_cast<int32_t>(
                d * width +
                static_cast<int64_t>(hd % static_cast<uint64_t>(width)));
            if (cm[pos] == 0) cm_touched.push_back(pos);
            ++cm[pos];
          }
        }
        for (int32_t p : cm_touched) cm[p] = 0;
        cm_touched.clear();
        out_keys[n_closed] = k;
        out_start[n_closed] = sess_start;
        out_end[n_closed] = sess_end;
        out_total[n_closed] = total;
        ++n_closed;
      } else {
        for (int64_t j = a; j < b; ++j) {
          ret_keys[n_ret] = k;
          ret_ts[n_ret] = run_ts[j];
          ret_w[n_ret] = run_w[j];
          ret_vh[n_ret] = run_vh[j];
          ++n_ret;
        }
      }
      a = b;
    }
  }
  *n_retained = n_ret;
  return n_closed;
}

// Single-segment compatibility entry (no retained input).
int64_t ft_session_log_fire(const uint64_t* keys, const int64_t* ts,
                            const float* weights, const uint64_t* vhs,
                            int64_t n, int64_t gap_ms, int64_t watermark,
                            int depth, int width,
                            uint64_t* out_keys, int64_t* out_start,
                            int64_t* out_end, double* out_total,
                            uint64_t* ret_keys, int64_t* ret_ts,
                            float* ret_w, uint64_t* ret_vh,
                            int64_t* n_retained) {
  return ft_session_log_fire2(keys, ts, weights, vhs, n,
                              nullptr, nullptr, nullptr, nullptr, 0,
                              gap_ms, watermark, depth, width,
                              out_keys, out_start, out_end, out_total,
                              ret_keys, ret_ts, ret_w, ret_vh,
                              n_retained);
}

// ---- string key interning --------------------------------------------------
// Dictionary-encode string keys ONCE per batch so keyBy("word") over
// real strings rides the integer-keyed fast tiers (round-2 verdict
// item 2; ref shape: SocketWindowWordCount.java:70-84 keyBy("word")).
// Strings arrive as numpy's fixed-width row buffer ('<Uk' UCS4 rows or
// '|Sk' byte rows) — one contiguous block, no per-string Python
// objects cross the boundary.  Ids are dense in first-seen order, so a
// restore that re-interns the id->string directory in order
// reproduces the same ids.  Exact: hash collisions fall back to
// codepoint comparison against the interned pool.

}  // extern "C"

namespace {

struct FtInterner {
  std::vector<uint64_t> hash;    // content hash (0 = empty marker)
  std::vector<int64_t> id;       // dense id per table position
  std::vector<uint32_t> pool;    // interned codepoints, span-addressed
  std::vector<int64_t> span_off;
  std::vector<int32_t> span_len;
  uint64_t mask;
  int64_t n = 0;
  // fused-kernel phase scratch — on the INTERNER (one per operator),
  // not the per-window sums, so k live windows share one buffer
  std::vector<uint64_t> hs;
  std::vector<int32_t> lens;
  std::vector<uint64_t> cand_pos;
  std::vector<int64_t> ids;

  explicit FtInterner(int64_t cap) : hash(cap, 0), id(cap, -1),
                                     mask(static_cast<uint64_t>(cap) - 1) {}

  void grow_if_needed(int64_t incoming) {
    if ((n + incoming) * 5 <= static_cast<int64_t>(hash.size()) * 3) return;
    size_t new_cap = hash.size();
    while ((n + incoming) * 5 > static_cast<int64_t>(new_cap) * 3)
      new_cap *= 2;
    std::vector<uint64_t> oh(std::move(hash));
    std::vector<int64_t> oi(std::move(id));
    hash.assign(new_cap, 0);
    id.assign(new_cap, -1);
    mask = new_cap - 1;
    for (size_t i = 0; i < oh.size(); ++i) {
      if (oh[i] == 0) continue;
      uint64_t pos = (oh[i] ^ (oh[i] >> 32)) & mask;
      while (hash[pos] != 0) pos = (pos + 1) & mask;
      hash[pos] = oh[i];
      id[pos] = oi[i];
    }
  }
};

// hash + logical length of one fixed-width row (trailing zero elements
// are numpy's padding; an embedded trailing NUL is indistinguishable —
// the same limitation numpy's own '<U' round-trip has)
template <typename E>
inline uint64_t row_hash(const E* row, int64_t width, int32_t* len_out) {
  int64_t len = width;
  while (len > 0 && row[len - 1] == 0) --len;
  uint64_t h = 0xCBF29CE484222325ull;
  for (int64_t j = 0; j < len; ++j)
    h = (h ^ static_cast<uint32_t>(row[j])) * 0x100000001B3ull;
  *len_out = static_cast<int32_t>(len);
  uint64_t f = splitmix64(h);
  return f ? f : 0x9E3779B97F4A7C15ull;  // 0 is the empty marker
}

template <typename E>
int64_t intern_rows_t(FtInterner& it, const E* rows, int64_t width,
                      int64_t n, uint64_t* out_ids, int64_t* first_idx) {
  it.grow_if_needed(n);
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    const E* row = rows + i * width;
    int32_t len;
    uint64_t h = row_hash(row, width, &len);
    uint64_t pos = (h ^ (h >> 32)) & it.mask;
    for (;;) {
      uint64_t cur = it.hash[pos];
      if (cur == h) {
        int64_t cand = it.id[pos];
        // verify content (exact grouping, not hash-trusting)
        if (it.span_len[cand] == len) {
          const uint32_t* p = it.pool.data() + it.span_off[cand];
          bool eq = true;
          for (int32_t j = 0; j < len; ++j)
            if (p[j] != static_cast<uint32_t>(row[j])) { eq = false; break; }
          if (eq) { out_ids[i] = static_cast<uint64_t>(cand); break; }
        }
      } else if (cur == 0) {
        int64_t new_id = it.n++;
        it.hash[pos] = h;
        it.id[pos] = new_id;
        it.span_off.push_back(static_cast<int64_t>(it.pool.size()));
        it.span_len.push_back(len);
        for (int32_t j = 0; j < len; ++j)
          it.pool.push_back(static_cast<uint32_t>(row[j]));
        out_ids[i] = static_cast<uint64_t>(new_id);
        first_idx[n_new++] = i;
        break;
      }
      pos = (pos + 1) & it.mask;
    }
  }
  return n_new;
}

}  // namespace

extern "C" {

void* ft_intern_new(int64_t capacity_pow2) {
  return new FtInterner(capacity_pow2 < 16 ? 16 : capacity_pow2);
}

void ft_intern_free(void* p) { delete static_cast<FtInterner*>(p); }

int64_t ft_intern_size(void* p) { return static_cast<FtInterner*>(p)->n; }

// rows: n rows x width elements of elem_size bytes (1 = '|S', 4 =
// '<U'); out_ids[n] dense first-seen ids; first_idx gets the batch row
// of each NEW id, in id order.  Returns the number of new ids.
int64_t ft_intern_rows(void* p, const uint8_t* rows, int64_t width,
                       int64_t elem_size, int64_t n, uint64_t* out_ids,
                       int64_t* first_idx) {
  FtInterner& it = *static_cast<FtInterner*>(p);
  if (elem_size == 4)
    return intern_rows_t(it, reinterpret_cast<const uint32_t*>(rows),
                         width, n, out_ids, first_idx);
  return intern_rows_t(it, rows, width, n, out_ids, first_idx);
}

// Fused intern+sum for the wordcount shape: the batch interface IS
// the structural edge over the reference's per-record API, so exploit
// it — phase 1 hashes every row with no cross-iteration dependency
// (superscalar), phase 2 probes with the NEXT row's table line
// prefetched and adds into a dense id-indexed sum array (no second
// probe: interned ids are dense).  A per-record API cannot
// phase-split or prefetch ahead — it sees one record at a time,
// exactly like HeapAggregatingState.add.

struct FtWordSums {
  std::vector<double> sums;      // dense, indexed by interned id
  std::vector<int64_t> touched;  // ids with nonzero activity
  std::vector<uint8_t> seen;
};


void* ft_wordsums_new() { return new FtWordSums(); }
void ft_wordsums_free(void* p) { delete static_cast<FtWordSums*>(p); }
int64_t ft_wordsums_count(void* p) {
  return static_cast<int64_t>(static_cast<FtWordSums*>(p)->touched.size());
}

// Export (id, sum) for every touched id and reset the accumulator.
int64_t ft_wordsums_fire(void* p, int64_t* ids_out, double* sums_out) {
  FtWordSums& ws = *static_cast<FtWordSums*>(p);
  int64_t k = 0;
  for (int64_t id_ : ws.touched) {
    ids_out[k] = id_;
    sums_out[k] = ws.sums[id_];
    ws.sums[id_] = 0.0;
    ws.seen[id_] = 0;
    ++k;
  }
  ws.touched.clear();
  return k;
}

// Bulk import (restore): sums[id] += s, touched tracking maintained.
void ft_wordsums_load(void* p, const int64_t* ids, const double* sums,
                      int64_t k) {
  FtWordSums& ws = *static_cast<FtWordSums*>(p);
  for (int64_t i = 0; i < k; ++i) {
    int64_t id_ = ids[i];
    if (id_ >= static_cast<int64_t>(ws.sums.size())) {
      ws.sums.resize(id_ + 1, 0.0);
      ws.seen.resize(id_ + 1, 0);
    }
    if (!ws.seen[id_]) { ws.seen[id_] = 1; ws.touched.push_back(id_); }
    ws.sums[id_] += sums[i];
  }
}

}  // extern "C"

namespace {

template <typename E>
int64_t intern_sum_t(FtInterner& it, FtWordSums& ws, const E* rows,
                     int64_t width, const double* weights, int64_t n,
                     int64_t* first_idx) {
  it.grow_if_needed(n);
  // phase 1: hash every row — no cross-iteration dependency, so the
  // core pipelines it (the per-record baseline interleaves hashing
  // with a dependent probe and cannot)
  it.hs.resize(n);
  it.lens.resize(n);
  it.cand_pos.resize(n);
  it.ids.resize(n);
  for (int64_t i = 0; i < n; ++i)
    it.hs[i] = row_hash(rows + i * width, width, &it.lens[i]);
  // phase 2: FIRST probe for every row — each iteration independent,
  // so the OoO core overlaps 4-8 table loads where the per-record
  // baseline serializes hash -> probe -> verify -> add per record
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = it.hs[i];
    uint64_t pos = (h ^ (h >> 32)) & it.mask;
    it.cand_pos[i] = pos;
    it.ids[i] = (it.hash[pos] == h) ? it.id[pos] : -1;
  }
  // phase 3: verify first-probe hits (independent pool compares);
  // false hits (64-bit collision at equal table slot) fall to slow
  for (int64_t i = 0; i < n; ++i) {
    int64_t cand = it.ids[i];
    if (cand < 0) continue;
    int32_t len = it.lens[i];
    if (it.span_len[cand] != len) { it.ids[i] = -1; continue; }
    const E* row = rows + i * width;
    const uint32_t* p = it.pool.data() + it.span_off[cand];
    for (int32_t j = 0; j < len; ++j)
      if (p[j] != static_cast<uint32_t>(row[j])) { it.ids[i] = -1; break; }
  }
  // phase 4: sequential slow path — empty slots (inserts), probe
  // continuations, failed verifies.  Rare in steady state (the
  // vocabulary is known), so the serial chain is off the hot path.
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (it.ids[i] >= 0) continue;
    uint64_t h = it.hs[i];
    int32_t len = it.lens[i];
    const E* row = rows + i * width;
    uint64_t pos = it.cand_pos[i];
    for (;;) {
      uint64_t cur = it.hash[pos];
      if (cur == h) {
        int64_t cand = it.id[pos];
        if (it.span_len[cand] == len) {
          const uint32_t* p = it.pool.data() + it.span_off[cand];
          bool eq = true;
          for (int32_t j = 0; j < len; ++j)
            if (p[j] != static_cast<uint32_t>(row[j])) { eq = false; break; }
          if (eq) { it.ids[i] = cand; break; }
        }
      } else if (cur == 0) {
        int64_t id_ = it.n++;
        it.hash[pos] = h;
        it.id[pos] = id_;
        it.span_off.push_back(static_cast<int64_t>(it.pool.size()));
        it.span_len.push_back(len);
        for (int32_t j = 0; j < len; ++j)
          it.pool.push_back(static_cast<uint32_t>(row[j]));
        it.ids[i] = id_;
        first_idx[n_new++] = i;
        break;
      }
      pos = (pos + 1) & it.mask;
    }
  }
  // phase 5: adds — direct-indexed, no probe
  int64_t max_id = it.n - 1;
  if (max_id >= static_cast<int64_t>(ws.sums.size())) {
    int64_t cap = ws.sums.size() ? static_cast<int64_t>(ws.sums.size())
                                 : 1024;
    while (cap <= max_id) cap *= 2;
    ws.sums.resize(cap, 0.0);
    ws.seen.resize(cap, 0);
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t id_ = it.ids[i];
    if (!ws.seen[id_]) { ws.seen[id_] = 1; ws.touched.push_back(id_); }
    ws.sums[id_] += weights ? weights[i] : 1.0;
  }
  return n_new;
}

}  // namespace

extern "C" {

// Fused intern + windowed sum (the wordcount_str engine's ingest).
// weights may be null (count semantics).  Returns the number of NEW
// interner entries; first_idx gets their batch rows in id order.
int64_t ft_intern_sum(void* interner, void* wsums, const uint8_t* rows,
                      int64_t width, int64_t elem_size,
                      const double* weights, int64_t has_weights,
                      int64_t n, int64_t* first_idx) {
  FtInterner& it = *static_cast<FtInterner*>(interner);
  FtWordSums& ws = *static_cast<FtWordSums*>(wsums);
  const double* w = has_weights ? weights : nullptr;
  // (r5) CHUNK the phase pipeline: the phase intermediates (hash /
  // candidate / id per row) for a whole megabatch round-trip through
  // DRAM; per ~8k rows they stay L2-resident, which keeps the
  // phase-split ILP advantage intact when the shared box is
  // bandwidth-starved (the r4 1.0-1.2x swing came exactly from this)
  const int64_t CHUNK = 8192;
  int64_t total_new = 0;
  for (int64_t off = 0; off < n; off += CHUNK) {
    int64_t m = n - off < CHUNK ? n - off : CHUNK;
    const uint8_t* r = rows + off * width * elem_size;
    const double* wc = w ? w + off : nullptr;
    int64_t n_new;
    if (elem_size == 4)
      n_new = intern_sum_t(it, ws,
                           reinterpret_cast<const uint32_t*>(r),
                           width, wc, m, first_idx + total_new);
    else
      n_new = intern_sum_t(it, ws, r, width, wc, m,
                           first_idx + total_new);
    // first_idx entries are chunk-relative -> rebase to the batch
    for (int64_t k = 0; k < n_new; ++k)
      first_idx[total_new + k] += off;
    total_new += n_new;
  }
  return total_new;
}

// Fused fire-path grouping for the generic-aggregate log tier
// (flink_tpu_torch/streaming/generic_agg.py): stable radix argsort by key,
// segment (run) detection, and a LENGTH-DESCENDING segment layout in
// one call — the diagonal-round fold then reads accumulator prefixes
// as slice views.  Outputs:
//   order[n]       sort permutation (caller permutes payload columns)
//   seg_starts[*]  per segment, position in sorted space, len-desc
//   seg_lens[*]    per segment, len-desc
//   ukeys[*]       per segment key, same order
// Returns n_seg.
int64_t ft_fold_prep(const uint64_t* keys, int64_t n, int64_t* order,
                     int64_t* seg_starts, int64_t* seg_lens,
                     uint64_t* ukeys) {
  if (n == 0) return 0;
  struct KIdx {
    uint64_t key;
    int64_t idx;
  };
  // thread-local reusable scratch: fresh 32 MB allocations page-fault
  // on first touch every call, which costs more than the sort passes
  static thread_local std::unique_ptr<KIdx[]> tl_buf, tl_scratch;
  static thread_local int64_t tl_cap = 0;
  if (n > tl_cap) {
    int64_t cap = 1;
    while (cap < n) cap <<= 1;
    tl_buf.reset(new KIdx[cap]);
    tl_scratch.reset(new KIdx[cap]);
    tl_cap = cap;
  }
  KIdx* buf = tl_buf.get();
  KIdx* scratch = tl_scratch.get();
  for (int64_t i = 0; i < n; ++i) buf[i] = KIdx{keys[i], i};
  KIdx* sorted = radix_sort_by_key(buf, scratch, n);
  // one walk: emit order + segment boundaries (arrival order within
  // a segment is preserved by the stable sort)
  int64_t n_seg = 0;
  std::unique_ptr<int64_t[]> starts(new int64_t[n]), lens(new int64_t[n]);
  uint64_t prev = ~sorted[0].key;  // != first key
  for (int64_t i = 0; i < n; ++i) {
    order[i] = sorted[i].idx;
    uint64_t k = sorted[i].key;
    if (k != prev) {
      starts[n_seg] = i;
      if (n_seg) lens[n_seg - 1] = i - starts[n_seg - 1];
      ++n_seg;
      prev = k;
    }
  }
  lens[n_seg - 1] = n - starts[n_seg - 1];
  // counting sort of segments by length, descending (stable)
  int64_t max_len = 0;
  for (int64_t s = 0; s < n_seg; ++s)
    if (lens[s] > max_len) max_len = lens[s];
  std::vector<int64_t> hist(max_len + 2, 0);
  for (int64_t s = 0; s < n_seg; ++s) ++hist[max_len - lens[s]];
  int64_t run = 0;
  for (int64_t d = 0; d <= max_len; ++d) {
    int64_t t = hist[d];
    hist[d] = run;
    run += t;
  }
  for (int64_t s = 0; s < n_seg; ++s) {
    int64_t pos = hist[max_len - lens[s]]++;
    seg_starts[pos] = starts[s];
    seg_lens[pos] = lens[s];
    ukeys[pos] = sorted[starts[s]].key;
  }
  return n_seg;
}

// Small-domain grouping with payload co-scatter: when keys fit a
// counting-sort histogram (< 2^22), grouping is ONE count pass + ONE
// scatter pass that permutes the scalar value column alongside the
// order — the histogram IS the segment table, so there is no walk.
// Segments come out length-descending (counting sort by run length).
// elem_size: 4 or 8 (value element width), 0 = keys only.
// Returns n_seg, or -1 when a key exceeds the domain (caller must
// check key_or < 2^22 first; this is a backstop).
int64_t ft_group_cols(const uint64_t* keys, int64_t n, int64_t ncols,
                      const int64_t* elem_sizes, const void** cols,
                      void** scols, int64_t* order,
                      int64_t* seg_starts, int64_t* seg_lens,
                      uint64_t* ukeys) {
  if (n == 0) return 0;
  uint64_t key_or = 0;
  for (int64_t i = 0; i < n; ++i) key_or |= keys[i];
  if (key_or >> 22) return -1;
  const int64_t R = key_or ? (int64_t(2) << (63 - __builtin_clzll(key_or)))
                           : 1;
  // u32 cursors: half the histogram footprint of i64 — for 1M-key
  // domains the cursor array then mostly lives in cache
  static thread_local std::vector<uint32_t> hist;
  hist.assign(R, 0);
  for (int64_t i = 0; i < n; ++i) ++hist[keys[i]];
  uint32_t run = 0;
  for (int64_t d = 0; d < R; ++d) {
    uint32_t t = hist[d];
    hist[d] = run;
    run += t;
  }
  // scatter pass: co-scatter every payload column (and the order,
  // when requested) — each extra column is one more write stream,
  // still cheaper than a separate numpy fancy-gather pass per column
  for (int64_t i = 0; i < n; ++i) {
    int64_t pos = hist[keys[i]]++;
    if (order) order[pos] = i;
    for (int64_t c2 = 0; c2 < ncols; ++c2) {
      if (elem_sizes[c2] == 8)
        static_cast<uint64_t*>(scols[c2])[pos] =
            static_cast<const uint64_t*>(cols[c2])[i];
      else
        static_cast<uint32_t*>(scols[c2])[pos] =
            static_cast<const uint32_t*>(cols[c2])[i];
    }
  }
  // hist[k] is now the END of bucket k; starts are hist[k-1] (or 0)
  // — recover per-bucket runs and counting-sort them by length desc
  int64_t n_seg = 0;
  int64_t max_len = 0;
  static thread_local std::vector<int64_t> sk, sl;
  sk.clear();
  sl.clear();
  int64_t prev_end = 0;
  for (int64_t d = 0; d < R; ++d) {
    int64_t end = hist[d];
    int64_t len = end - prev_end;
    if (len > 0) {
      sk.push_back(d);
      sl.push_back(len);
      if (len > max_len) max_len = len;
      ++n_seg;
    }
    prev_end = end;
  }
  static thread_local std::vector<int64_t> lhist;
  lhist.assign(max_len + 1, 0);
  for (int64_t s = 0; s < n_seg; ++s) ++lhist[max_len - sl[s]];
  int64_t lrun = 0;
  for (int64_t d = 0; d <= max_len; ++d) {
    int64_t t = lhist[d];
    lhist[d] = lrun;
    lrun += t;
  }
  for (int64_t s = 0; s < n_seg; ++s) {
    int64_t pos = lhist[max_len - sl[s]]++;
    int64_t key = sk[s];
    seg_starts[pos] = (key ? static_cast<int64_t>(hist[key - 1]) : 0);
    seg_lens[pos] = sl[s];
    ukeys[pos] = static_cast<uint64_t>(key);
  }
  return n_seg;
}

// Stable argsort of a u64 key column via the adaptive LSD radix sort
// (numpy's stable 64-bit argsort is a comparison sort and ~5x slower
// at 8M keys).
void ft_argsort_u64(const uint64_t* keys, int64_t n, int64_t* out) {
  struct KIdx {
    uint64_t key;
    int64_t idx;
  };
  // raw new[]: POD stays uninitialized — vector's zero-fill of the
  // two scratch buffers would cost more than the sort itself
  std::unique_ptr<KIdx[]> buf(new KIdx[n]), scratch(new KIdx[n]);
  for (int64_t i = 0; i < n; ++i) buf[i] = KIdx{keys[i], i};
  KIdx* sorted = radix_sort_by_key(buf.get(), scratch.get(), n);
  for (int64_t i = 0; i < n; ++i) out[i] = sorted[i].idx;
}

}  // extern "C"

// Batched interval-join engine state: per-key time-sorted row
// buffers, probed a BATCH at a time with the phases split — slot
// resolution for the whole batch first (independent probes overlap
// in the OoO core), then the per-row range searches, then emission —
// where a per-record join serializes hash -> probe -> search -> emit
// for every record.  Pairs export as global row ids;
// the Python side owns the column storage and gathers vectorized.

namespace {

// One slot-major run: rows grouped by key slot (ascending slot id,
// contiguous segments), time-sorted within each segment.  The
// log-structured layout replaces the first cut's per-key
// std::vectors — 100k scattered allocations cost a cache miss per
// row on probe AND append (the same misses the per-record baseline
// pays, which is why that cut only broke even); runs make both walks
// sequential.  Segment metadata is SPARSE (one entry per touched
// slot, ascending) so a run costs O(batch keys), not O(all keys
// ever); every consumer walks runs in ascending slot order with a
// monotone cursor, so lookups stay O(1) amortized.
struct IvRun {
  std::vector<int64_t> ts, row;
  //: parallel arrays: rows of slot touched[i] live at [start[i],
  //: end[i]) — start advances as rows are pruned
  std::vector<int64_t> touched, start, end;
};

// LSM-style side buffer: a compacted main run + recent tail runs
// (one per pushed batch); tails fold into main once they outgrow it
// or accumulate past the run cap, so each row merges O(log) times
// and probes touch at most 1 + IV_MAX_TAILS segments per key.
struct IvSide {
  IvRun main_;
  std::vector<IvRun> tail;
  int64_t tail_rows = 0;   // live rows in tails
  int64_t main_live = 0;   // live rows in main
};

constexpr int64_t IV_MAX_TAILS = 8;
constexpr int64_t IV_MIN_MERGE = 1 << 16;

struct FtIvJoin {
  int64_t lower, upper;
  ProbeTable table;
  IvSide side_[2];
  std::vector<int64_t> pairs_l, pairs_r;
  std::vector<int64_t> slots, counts, perm;  // phase scratch
  int64_t next_row[2] = {0, 0};

  FtIvJoin(int64_t lo, int64_t up, int64_t cap)
      : lower(lo), upper(up), table(cap) {}
};

// fold main + tails into one compacted run: a k-way walk over the
// runs' ascending touched lists (k <= 1 + IV_MAX_TAILS), appending
// each slot's live segments in chronological (main, tail-age) order.
// Dead (pruned) prefixes drop here — merge IS the compaction.
void iv_merge(IvSide& sd) {
  IvRun out;
  int64_t total = sd.main_live + sd.tail_rows;
  out.ts.reserve(total);
  out.row.reserve(total);
  std::vector<const IvRun*> srcs;
  srcs.push_back(&sd.main_);
  for (IvRun& r : sd.tail) srcs.push_back(&r);
  std::vector<int64_t> cur(srcs.size(), 0);
  for (;;) {
    int64_t s = INT64_MAX;
    for (size_t i = 0; i < srcs.size(); ++i)
      if (cur[i] < static_cast<int64_t>(srcs[i]->touched.size()))
        s = std::min(s, srcs[i]->touched[cur[i]]);
    if (s == INT64_MAX) break;
    int64_t seg_begin = static_cast<int64_t>(out.ts.size());
    for (size_t i = 0; i < srcs.size(); ++i) {
      const IvRun& r = *srcs[i];
      int64_t& c = cur[i];
      if (c < static_cast<int64_t>(r.touched.size())
          && r.touched[c] == s) {
        out.ts.insert(out.ts.end(), r.ts.begin() + r.start[c],
                      r.ts.begin() + r.end[c]);
        out.row.insert(out.row.end(), r.row.begin() + r.start[c],
                       r.row.begin() + r.end[c]);
        ++c;
      }
    }
    if (static_cast<int64_t>(out.ts.size()) > seg_begin) {
      out.touched.push_back(s);
      out.start.push_back(seg_begin);
      out.end.push_back(static_cast<int64_t>(out.ts.size()));
    }
  }
  sd.main_ = std::move(out);
  sd.main_live = total;
  sd.tail.clear();
  sd.tail_rows = 0;
}

}  // namespace

extern "C" {

void* ft_ivjoin_new(int64_t lower, int64_t upper, int64_t capacity_pow2) {
  return new FtIvJoin(lower, upper, capacity_pow2);
}

void ft_ivjoin_free(void* p) { delete static_cast<FtIvJoin*>(p); }

// Push one batch for `side` (0=left, 1=right): probe the OTHER
// side's buffers for pairs (r.ts - l.ts in [lower, upper]), then
// buffer the batch's own rows.  Returns the number of pairs found
// (fetch with ft_ivjoin_pairs).  Rows get global ids in push order.
int64_t ft_ivjoin_push(void* p, int64_t side, const uint64_t* kh,
                       const int64_t* ts, int64_t n) {
  FtIvJoin& j = *static_cast<FtIvJoin*>(p);
  j.table.grow_if_needed(n);
  // phase 1: resolve every row's key slot (independent table probes
  // overlap in the OoO core — the ILP the per-record baseline's
  // hash → probe → search → emit chain cannot get)
  j.slots.resize(n);
  for (int64_t i = 0; i < n; ++i)
    j.slots[i] = j.table.get_or_insert(kh[i]);
  int64_t n_slots = j.table.next_slot;
  // phase 2: stable sort of the batch by slot into a slot-major run
  // (rows of one key contiguous, still ts-sorted — input batches are
  // time-sorted).  Counting sort when the batch is a fair share of
  // the slot domain; comparison sort for small batches so a tiny
  // push never pays O(all keys ever).
  j.perm.resize(n);
  if (4 * n >= n_slots) {
    j.counts.assign(n_slots, 0);
    for (int64_t i = 0; i < n; ++i) j.counts[j.slots[i]]++;
    int64_t acc = 0;
    for (int64_t s = 0; s < n_slots; ++s) {
      int64_t c = j.counts[s];
      j.counts[s] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; ++i) j.perm[j.counts[j.slots[i]]++] = i;
  } else {
    for (int64_t i = 0; i < n; ++i) j.perm[i] = i;
    std::stable_sort(j.perm.begin(), j.perm.end(),
                     [&](int64_t a, int64_t b) {
                       return j.slots[a] < j.slots[b];
                     });
  }
  IvRun run;
  run.ts.resize(n);
  run.row.resize(n);
  int64_t base_row = j.next_row[side];
  int64_t prev_slot = -1;
  for (int64_t k = 0; k < n; ++k) {
    int64_t i = j.perm[k];
    int64_t s = j.slots[i];
    if (s != prev_slot) {
      if (prev_slot != -1) run.end.push_back(k);
      run.touched.push_back(s);
      run.start.push_back(k);
      prev_slot = s;
    }
    run.ts[k] = ts[i];
    run.row[k] = base_row + i;
  }
  if (prev_slot != -1) run.end.push_back(n);
  // phase 3: probe the other side — for each batch key group, walk
  // the other side's <= 1 + IV_MAX_TAILS contiguous segments with
  // monotone two-pointer scans (all streams sequential; each run's
  // touched-list cursor advances monotonically with the batch's
  // ascending groups)
  IvSide& other = j.side_[1 - side];
  int64_t lo_off = side == 0 ? j.lower : -j.upper;
  int64_t hi_off = side == 0 ? j.upper : -j.lower;
  int64_t found0 = static_cast<int64_t>(j.pairs_l.size());
  std::vector<const IvRun*> segs;
  segs.push_back(&other.main_);
  for (const IvRun& r : other.tail) segs.push_back(&r);
  std::vector<int64_t> cur(segs.size(), 0);
  for (size_t gi = 0; gi < run.touched.size(); ++gi) {
    int64_t s = run.touched[gi];
    int64_t ga = run.start[gi], gb = run.end[gi];
    for (size_t si = 0; si < segs.size(); ++si) {
      const IvRun& orun = *segs[si];
      int64_t& c = cur[si];
      const int64_t nt = static_cast<int64_t>(orun.touched.size());
      while (c < nt && orun.touched[c] < s) ++c;
      if (c >= nt || orun.touched[c] != s) continue;
      int64_t b = orun.end[c];
      int64_t lo = orun.start[c], hi = lo;
      for (int64_t k = ga; k < gb; ++k) {
        int64_t t = run.ts[k];
        while (lo < b && orun.ts[lo] < t + lo_off) ++lo;
        if (hi < lo) hi = lo;
        while (hi < b && orun.ts[hi] <= t + hi_off) ++hi;
        for (int64_t m = lo; m < hi; ++m) {
          if (side == 0) {
            j.pairs_l.push_back(run.row[k]);
            j.pairs_r.push_back(orun.row[m]);
          } else {
            j.pairs_l.push_back(orun.row[m]);
            j.pairs_r.push_back(run.row[k]);
          }
        }
      }
    }
  }
  // phase 4: the batch run becomes my newest tail; fold tails into
  // main once they outgrow it (each row merges O(log) times) or the
  // run count hits the cap (bounds probe segments and metadata even
  // when pruning keeps tail_rows small)
  IvSide& mine = j.side_[side];
  mine.tail_rows += n;
  mine.tail.push_back(std::move(run));
  if (mine.tail_rows >= std::max<int64_t>(mine.main_live, IV_MIN_MERGE)
      || static_cast<int64_t>(mine.tail.size()) >= IV_MAX_TAILS)
    iv_merge(mine);
  j.next_row[side] += n;
  return static_cast<int64_t>(j.pairs_l.size()) - found0;
}

// Export and clear the pending pair row ids.
int64_t ft_ivjoin_pairs(void* p, int64_t* l_out, int64_t* r_out) {
  FtIvJoin& j = *static_cast<FtIvJoin*>(p);
  int64_t k = static_cast<int64_t>(j.pairs_l.size());
  std::memcpy(l_out, j.pairs_l.data(), sizeof(int64_t) * k);
  std::memcpy(r_out, j.pairs_r.data(), sizeof(int64_t) * k);
  j.pairs_l.clear();
  j.pairs_r.clear();
  return k;
}

// Drop rows no longer joinable at watermark `wm` (left rows once
// wm >= ts + upper, right rows once wm >= ts - lower): advance every
// segment's start pointer, then compact via merge when most physical
// rows are dead — so a side that stops receiving pushes still
// releases its memory.
void ft_ivjoin_prune(void* p, int64_t wm) {
  FtIvJoin& j = *static_cast<FtIvJoin*>(p);
  for (int side = 0; side < 2; ++side) {
    int64_t horizon = side == 0 ? j.upper : -j.lower;
    IvSide& sd = j.side_[side];
    int64_t dropped = 0;
    for (size_t i = 0; i < sd.main_.touched.size(); ++i) {
      int64_t& a = sd.main_.start[i];
      int64_t b = sd.main_.end[i];
      while (a < b && sd.main_.ts[a] + horizon <= wm) { ++a; ++dropped; }
    }
    sd.main_live -= dropped;
    for (IvRun& r : sd.tail) {
      int64_t rdropped = 0;
      for (size_t i = 0; i < r.touched.size(); ++i) {
        int64_t& a = r.start[i];
        int64_t b = r.end[i];
        while (a < b && r.ts[a] + horizon <= wm) { ++a; ++rdropped; }
      }
      sd.tail_rows -= rdropped;
    }
    int64_t physical = static_cast<int64_t>(sd.main_.ts.size());
    for (const IvRun& r : sd.tail)
      physical += static_cast<int64_t>(r.ts.size());
    int64_t live = sd.main_live + sd.tail_rows;
    if (physical > 2 * live + IV_MIN_MERGE) iv_merge(sd);
  }
}

}  // extern "C"
