// Fused wavepack packer — the C++ production twin of formats/wavepack.py.
//
// The role of this code matches the reference's CPU preprocessor hot loops
// (csr2cpsr + packet packing, sw/data_formatter.h:465-544, sw/host.cpp:
// 163-231): an O(nnz) sequential pipeline that must hit the paper's
// preprocessing budget (Table 8: ~12 Mnnz/s on one thread).  The whole
// pipeline runs native in one pass per stage:
//
//   1. build   — per-nonzero field computation straight off the CSR
//                (renamed row -> block/stripe/lane, column -> partition/
//                bank/address), one 24-byte record per nonzero, the value
//                bits riding along so emission never gathers
//   2. sort    — LSD radix sort on a composite (segment, stripe, class,
//                bank, address) key; stable, so ties keep CSR order
//                exactly like np.argsort(kind="stable") in the twin
//   3. schedule— conflict-free wave assignment (see below)
//   4. emit    — value tile + transposed index word scatter plus all tile
//                metadata (block/part/first/last/class_map)
//
// Scheduling model: per (row block, column partition) segment, nonzeros
// group into "items" = one distinct column within one stripe (<= 128 rows,
// all on distinct row lanes).  A wave places at most one item per gather
// bank and each row lane once; an item may place all its free rows at once
// (hub columns broadcast, the TPU upgrade over the reference's serializing
// arbiter, spmv/libfpga/shuffle.h:24-99).  Both schedulers are
// wave-batched: pending items are visited by descending row count (the
// offline analog of the rotating-priority arbiter) once per window of
// 64 waves, placing each row first-fit into the lowest wave whose bank
// and row-lane 64-bit masks allow it, via the primary bank or the second
// choice.  The block-major variant rolls its window across tiles (classes
// fixed at admission, fruitless-streak-capped walks); the select-chain
// variant uses disjoint windows and needs no cap (one complete pass per
// window).
//
// The Python twins (wavepack._schedule / _schedule_block_major and the
// numpy emission in wavepack.pack) implement the identical algorithm;
// tests/test_formats.py asserts byte-identical streams.  Change BOTH.
//
// Build: g++ -O3 -shared -fPIC -o _scheduler.so _scheduler.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>
#include <algorithm>

namespace {
// WP_PROF=1: print per-stage wall times to stderr (perf debugging)
inline double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}
inline bool wp_prof() {
  static int v = -1;
  if (v < 0) { const char* e = getenv("WP_PROF"); v = e && e[0] == '1'; }
  return v;
}
// NOTE: do NOT madvise(MADV_HUGEPAGE) here.  These hosts run THP in
// madvise mode with synchronous compaction: hugepage faults measured
// ~13 MB/s vs ~1.7 GB/s for plain 4 KiB faults (130x WORSE).  numpy's
// own hugepage madvise is disabled in utils/hostmem.tune_allocator for
// the same reason.
inline int32_t fruitless_cap() {
  // Blocked-item visits tolerated per block-major wave walk before giving
  // up.  256 measured best (powerlaw fill 0.301 -> 0.315, mouse-gene
  // 0.643 -> 0.680; 512 adds nothing).  WP_FCAP overrides for perf
  // experiments ONLY — the Python twin hard-codes the default, so a
  // non-default value breaks byte-equality with it.  (Block-major
  // scheduler only; the select-chain scheduler completes one pass per
  // 64-wave window and needs no cap.)
  static int32_t v = -1;
  if (v < 0) { const char* e = getenv("WP_FCAP"); v = e ? atoi(e) : 256; }
  return v;
}
// Rolling-window wave batching for the block-major scheduler.  A window
// of bm_win in-flight tiles is scheduled per pending-list pass (per-lane /
// per-bank wave bitmasks, first-fit into the lowest free wave), then the
// window advances by bm_adv tiles — so every tile gets bm_win/bm_adv
// dedicated passes while list traversals drop by ~bm_adv vs the per-tile
// walk (which measured 543M item visits for 27M placements).  Each tile's
// K classes are fixed by pending row coverage when it enters the window.
// Both are wp_plan arguments (a tuned, per-matrix speed/fill tradeoff);
// Python resolves the same values and passes them to its twin, so the
// twins stay byte-equal by construction.
}  // namespace

namespace {

inline int32_t bank_shift(int64_t b) {
  return static_cast<int32_t>((b * 61 + 17) % 127 + 1);
}

struct Rec {        // one nonzero, 24 bytes; sorted by key
  int64_t key;
  uint32_t val;     // value bits (fp32 or fixed u32)
  int32_t nz;       // original CSR position (leftover reporting)
  uint16_t sigma;   // stripe within block
  uint16_t a;       // in-partition address: column = part*VB + a*128 + bank
  uint8_t lam;      // row lane
  uint8_t bank;     // gather lane (primary)
  uint8_t pad0;     // (placed-state moved to the g.nxt alive chain)
  uint8_t pad1;
};

struct SchedOut {  // per-record schedule result, one cache touch to write
  int32_t t;        // tile (bm) / wave-within-stripe then tile (chain)
  int16_t s;        // sublane within tile
  uint8_t lane;     // gather lane used
  uint8_t flags;    // bit0 placed, bit1 second-choice
  int32_t bsel;     // local class index (bm); padded for alignment
};

struct Item {       // one (stripe, column)
  int32_t head;     // first record (sorted order)
  uint16_t count;   // rows on distinct lanes (runs > 64K split at build)
  uint16_t remaining;
  uint16_t alive0;  // scan hint: first possibly-alive offset
  uint8_t b1, b2;   // gather lanes (primary / second choice)
  uint8_t c1, c2;   // x-block classes (block-major)
  int32_t stamp;    // bm: last walk serial this item was seen in
  uint64_t stamp_mask;  // bm: window waves already placed in (this walk)
};

struct PlanState {
  int32_t R, S, B, CT, K, G, Rp, n_blocks, n_parts;
  int32_t two_choice, block_major;
  int64_t nnz, T_total, n_left;
  std::vector<Rec> recs, tmp;
  std::vector<int64_t> seg_bounds;           // record ranges per segment
  std::vector<int32_t> seg_block, seg_part;
  std::vector<int64_t> seg_tiles;
  std::vector<SchedOut> out;                 // per-record schedule outputs
  std::vector<int32_t> class_map;            // (T, G, K) flattened (bm)
  // reusable scratch
  std::vector<Item> items;
  std::vector<uint8_t> item_alive;           // bm: remaining > 0, by item id
                                             // (dense twin of Item.remaining
                                             // so blocked/drained probes skip
                                             // the 24B Item load)
  std::vector<uint64_t> placed_bits;         // bm: per-record placed flag
                                             // (dense twin of out[].flags&1
                                             // for the singleton sub-walk)
  // bm: per (stripe, class) multi-item entries, packed
  // item_id(48) | serving_lane(8) | is_primary(1) — the lane lets the
  // walk test bank availability without touching the Item
  std::vector<std::vector<uint64_t>> pend;
  // bm singleton fast path: per (stripe, class) packed entries
  // rec_idx(32) | lam(8) | bank(8) | primary(8) | other_class(8)
  // — scanned sequentially, no Item/Rec/chain indirection (82% of items
  // on hub-heavy graphs are singletons)
  std::vector<std::vector<uint64_t>> pend1;
  std::vector<int32_t> cnt_rlc;              // (R,128,CT) bm row coverage
  std::vector<int64_t> cnt_gc;               // (Rp,CT) pending-row sums
  std::vector<uint32_t> lamnxt;              // per-record lam<<16 | next-alive
                                             // (one 4B load per chain step
                                             // vs 2B nxt + 8B Rec before)
                                             // within its item (== count
                                             // terminates the walk)
  int64_t opt_waves;                         // edge-coloring lower bound
};
PlanState g;

// Exact per-segment schedule lower bound: for every stripe,
// max(max per-lane record count, max per-bank distinct-column count) —
// the bipartite edge-coloring bound the analytical model's alpha measures
// against (the reference instruments its csim the same way,
// performance_model/include/shuffle.h:199,279).  Summed over stripes.
int64_t segment_opt_waves(int64_t lo, int64_t hi) {
  static std::vector<int32_t> lane_cnt, bank_cnt;
  lane_cnt.assign(static_cast<size_t>(g.R) * 128, 0);
  bank_cnt.assign(static_cast<size_t>(g.R) * 128, 0);
  for (int64_t p = lo; p < hi;) {           // items: runs of (sigma,bank,a)
    const uint16_t sg = g.recs[p].sigma;
    const uint8_t b = g.recs[p].bank; const uint16_t a = g.recs[p].a;
    ++bank_cnt[static_cast<size_t>(sg) * 128 + b];
    while (p < hi && g.recs[p].sigma == sg && g.recs[p].bank == b
           && g.recs[p].a == a) {
      ++lane_cnt[static_cast<size_t>(sg) * 128 + g.recs[p].lam];
      ++p;
    }
  }
  int64_t opt = 0;
  for (int32_t sg = 0; sg < g.R; ++sg) {
    int32_t mx = 0;
    const int32_t* lc = lane_cnt.data() + static_cast<size_t>(sg) * 128;
    const int32_t* bc = bank_cnt.data() + static_cast<size_t>(sg) * 128;
    for (int32_t q = 0; q < 128; ++q) {
      if (lc[q] > mx) mx = lc[q];
      if (bc[q] > mx) mx = bc[q];
    }
    opt += mx;
  }
  return opt;
}

void radix_sort(std::vector<Rec>& v, std::vector<Rec>& tmp, int64_t maxkey) {
  // 16-bit digits halve the passes vs 8-bit, and one fused scan builds
  // every pass's histogram (the counting scans were half the sort's
  // memory traffic).  Still a stable LSD radix — identical output.
  int passes = 1;
  while (maxkey >> (16 * passes)) ++passes;
  tmp.resize(v.size());
  static std::vector<int64_t> cnt;
  cnt.assign(static_cast<size_t>(passes) << 16, 0);
  for (const Rec& r : v)
    for (int p = 0; p < passes; ++p)
      ++cnt[(static_cast<size_t>(p) << 16)
            + ((static_cast<uint64_t>(r.key) >> (16 * p)) & 0xFFFF)];
  for (int p = 0; p < passes; ++p) {
    int64_t* c = cnt.data() + (static_cast<size_t>(p) << 16);
    int64_t off = 0;
    for (int b = 0; b < 65536; ++b) { int64_t t = c[b]; c[b] = off; off += t; }
    const int sh = 16 * p;
    for (const Rec& r : v)
      tmp[c[(static_cast<uint64_t>(r.key) >> sh) & 0xFFFF]++] = r;
    v.swap(tmp);
  }
}

// Relabel items into their list-visit order so wave walks stream
// sequentially through memory instead of chasing the build order.
// `lists` = every pending list (entries rewritten in place).
void reorder_items(std::vector<std::vector<int32_t>*>& lists) {
  static std::vector<int32_t> remap;
  static std::vector<Item> items2;
  const int32_t n = static_cast<int32_t>(g.items.size());
  remap.assign(n, -1);
  items2.clear();
  items2.reserve(n);
  for (auto* lst : lists) {
    for (int32_t& id : *lst) {
      if (remap[id] < 0) {
        remap[id] = static_cast<int32_t>(items2.size());
        items2.push_back(g.items[id]);
      }
      id = remap[id];
    }
  }
  g.items.swap(items2);
}

// Same, for the bm packed-entry lists (item id in bits [16..]).
void reorder_items64(std::vector<std::vector<uint64_t>*>& lists) {
  static std::vector<int64_t> remap;
  static std::vector<Item> items2;
  const int64_t n = static_cast<int64_t>(g.items.size());
  remap.assign(n, -1);
  items2.clear();
  items2.reserve(n);
  for (auto* lst : lists) {
    for (uint64_t& e : *lst) {
      const int64_t id = static_cast<int64_t>(e >> 16);
      if (remap[id] < 0) {
        remap[id] = static_cast<int64_t>(items2.size());
        items2.push_back(g.items[id]);
      }
      e = (static_cast<uint64_t>(remap[id]) << 16) | (e & 0xFFFF);
    }
  }
  g.items.swap(items2);
}

// ---------------------------------------------------------------------------
// Select-chain scheduler: per stripe, wave-batched first-fit-decreasing.
// Pending items are visited ONCE per 64-wave window in descending row
// count order (the offline analog of the rotating-priority arbiter); each
// free row goes to the lowest window wave where the item's bank (primary
// first, else the second choice) is unclaimed-or-ours and the row lane is
// free, tracked by per-lane / per-bank uint64 wave masks.  One pass per
// window is complete (masks only grow within a window, so a failed row
// stays failed), and a new window opens only when every wave of the old
// one is nonempty, so wave indices stay gap-free.
// Twin: wavepack._schedule — change BOTH.
// ---------------------------------------------------------------------------
void schedule_chain_segment(int64_t lo, int64_t hi) {
  static std::vector<int32_t> pend;
  int64_t i = lo;
  while (i < hi) {
    const uint16_t st = g.recs[i].sigma;
    int64_t e = i;
    while (e < hi && g.recs[e].sigma == st) ++e;
    // items: runs of (bank, a), split at 64K records (duplicate-heavy runs)
    g.items.clear();
    for (int64_t p = i; p < e;) {
      const uint8_t b = g.recs[p].bank; const uint16_t a = g.recs[p].a;
      Item it{};
      it.head = static_cast<int32_t>(p);
      const int64_t cap = p + 65535;
      while (p < e && p < cap && g.recs[p].bank == b && g.recs[p].a == a) {
        g.lamnxt[p] = (static_cast<uint32_t>(g.recs[p].lam) << 16)
                      | static_cast<uint32_t>(p - it.head + 1);
        ++p;
      }
      it.count = static_cast<uint16_t>(p - it.head);
      it.remaining = it.count;
      it.alive0 = 0; it.stamp = -1;
      it.b1 = b;
      it.b2 = static_cast<uint8_t>(
          g.two_choice ? (b + bank_shift(a >> 7)) % 128 : b);
      g.items.push_back(it);
    }
    const int32_t n_items = static_cast<int32_t>(g.items.size());
    pend.resize(n_items);
    for (int32_t q = 0; q < n_items; ++q) pend[q] = q;
    std::stable_sort(pend.begin(), pend.end(), [](int32_t x, int32_t y) {
      return g.items[x].count > g.items[y].count; });
    {
      static std::vector<std::vector<int32_t>*> lists;
      lists.assign(1, &pend);
      reorder_items(lists);
    }
    int64_t k_base = 0;
    size_t n_pend = pend.size();
    while (n_pend) {
      uint64_t lane_mask[128] = {0};   // per row lane: waves occupied
      uint64_t bank_mask[128] = {0};   // per bank: waves claimed
      size_t wr = 0;                   // stable in-place compaction
      for (size_t ii = 0; ii < n_pend; ++ii) {
        Item& it = g.items[pend[ii]];
        uint64_t m1 = 0, m2 = 0;       // waves THIS item claimed per bank
        int32_t placed = 0, prev = -1;
        const int32_t cnt = it.count;
        int32_t o = it.alive0;
        while (o < cnt) {
          const int32_t idx = it.head + o;
          const uint32_t ln = g.lamnxt[idx];
          const int32_t nx = static_cast<int32_t>(ln & 0xFFFF);
          const int32_t lm = static_cast<int32_t>(ln >> 16);
          const uint64_t freew = ~lane_mask[lm];
          // INVARIANT (emission depends on this): a (wave, bank) pair is
          // claimed by exactly one item (m1/m2 readmit only our own
          // claims), so duplicate gather-slot writes carry identical b|h
          // fields and OR-ing them is write-order independent.
          uint64_t cand = (~bank_mask[it.b1] | m1) & freew;
          int32_t lane; uint8_t ch;
          if (cand) { lane = it.b1; ch = 0; }
          else {
            cand = (~bank_mask[it.b2] | m2) & freew;
            if (!cand) { prev = o; o = nx; continue; }  // next window
            lane = it.b2; ch = 1;
          }
          const int32_t w = __builtin_ctzll(cand);
          const uint64_t bit = 1ull << w;
          if (ch) m2 |= bit; else m1 |= bit;
          bank_mask[lane] |= bit;
          lane_mask[lm] |= bit;
          SchedOut& so = g.out[idx];
          so.t = static_cast<int32_t>(k_base + w);  // wave within stripe
          so.lane = static_cast<uint8_t>(lane);
          so.flags = static_cast<uint8_t>(1 | (ch << 1));
          ++placed;
          if (prev < 0) it.alive0 = static_cast<uint16_t>(nx);
          else
            g.lamnxt[it.head + prev] =
                (g.lamnxt[it.head + prev] & 0xFFFF0000u)
                | static_cast<uint32_t>(nx);
          o = nx;
        }
        it.remaining = static_cast<uint16_t>(it.remaining - placed);
        if (it.remaining) pend[wr++] = pend[ii];
      }
      n_pend = wr;
      k_base += 64;
    }
    i = e;
  }
}

// ---------------------------------------------------------------------------
// Block-major (class-group) scheduler: every 128-wave group serves K
// x-block classes chosen by pending row coverage; per (stripe, class) the
// pending items are walked by descending row count with a fruitless-streak
// cap, placing via the primary bank or the cross-class second choice.
// Twin: wavepack._schedule_block_major.
// ---------------------------------------------------------------------------
double bm_t_build = 0, bm_t_cover = 0, bm_t_pend = 0, bm_t_wave = 0;
int64_t bm_visits = 0, bm_blocked = 0, bm_chain = 0, bm_placed = 0,
        bm_passes = 0, bm_walks = 0, bm_sgl = 0;

void schedule_bm_segment(int64_t lo, int64_t hi, int64_t min_tile,
                         int32_t bm_win, int32_t bm_adv,
                         int64_t t_base, int64_t& tiles_out) {
  const int32_t R = g.R, CT = g.CT, K = g.K, G = g.G, Rp = g.Rp, B = g.B;
  double tb0 = now_s();
  // row-coverage counters for class scoring
  g.cnt_rlc.assign(static_cast<size_t>(R) * 128 * CT, 0);
  // admission scores are sums of per-(sg, c) distinct-pending-row counts
  // over the group's 128 stripes; maintained incrementally (exactly the
  // value the old 128xCT strided re-scan computed, ~1 GB of reads per
  // 27M-nnz pack)
  g.cnt_gc.assign(static_cast<size_t>(Rp) * CT, 0);
  auto cover_inc = [&](int32_t sg, int32_t lm, int32_t c) {
    if (++g.cnt_rlc[(static_cast<size_t>(sg) * 128 + lm) * CT + c] == 1)
      ++g.cnt_gc[static_cast<size_t>(sg >> 7) * CT + c];
  };
  if (g.pend.size() < static_cast<size_t>(R) * CT) {
    g.pend.resize(static_cast<size_t>(R) * CT);
    g.pend1.resize(static_cast<size_t>(R) * CT);
  }
  for (size_t c = 0; c < static_cast<size_t>(R) * CT; ++c) {
    g.pend[c].clear();
    g.pend1[c].clear();
  }
  // items: runs of (sigma, cls, bank, h) == (sigma, bank, a) in the
  // pre-sorted record order.  Singletons (the large majority on
  // hub-heavy graphs) go to the packed pend1 arrays; multi-row items to
  // the Item machinery.
  g.items.clear();
  for (int64_t p = lo; p < hi;) {
    const uint16_t sg = g.recs[p].sigma;
    const uint8_t b = g.recs[p].bank; const uint16_t a = g.recs[p].a;
    const int64_t head = p;
    const int64_t cap = p + 65535;
    while (p < hi && p < cap && g.recs[p].sigma == sg && g.recs[p].bank == b
           && g.recs[p].a == a) {
      g.lamnxt[p] = (static_cast<uint32_t>(g.recs[p].lam) << 16)
                    | static_cast<uint32_t>(p - head + 1);
      ++p;
    }
    const int32_t count = static_cast<int32_t>(p - head);
    const uint8_t c1 = static_cast<uint8_t>(a >> 7);
    uint8_t c2, b2;
    if (g.two_choice) {
      c2 = static_cast<uint8_t>(B + a % B);
      b2 = static_cast<uint8_t>((b + bank_shift(a % B)) % 128);
    } else { c2 = c1; b2 = b; }
    if (count == 1) {
      const uint8_t lm = g.recs[head].lam;
      cover_inc(sg, lm, c1);
      g.pend1[static_cast<size_t>(sg) * CT + c1].push_back(
          (static_cast<uint64_t>(head) << 32)
          | (static_cast<uint64_t>(lm) << 24)
          | (static_cast<uint64_t>(b) << 16) | (1ull << 8) | c2);
      if (c2 != c1) {
        cover_inc(sg, lm, c2);
        g.pend1[static_cast<size_t>(sg) * CT + c2].push_back(
            (static_cast<uint64_t>(head) << 32)
            | (static_cast<uint64_t>(lm) << 24)
            | (static_cast<uint64_t>(b2) << 16) | (0ull << 8) | c1);
      }
      continue;
    }
    Item it{};
    it.head = static_cast<int32_t>(head);
    it.count = static_cast<uint16_t>(count);
    it.remaining = it.count;
    it.alive0 = 0; it.stamp = -1;
    it.b1 = b; it.c1 = c1; it.c2 = c2; it.b2 = b2;
    for (int32_t o = 0; o < count; ++o) {
      const int32_t lm = g.recs[head + o].lam;
      cover_inc(sg, lm, c1);
      if (c2 != c1) cover_inc(sg, lm, c2);
    }
    g.items.push_back(it);
  }
  const int32_t n_items = static_cast<int32_t>(g.items.size());
  double tb2 = now_s(); bm_t_build += tb2 - tb0;
  // pending lists per (stripe, class): packed multi-item entries
  // (id | serving lane | is_primary), desc count stable.  An item appears
  // under c1 (serving via b1) and (two-choice) under c2 (via b2).
  for (int32_t q = 0; q < n_items; ++q) {
    const Item& it = g.items[q];
    const int32_t sg = g.recs[it.head].sigma;
    g.pend[static_cast<size_t>(sg) * CT + it.c1].push_back(
        (static_cast<uint64_t>(q) << 16)
        | (static_cast<uint64_t>(it.b1) << 8) | 1ull);
    if (it.c2 != it.c1)
      g.pend[static_cast<size_t>(sg) * CT + it.c2].push_back(
          (static_cast<uint64_t>(q) << 16)
          | (static_cast<uint64_t>(it.b2) << 8));
  }
  for (size_t c = 0; c < static_cast<size_t>(R) * CT; ++c) {
    std::stable_sort(g.pend[c].begin(), g.pend[c].end(),
                     [](uint64_t x, uint64_t y) {
                       return g.items[x >> 16].count
                              > g.items[y >> 16].count; });
  }
  {
    static std::vector<std::vector<uint64_t>*> lists;
    lists.clear();
    for (size_t c = 0; c < static_cast<size_t>(R) * CT; ++c)
      if (!g.pend[c].empty()) lists.push_back(&g.pend[c]);
    reorder_items64(lists);
  }
  g.item_alive.assign(g.items.size(), 1);

  double tb3 = now_s(); bm_t_pend += tb3 - tb2;
  // Rolling-window wave batching (see bm_win/bm_adv above).  Window slots
  // 0..admitted-1 hold tiles t_win..t_win+admitted-1.  Per (group, u) the
  // walk places items into any in-window wave via per-lane / per-bank
  // uint64 wave masks that PERSIST across passes (shifted on advance), so
  // every tile accumulates placements over BM_WIN/BM_ADV passes.  A
  // tile's K classes per group are fixed when it is admitted.
  const int32_t W = std::max(1, std::min(bm_win, 64));  // uint64 wave masks
  const int32_t ADV = std::max(1, std::min(bm_adv, W));
  const size_t n_walks = static_cast<size_t>(G) * 128;
  static std::vector<uint64_t> lmask_all, bmask_all;
  lmask_all.assign(n_walks * 128, 0);
  bmask_all.assign(n_walks * 128, 0);
  // has-pending bitmap over (sg, c): late passes probe mostly-drained
  // lists, and the two scattered vector-header loads per probe dominate
  // the per-pass overhead; the bitmap (R*CT bits, cache-resident) makes
  // the skip a bit test.  Monotone (lists only shrink), so clearing on
  // drain is exact — pure speedup, walk order unchanged.
  static std::vector<uint64_t> has_pend;
  has_pend.assign((static_cast<size_t>(R) * CT + 63) / 64, 0);
  for (size_t cc = 0; cc < static_cast<size_t>(R) * CT; ++cc)
    if (!g.pend[cc].empty() || !g.pend1[cc].empty())
      has_pend[cc >> 6] |= 1ull << (cc & 63);
  // Forward-only exam cursors, per (walk, class).  Within a window
  // "epoch" (no new tile-mask bit for this (g, c)) the lane/bank masks
  // only grow and shift identically with the tile mask on advance, so an
  // entry found blocked stays blocked until a fresh admitted tile
  // selects the class — re-scanning it is provably fruitless.  Each exam
  // therefore RESUMES where the previous one stopped (cursor), and the
  // cursor resets to 0 whenever the tile mask gains a new bit (so hubs
  // regain first-priority at every admission).  Compared to the old
  // restart-at-0 walk this both eliminates the blocked-prefix re-scans
  // (mouse-gene: 260M singleton visits for 27M placements) AND lets the
  // fruitless cap spend its budget on never-examined entries instead of
  // the same stuck prefix — deeper lists now get coverage, so fill can
  // only improve.  prev_tm is shifted on advance so bit positions always
  // name the same physical tile.  SCHEDULE-CHANGING: the Python twin
  // (wavepack._schedule_block_major) implements the identical cursors.
  static std::vector<uint64_t> walk_prevtm;
  static std::vector<uint32_t> cur_lst, cur_sgl;
  walk_prevtm.assign(n_walks * CT, 0);
  cur_lst.assign(n_walks * CT, 0);
  cur_sgl.assign(n_walks * CT, 0);
  // per (g, slot, k): selected class; per (g, c): in-window slot bits;
  // per (g, c, slot): the class's index within that tile's selection
  static std::vector<int32_t> sel;
  static std::vector<uint64_t> tilemask;
  static std::vector<int8_t> bsel_tab;
  sel.assign(static_cast<size_t>(G) * W * K, 0);
  tilemask.assign(static_cast<size_t>(G) * CT, 0);
  bsel_tab.assign(static_cast<size_t>(G) * CT * W, -1);
  std::vector<int64_t> placed_w(W, 0);
  std::vector<int64_t> scores(CT);
  std::vector<int32_t> top(K);
  std::vector<int32_t> corder;            // per-pass class walk order
  std::vector<uint8_t> cseen(CT);
  int64_t remaining = hi - lo;
  int64_t t_win = 0;                      // absolute tile of slot 0
  int64_t high = -1;                      // highest tile with a placement
  int32_t admitted = 0;
  int32_t walk_serial = 0;
  int32_t zero_streak = 0;
  const size_t cm_start = g.class_map.size();
  while (remaining > 0) {
    // admit up to ADV fresh tiles, selecting their classes from current
    // pending row coverage
    const int32_t admit = std::min(ADV, W - admitted);
    for (int32_t anew = 0; anew < admit; ++anew) {
      const int32_t slot = admitted + anew;
      for (int32_t grp = 0; grp < G; ++grp) {
        const int32_t gmod = grp % Rp;
        const int64_t* gc = g.cnt_gc.data()
                            + static_cast<size_t>(gmod) * CT;
        for (int32_t c = 0; c < CT; ++c) scores[c] = gc[c];
        for (int32_t kk = 0; kk < K; ++kk) {   // stable top-K (ties: low c)
          int32_t best = -1; int64_t bv = -1;
          for (int32_t c = 0; c < CT; ++c) {
            bool taken = false;
            for (int32_t q2 = 0; q2 < kk; ++q2) if (top[q2] == c) taken = true;
            if (!taken && scores[c] > bv) { bv = scores[c]; best = c; }
          }
          if (best < 0) best = 0;              // K > CT degenerate configs
          top[kk] = best;
          sel[(static_cast<size_t>(grp) * W + slot) * K + kk] = best;
          tilemask[static_cast<size_t>(grp) * CT + best] |= 1ull << slot;
          bsel_tab[(static_cast<size_t>(grp) * CT + best) * W + slot] =
              static_cast<int8_t>(kk);
        }
      }
    }
    admitted += admit;
    // one pass over every (group, u) walk
    ++bm_passes;
    int64_t pass_placed = 0;
    for (int32_t grp = 0; grp < G; ++grp) {
      const int32_t gmod = grp % Rp;
      // class walk order: slot-major over the window's selections
      corder.clear();
      std::fill(cseen.begin(), cseen.end(), 0);
      for (int32_t w = 0; w < admitted; ++w)
        for (int32_t kk = 0; kk < K; ++kk) {
          const int32_t c = sel[(static_cast<size_t>(grp) * W + w) * K + kk];
          if (!cseen[c]) { cseen[c] = 1; corder.push_back(c); }
        }
      const uint64_t* tmg = tilemask.data() + static_cast<size_t>(grp) * CT;
      for (int32_t u = 0; u < 128; ++u) {
        const int32_t sg = gmod * 128 + u;
        const int64_t s_glob = static_cast<int64_t>(grp) * 128 + u;
        ++walk_serial;
        uint64_t* lane_mask =
            lmask_all.data() + (static_cast<size_t>(grp) * 128 + u) * 128;
        uint64_t* bank_mask =
            bmask_all.data() + (static_cast<size_t>(grp) * 128 + u) * 128;
        for (const int32_t c : corder) {
          const size_t cc = static_cast<size_t>(sg) * CT + c;
          if (!(has_pend[cc >> 6] & (1ull << (cc & 63)))) continue;
          auto& lst = g.pend[cc];
          auto& sgl = g.pend1[cc];
          if (lst.empty() && sgl.empty()) {
            has_pend[cc >> 6] &= ~(1ull << (cc & 63));
            continue;
          }
          const uint64_t tm = tmg[c];
          if (!tm) continue;
          const size_t wc = (static_cast<size_t>(grp) * 128
                             + static_cast<size_t>(u)) * CT + c;
          if (tm & ~walk_prevtm[wc]) {         // fresh capacity: rescan
            cur_lst[wc] = 0;
            cur_sgl[wc] = 0;
          }
          walk_prevtm[wc] = tm;
          if (cur_lst[wc] >= lst.size() && cur_sgl[wc] >= sgl.size())
            continue;                          // epoch exhausted
          const int8_t* bsl =
              bsel_tab.data() + (static_cast<size_t>(grp) * CT + c) * W;
          const int32_t FCAP = fruitless_cap();
          int32_t fruitless = 0;
          size_t ii = cur_lst[wc];
          while (ii < lst.size()) {
            if (fruitless >= FCAP) break;
            ++bm_visits;
            const uint64_t ent = lst[ii];
            const size_t id = static_cast<size_t>(ent >> 16);
            if (!g.item_alive[id]) {           // drained: swap-remove
              lst[ii] = lst.back();
              lst.pop_back();
              continue;                         // revisit slot ii
            }
            // bank-availability pre-check off the packed entry alone:
            // avail below is a subset of avail0, so a zero here is the
            // same fruitless outcome without the 24B Item load
            const int32_t lane = static_cast<int32_t>((ent >> 8) & 0xFF);
            const uint64_t avail0 = tm & ~bank_mask[lane];
            if (!avail0) { ++ii; ++fruitless; ++bm_blocked; continue; }
            Item& it = g.items[id];
            if (it.stamp != walk_serial) {     // lazy per-walk stamp reset
              it.stamp = walk_serial;
              it.stamp_mask = 0;
            }
            const bool is_primary = ent & 1;
            // waves this item may still use: class selected in the tile,
            // bank free, not already placed into by this item this walk
            // (one column per (wave, bank) — the emission invariant)
            const uint64_t avail = avail0 & ~it.stamp_mask;
            if (!avail) { ++ii; ++fruitless; ++bm_blocked; continue; }
            const int32_t c1 = it.c1, c2 = it.c2;
            uint64_t placed_mask = 0;
            int32_t placed = 0, prev = -1;
            const int32_t cnt = it.count;
            int32_t o = it.alive0;
            while (o < cnt) {
              ++bm_chain;
              const int32_t idx = it.head + o;
              const uint32_t ln = g.lamnxt[idx];
              const int32_t nx = static_cast<int32_t>(ln & 0xFFFF);
              const int32_t lm = static_cast<int32_t>(ln >> 16);
              const uint64_t cand = avail & ~lane_mask[lm];
              if (!cand) { prev = o; o = nx; continue; }
              const int32_t w = __builtin_ctzll(cand);
              lane_mask[lm] |= 1ull << w;
              SchedOut& so = g.out[idx];
              so.t = static_cast<int32_t>(t_base + t_win + w);
              so.s = static_cast<int16_t>(s_glob);
              so.lane = static_cast<uint8_t>(lane);
              so.bsel = bsl[w];
              so.flags = static_cast<uint8_t>(is_primary ? 1 : 3);
              const size_t rbase = (static_cast<size_t>(sg) * 128 + lm) * CT;
              const size_t gcb = static_cast<size_t>(sg >> 7) * CT;
              if (--g.cnt_rlc[rbase + c1] == 0) --g.cnt_gc[gcb + c1];
              if (c2 != c1 && --g.cnt_rlc[rbase + c2] == 0)
                --g.cnt_gc[gcb + c2];
              placed_mask |= 1ull << w;
              ++placed_w[w];
              if (t_win + w > high) high = t_win + w;
              ++placed;
              if (prev < 0) it.alive0 = static_cast<uint16_t>(nx);
              else
                g.lamnxt[it.head + prev] =
                    (g.lamnxt[it.head + prev] & 0xFFFF0000u)
                    | static_cast<uint32_t>(nx);
              o = nx;
            }
            if (placed) {
              bank_mask[lane] |= placed_mask;
              it.stamp_mask |= placed_mask;
              it.remaining = static_cast<uint16_t>(it.remaining - placed);
              if (it.remaining == 0) g.item_alive[id] = 0;
              remaining -= placed;
              pass_placed += placed;
              fruitless = 0;
            } else {
              ++fruitless;
            }
            ++ii;
          }
          cur_lst[wc] = static_cast<uint32_t>(ii);
          // singleton sub-walk: sequential scan of packed entries (no
          // Item/chain state; a single placed via its other class list
          // is detected by the dense placed bitset — the cache-resident
          // twin of out[].flags&1 — and swap-removed)
          size_t jj = cur_sgl[wc];
          while (jj < sgl.size()) {
            if (fruitless >= FCAP) break;
            ++bm_sgl;
            const uint64_t e = sgl[jj];
            // mask tests FIRST: they read only the sequential entry plus
            // the cache-resident mask LUTs.  The placed-elsewhere bitset
            // probe is a random load over nnz/8 bytes (the measured ~15
            // cycles/probe memory-latency bound) — defer it until the
            // entry actually has candidate waves, so the blocked
            // majority never pays it.  Dead entries linger while their
            // bank is blocked (they place nothing either way); removal
            // happens at first unblocked visit.  Twin:
            // wavepack._schedule_block_major singleton sub-walk — same
            // test order, change BOTH.
            const int32_t lm = static_cast<int32_t>((e >> 24) & 0xFF);
            const int32_t lane = static_cast<int32_t>((e >> 16) & 0xFF);
            const uint64_t cand = tm & ~bank_mask[lane] & ~lane_mask[lm];
            if (!cand) { ++jj; ++fruitless; continue; }
            const int32_t idx = static_cast<int32_t>(e >> 32);
            if (g.placed_bits[static_cast<size_t>(idx) >> 6]
                & (1ull << (idx & 63))) {      // placed elsewhere: remove
              sgl[jj] = sgl.back();
              sgl.pop_back();
              continue;                         // revisit slot jj
            }
            const int32_t w = __builtin_ctzll(cand);
            const int32_t primary = static_cast<int32_t>((e >> 8) & 1);
            const int32_t c_oth = static_cast<int32_t>(e & 0xFF);
            const int32_t c1 = primary ? c : c_oth;
            const int32_t c2 = primary ? c_oth : c;
            lane_mask[lm] |= 1ull << w;
            bank_mask[lane] |= 1ull << w;
            g.placed_bits[static_cast<size_t>(idx) >> 6] |= 1ull << (idx & 63);
            SchedOut& so = g.out[idx];
            so.t = static_cast<int32_t>(t_base + t_win + w);
            so.s = static_cast<int16_t>(s_glob);
            so.lane = static_cast<uint8_t>(lane);
            so.bsel = bsl[w];
            so.flags = static_cast<uint8_t>(primary ? 1 : 3);
            const size_t rbase = (static_cast<size_t>(sg) * 128 + lm) * CT;
            const size_t gcb = static_cast<size_t>(sg >> 7) * CT;
            if (--g.cnt_rlc[rbase + c1] == 0) --g.cnt_gc[gcb + c1];
            if (c2 != c1 && --g.cnt_rlc[rbase + c2] == 0)
              --g.cnt_gc[gcb + c2];
            ++placed_w[w];
            if (t_win + w > high) high = t_win + w;
            --remaining;
            ++pass_placed;
            fruitless = 0;
            sgl[jj] = sgl.back();               // placed: swap-remove
            sgl.pop_back();
          }
          cur_sgl[wc] = static_cast<uint32_t>(jj);
        }
      }
    }
    if (remaining == 0) break;
    if (pass_placed == 0) {
      // defensive: once the whole window has been re-selected with no
      // placement, nothing pending can ever place (invalid geometry)
      if (++zero_streak > W / ADV + 1) break;
    } else {
      zero_streak = 0;
    }
    if (admitted == W) {
      // retire the ADV oldest tiles: emit their class_map rows, shift
      // the window state down
      int64_t retired_placed = 0;
      for (int32_t wr = 0; wr < ADV; ++wr) {
        retired_placed += placed_w[wr];
        for (int32_t grp = 0; grp < G; ++grp)
          for (int32_t kk = 0; kk < K; ++kk)
            g.class_map.push_back(
                sel[(static_cast<size_t>(grp) * W + wr) * K + kk]);
      }
      for (size_t e = 0; e < lmask_all.size(); ++e) lmask_all[e] >>= ADV;
      for (size_t e = 0; e < bmask_all.size(); ++e) bmask_all[e] >>= ADV;
      for (size_t e = 0; e < tilemask.size(); ++e) tilemask[e] >>= ADV;
      for (size_t e = 0; e < walk_prevtm.size(); ++e) walk_prevtm[e] >>= ADV;
      for (int32_t grp = 0; grp < G; ++grp) {
        for (int32_t w = 0; w < W - ADV; ++w)
          for (int32_t kk = 0; kk < K; ++kk)
            sel[(static_cast<size_t>(grp) * W + w) * K + kk] =
                sel[(static_cast<size_t>(grp) * W + w + ADV) * K + kk];
        for (int32_t c = 0; c < CT; ++c) {
          int8_t* bsl =
              bsel_tab.data() + (static_cast<size_t>(grp) * CT + c) * W;
          for (int32_t w = 0; w < W - ADV; ++w) bsl[w] = bsl[w + ADV];
          for (int32_t w = W - ADV; w < W; ++w) bsl[w] = -1;
        }
      }
      for (int32_t w = 0; w < W - ADV; ++w) placed_w[w] = placed_w[w + ADV];
      for (int32_t w = W - ADV; w < W; ++w) placed_w[w] = 0;
      admitted -= ADV;
      t_win += ADV;
      if (min_tile > 0 && retired_placed < min_tile * ADV) break;
    }
  }
  // flush class_map rows for in-window tiles that received placements,
  // then trim to exactly T_seg rows (retired-empty trailing tiles)
  const int64_t T_seg = high + 1;
  for (int64_t tt = t_win; tt < T_seg; ++tt) {
    const int32_t slot = static_cast<int32_t>(tt - t_win);
    for (int32_t grp = 0; grp < G; ++grp)
      for (int32_t kk = 0; kk < K; ++kk)
        g.class_map.push_back(
            sel[(static_cast<size_t>(grp) * W + slot) * K + kk]);
  }
  g.class_map.resize(cm_start + static_cast<size_t>(T_seg) * G * K, 0);
  bm_t_wave += now_s() - tb3;
  tiles_out = T_seg;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills *out_T (total tiles) and *out_nleft
// (unplaced nonzeros, nonzero only under min_tile early stop).
int64_t wp_plan(
    int64_t nnz, int64_t n_rows,
    const int64_t* indptr, const int32_t* indices, const uint32_t* data_bits,
    const int64_t* rank, const int64_t* col_rank,
    int32_t n_blocks, int32_t n_parts, int32_t R, int32_t S, int32_t B,
    int32_t two_choice, int32_t block_major, int32_t K,
    int32_t bm_win, int32_t bm_adv,
    int64_t min_tile, int64_t* out_T, int64_t* out_nleft,
    int64_t* out_opt_waves);

void wp_emit_full(
    int32_t steal_mantissa, int32_t val16, int32_t idx16, uint32_t pad_bits,
    uint32_t* vals, int32_t* idxT,
    int32_t* t_block, int32_t* t_part, int32_t* t_first, int32_t* t_last,
    int32_t* class_map, int64_t* leftover);

}  // extern "C"

int64_t wp_plan(
    int64_t nnz, int64_t n_rows,
    const int64_t* indptr, const int32_t* indices, const uint32_t* data_bits,
    const int64_t* rank, const int64_t* col_rank,
    int32_t n_blocks, int32_t n_parts, int32_t R, int32_t S, int32_t B,
    int32_t two_choice, int32_t block_major, int32_t K,
    int32_t bm_win, int32_t bm_adv,
    int64_t min_tile, int64_t* out_T, int64_t* out_nleft,
    int64_t* out_opt_waves) {
  g.R = R; g.S = S; g.B = B; g.K = K; g.G = S / 128; g.Rp = R / 128;
  g.n_blocks = n_blocks; g.n_parts = n_parts;
  g.two_choice = two_choice; g.block_major = block_major;
  g.CT = block_major ? (two_choice ? 2 * B : B) : B;
  g.nnz = nnz;
  const int64_t VB = static_cast<int64_t>(B) * 128 * 128;
  const int64_t amax = static_cast<int64_t>(B) * 128;

  const double tp0 = now_s();
  g.recs.resize(nnz);
  int64_t maxkey = 0;
  {
    int64_t w = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
      const int64_t rho = rank[r];
      const int64_t blk = rho % n_blocks;
      const int64_t rl = rho / n_blocks;
      const int64_t sigma = rl % R, lam = rl / R;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p, ++w) {
        const int64_t col = col_rank ? col_rank[indices[p]] : indices[p];
        const int64_t part = col / VB, cin = col % VB;
        const int64_t bank = cin % 128, a = cin / 128;
        const int64_t seg = blk * n_parts + part;
        int64_t key;
        if (block_major)
          key = ((((seg * R + sigma) * B + (a >> 7)) * 128 + bank) << 7)
                + (a & 127);
        else
          key = ((seg * R + sigma) * 128 + bank) * amax + a;
        Rec& rec = g.recs[w];
        rec.key = key;
        rec.val = data_bits[p];
        rec.nz = static_cast<int32_t>(p);
        rec.sigma = static_cast<uint16_t>(sigma);
        rec.a = static_cast<uint16_t>(a);
        rec.lam = static_cast<uint8_t>(lam);
        rec.bank = static_cast<uint8_t>(bank);
        if (key > maxkey) maxkey = key;
      }
    }
  }
  const double tp1 = now_s();
  radix_sort(g.recs, g.tmp, maxkey);
  const double tp2 = now_s();

  // segment boundaries: key / seg_div changes
  const int64_t seg_div = static_cast<int64_t>(R) * B * 128 * 128;
  g.seg_bounds.clear(); g.seg_block.clear(); g.seg_part.clear();
  int64_t prev_seg = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t seg = g.recs[i].key / seg_div;
    if (seg != prev_seg) {
      g.seg_bounds.push_back(i);
      g.seg_block.push_back(static_cast<int32_t>(seg / n_parts));
      g.seg_part.push_back(static_cast<int32_t>(seg % n_parts));
      prev_seg = seg;
    }
  }
  g.seg_bounds.push_back(nnz);
  const int64_t n_segs = static_cast<int64_t>(g.seg_block.size());

  g.out.assign(nnz, SchedOut{0, 0, 0, 0, 0});
  if (block_major)
    g.placed_bits.assign(static_cast<size_t>(nnz + 63) / 64, 0);
  g.lamnxt.resize(nnz);
  g.class_map.clear();
  g.seg_tiles.assign(n_segs, 0);

  int64_t t_base = 0;
  g.opt_waves = 0;
  for (int64_t s = 0; s < n_segs; ++s) {
    const int64_t lo = g.seg_bounds[s], hi = g.seg_bounds[s + 1];
    g.opt_waves += segment_opt_waves(lo, hi);
    if (block_major) {
      int64_t tiles = 0;
      schedule_bm_segment(lo, hi, min_tile, bm_win, bm_adv, t_base, tiles);
      g.seg_tiles[s] = tiles;
      t_base += tiles;
    } else {
      schedule_chain_segment(lo, hi);
      // waves -> tiles: w = sigma + k*R; tile = t_base + w/S, s = w%S
      int64_t wmax = 0;
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t w = g.recs[i].sigma
                          + static_cast<int64_t>(g.out[i].t) * R;
        if (w > wmax) wmax = w;
        g.out[i].t = static_cast<int32_t>(t_base + w / S);
        g.out[i].s = static_cast<int16_t>(w % S);
      }
      const int64_t tiles = wmax / S + 1;
      g.seg_tiles[s] = tiles;
      t_base += tiles;
    }
  }
  g.T_total = t_base;
  if (wp_prof()) {
    fprintf(stderr, "wp_plan: build %.2fs sort %.2fs sched %.2fs"
            " (bm: items %.2f cover %.2f pend %.2f wave %.2f)\n",
            tp1 - tp0, tp2 - tp1, now_s() - tp2,
            bm_t_build, bm_t_cover, bm_t_pend, bm_t_wave);
    fprintf(stderr, "bm counters: passes %ld visits %ld blocked %ld"
            " chain %ld sgl %ld nnz %ld\n",
            (long)bm_passes, (long)bm_visits, (long)bm_blocked,
            (long)bm_chain, (long)bm_sgl, (long)g.nnz);
    bm_t_build = bm_t_cover = bm_t_pend = bm_t_wave = 0;
    bm_visits = bm_blocked = bm_chain = bm_passes = bm_sgl = 0;
  }
  int64_t nleft = 0;
  if (block_major) {
    for (int64_t i = 0; i < nnz; ++i) nleft += ((g.out[i].flags & 1) == 0);
  }
  g.n_left = nleft;
  *out_T = g.T_total;
  *out_nleft = nleft;
  *out_opt_waves = g.opt_waves;
  return 0;
}

void wp_emit_full(
    int32_t steal_mantissa, int32_t val16, int32_t idx16, uint32_t pad_bits,
    uint32_t* vals, int32_t* idxT,
    int32_t* t_block, int32_t* t_part, int32_t* t_first, int32_t* t_last,
    int32_t* class_map, int64_t* leftover) {
  const int32_t S = g.S, B = g.B;
  const int64_t T = g.T_total;
  const size_t tile_words = static_cast<size_t>(S) * 128;
  uint16_t* vals16 = reinterpret_cast<uint16_t*>(vals);
  // idx16: steal_mantissa packs carry only b(4)|h(7) per idx word, so the
  // stream emits int16 (6 B/slot with fp32 values) — config.idx16
  uint16_t* idxT16 = reinterpret_cast<uint16_t*>(idxT);
  const double te0 = now_s();
  if (val16) {
    const uint16_t p16 = static_cast<uint16_t>(pad_bits);
    for (size_t i = 0; i < static_cast<size_t>(T) * tile_words; ++i)
      vals16[i] = p16;
  } else {
    for (size_t i = 0; i < static_cast<size_t>(T) * tile_words; ++i)
      vals[i] = pad_bits;
  }
  std::memset(idxT, 0,
              static_cast<size_t>(T) * tile_words * (idx16 ? 2 : 4));
  const double te1 = now_s();

  int64_t nl = 0;
  for (int64_t i = 0; i < g.nnz; ++i) {
    const Rec& r = g.recs[i];
    const SchedOut& so = g.out[i];
    if (g.block_major && !(so.flags & 1)) {
      if (leftover) leftover[nl] = r.nz;
      ++nl;
      continue;
    }
    const int32_t lane = so.lane;
    const int32_t ch = (so.flags >> 1) & 1;
    int32_t bf, ha;
    if (g.block_major) {
      bf = so.bsel;
      ha = (g.two_choice && ch) ? (r.a / B) : (r.a & 127);
    } else if (g.two_choice) {
      bf = (r.a >> 7) + B * ch;
      ha = r.a & 127;
    } else {
      bf = r.a >> 7;
      ha = r.a & 127;
    }
    const int64_t t = so.t;
    const int64_t s = so.s;
    const int64_t grp = s >> 7, rr = s & 127;
    const size_t base = static_cast<size_t>(t) * tile_words;
    const size_t gbase = base + (static_cast<size_t>(grp) << 7) * 128;
    if (idx16)
      idxT16[gbase + static_cast<size_t>(lane) * 128 + rr] |=
          static_cast<uint16_t>((bf << 7) | ha);
    else
      idxT[gbase + static_cast<size_t>(lane) * 128 + rr] |= (bf << 7) | ha;
    const int32_t lm = r.lam;
    if (steal_mantissa) {
      vals[base + static_cast<size_t>(s) * 128 + lm] =
          (r.val & 0xFFFFFF80u) | static_cast<uint32_t>(lane);
    } else {
      idxT[gbase + static_cast<size_t>(lm) * 128 + rr] |= lane << 11;
      if (val16)
        vals16[base + static_cast<size_t>(s) * 128 + lm] =
            static_cast<uint16_t>(r.val);
      else
        vals[base + static_cast<size_t>(s) * 128 + lm] = r.val;
    }
  }
  const double te2 = now_s();
  // tile metadata
  int64_t t = 0;
  for (size_t s = 0; s < g.seg_tiles.size(); ++s) {
    for (int64_t q = 0; q < g.seg_tiles[s]; ++q, ++t) {
      t_block[t] = g.seg_block[s];
      t_part[t] = g.seg_part[s];
    }
  }
  for (int64_t q = 0; q < T; ++q) {
    t_first[q] = (q == 0 || t_block[q] != t_block[q - 1]) ? 1 : 0;
    t_last[q] = (q == T - 1 || t_block[q + 1] != t_block[q]) ? 1 : 0;
  }
  if (class_map && g.block_major)
    std::copy(g.class_map.begin(), g.class_map.end(), class_map);
  if (wp_prof())
    fprintf(stderr, "wp_emit: init %.2fs scatter %.2fs meta %.2fs\n",
            te1 - te0, te2 - te1, now_s() - te2);
  // release the big record buffer (keep capacity elsewhere small)
  std::vector<Rec>().swap(g.tmp);
}
