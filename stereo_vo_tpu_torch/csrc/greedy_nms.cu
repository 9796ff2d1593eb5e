// Greedy min-distance suppression over a sorted candidate pool, and
// detection's cap and pack after it, in one launch per call, for Hopper
// (sm_90a).
//
// Replaces the XLA while_loop of stereo_vo_tpu/ops/shi_tomasi.py:221 (the
// parallel greedy fixpoint of detect_corners, rounds at :208-219) and the
// cap and pack after it (:223-235). Neither has a Pallas counterpart: on the
// TPU the loop is plain XLA, one [C, C] mat-vec per round under
// lax.while_loop, and the pack a cumsum, a stable argsort and gathers. The
// plain versions are stereo_vo_tpu_torch/ops/shi_tomasi.py::greedy_nms_ref
// (the loop with one host read per round) and ::greedy_nms_pack_ref (that,
// then the pack as torch ops).
//
// Contract, for any C >= 1 candidates sorted by descending response:
//  conflict(j, i) = j < i && valid[j] && valid[i] && d2(j, i) < r2, with
//    d2 = (x_j - x_i)^2 + (y_j - y_i)^2 rounded as the plain version rounds
//    it (__fsub_rn, two __fmul_rn, one __fadd_rn);
//  from accepted = killed = {} repeat, while some valid candidate is neither:
//    pending = valid & ~accepted & ~killed,
//    blocked[i] = any pending j with conflict(j, i),
//    by_acc[i]  = any accepted j with conflict(j, i),
//    killed   |= pending & by_acc,
//    accepted |= pending & ~by_acc & ~blocked;
//  then either write accepted, or cap it at the first k accepted and write
//  the min(C, k) rows of (xy, response, valid): the capped accepted
//  candidates in index order, then the others in index order with response
//  -1 and valid false. Every round runs on the plain version's sets, so the
//  result is bitwise its.
//
// What bounds it on this card: neither bytes nor operations. On frame 0's
// pool (1024 candidates, 909 valid) it reads 13 B per candidate and writes
// 13 per output row (17 KB, 5 ns at 3.35 TB/s) and finds 2,174 conflicting
// pairs (11 K f32 operations, under 1 ns). One block's chain of dependent
// phases sets the time: about 20 block barriers, the first loads of the
// inputs, and per round a warp walking its longest list. chip_smoke.py 3d,
// NVIDIA H100 80GB HBM3, 700 W: 12.4 us of device time there, in SM cycles
// bounding box and grid 3.4 K, counting sort 2.9 K, pair tests 5.6 K, bit
// rows and first round 0.8 K, the other 5 rounds 8.1 K (1.6 K each), cap,
// pack and these counts 3.0 K; 3.9 us with no valid candidate. The design
// before this one (thread i testing every earlier candidate, C^2 / 2 tests
// on one block, the last thread 1023 in a row) took 84.37 us there.
//
// What the design does about it:
//  - Sparse conflict build. A block-wide min / max gives the valid finite
//    candidates' bounding box; the cell side s is the smallest power of two
//    with fl(s * s) >= r2, doubled while the grid needs more than kMaxCells
//    cells (cells only grow: more tests, never a lost conflict). A
//    candidate's cell is floor(fl(v / s)) per axis, a monotone function
//    whose steps lie s or more apart, so two candidates two cells apart on
//    an axis differ there by s or more, the rounded difference too, and
//    their rounded d2 is >= fl(s * s) >= r2: a 3 x 3 cell neighbourhood
//    holds every conflict, and a pair inside it gets exactly the plain
//    version's test. A non-finite coordinate conflicts with nothing (NaN or
//    inf in d2) and gets no cell. A counting sort (an atomic histogram, a
//    block scan of the cells, a scatter) puts the candidates in cell order,
//    where each row of a neighbourhood is one contiguous run.
//  - Each pair tested once: a thread per entry in cell order tests the rest
//    of its cell and the cell to its right (one run) and the three cells of
//    the next row (another), half the neighbourhood, and neighbouring
//    threads test neighbouring cells.
//  - Conflict storage sized by the conflicts the input has. A conflict goes
//    to the later candidate's list: 16-bit slots in shared memory (up to
//    kMaxSlots a candidate, as many as fit), stored slot-major so a warp's
//    lanes read neighbouring words. A candidate whose list outgrows its
//    slots gets a bit row of its earlier conflicts in the wrapper's scratch
//    (C x ceil(C / 32) words) from a rescan of its 3 x 3 cells; only the
//    words between its first and last conflict are read. A real pool needs
//    a few slots a candidate, a dense one (all C at one pixel) C^2 / 2 bits.
//  - Rounds as the plain version's, with no cap (a chain can need C). The
//    first is folded into the build: a valid candidate with no earlier
//    conflict is accepted, the others pending. Then a warp owns each word
//    of 32 candidates; its pending lanes OR the (pending, accepted) bits of
//    their conflicts, ballots give the new bits, and the owner writes them
//    to the other of two state copies, so a round is one barrier
//    (__syncthreads_or, which also decides the next).
//  - No cap on C: one block of 1024 threads, each owning candidates tid,
//    tid + 1024, ...; the plan, made on the host, keeps the bit sets, the
//    per-candidate arrays and the slots in shared memory while they fit (all
//    of them up to about C = 4096, where the kernel addresses them as
//    shared) and moves the rest to the scratch. One block, not a cluster: a
//    round on a real pool is a few list entries a lane, and a cluster would
//    add its barrier to every round.
//  - The cap and pack: a block scan of the accepted bits' popcounts gives
//    each candidate its rank among the accepted and so its output row; the
//    fixpoint's result never leaves the block before it is packed, and one
//    launch replaces detection's 18 small torch launches after it.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// cells of the binning grid at most (the cell side doubles until it fits)
constexpr int kMaxCells = 4096;
// dynamic shared memory: the block's 232,448 bytes less 1 KiB for the
// static scratch of the reductions below
constexpr size_t kDynSmem = 232448 - 1024;
// bit sets of ceil(C / 32) words: valid, killed, bit-row candidates, the
// accepted-count prefix, and each word's (pending, accepted) bits twice (a
// round reads one set and writes the other)
constexpr int kBitSets = 8;
// per-candidate 4-byte words: the cell-ordered entries (x, y, index, cell)
// and each candidate's conflict count (a bit row's word range once it has
// one) and rank within its cell
constexpr int kCandArrays = 6;
// list slots a candidate may have at most (16-bit indices, C <= 65536)
constexpr int kMaxSlots = 64;
constexpr int kMaxSlotC = 65536;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Where each array lives: offsets into dynamic shared memory or into the
// global scratch, made on the host (it sizes the scratch) and passed to the
// kernel.
struct Plan {
    int words;
    size_t cells;               // shared: kMaxCells + 1 cell starts
    bool bits_shared;
    size_t bits;                // kBitSets * words words
    bool cand_shared;
    size_t cand;                // kCandArrays * C words: entries, then ranges
    size_t slots;               // shared: slot_n * C 16-bit earlier-conflict entries
    int slot_n;                 // list slots a candidate has (0: bit rows only)
    size_t rows;                // global: C * words words of earlier-conflict bits
    size_t scratch_bytes;
};

inline Plan make_plan(int c) {
    Plan p;
    p.words = (c + 31) / 32;
    size_t s = 0;
    size_t g = 0;
    p.rows = g;
    g = align16(g + static_cast<size_t>(c) * p.words * 4);
    p.cells = s;
    s = align16(s + (kMaxCells + 1) * 4);
    const size_t bits = static_cast<size_t>(kBitSets) * p.words * 4;
    p.bits_shared = s + bits <= kDynSmem;
    if (p.bits_shared) {
        p.bits = s;
        s = align16(s + bits);
    } else {
        p.bits = g;
        g = align16(g + bits);
    }
    const size_t cand = static_cast<size_t>(kCandArrays) * c * 4;
    p.cand_shared = s + cand <= kDynSmem;
    if (p.cand_shared) {
        p.cand = s;
        s = align16(s + cand);
    } else {
        p.cand = g;
        g = align16(g + cand);
    }
    p.slots = s;
    const size_t left = s < kDynSmem ? kDynSmem - s : 0;
    const size_t fit = left / (2 * static_cast<size_t>(c));
    p.slot_n = c > kMaxSlotC ? 0 : static_cast<int>(fit < kMaxSlots ? fit : kMaxSlots);
    p.scratch_bytes = g;
    return p;
}

// An int that orders as the float does (for all but NaN), so a warp
// reduces floats with one redux instruction; key_value inverts it.
__device__ __forceinline__ int order_key(float v) {
    const int b = __float_as_int(v);
    return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// false for NaN and +-inf
__device__ __forceinline__ bool finite_f(float v) { return fabsf(v) < INFINITY; }

__device__ __forceinline__ float cell_of(float v, float inv) {
    return floorf(__fmul_rn(v, inv));
}

__device__ __forceinline__ bool bit(const unsigned* set, int i) {
    return (set[i >> 5] >> (i & 31)) & 1u;
}

// A binned candidate in cell order: one 16-byte load. cell = cy << 16 | cx.
struct __align__(16) Entry {
    float x, y;
    int j, cell;
};

// Exclusive scan of one value per thread in thread order, and the block's
// total; every thread must call it (three barriers).
__device__ long long block_exclusive_scan(long long v, long long* warp_sums, long long* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    long long x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) {
            x += y;
        }
    }
    if (lane == 31) {
        warp_sums[warp] = x;
    }
    __syncthreads();
    if (warp == 0) {
        long long s = lane < kWarps ? warp_sums[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(kFull, s, d);
            if (lane >= d) {
                s += y;
            }
        }
        if (lane < kWarps) {
            warp_sums[lane] = s;
        }
    }
    __syncthreads();
    const long long before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    *total = warp_sums[kWarps - 1];
    __syncthreads();
    return before;
}

// The binning grid, as one thread chose it.
struct Grid {
    float inv;                  // 1 / cell side (a power of two)
    float x0, y0;               // the cells of the bounding box's low corner
    int gx, gy;
    int on;                     // 0: no conflict is possible, nothing binned
};

// The cell of candidate i, or false where it has none (invalid or a
// non-finite coordinate).
__device__ __forceinline__ bool cell_at(const Grid& g, float x, float y, bool valid,
                                        int* cx, int* cy) {
    if (!(g.on && valid && finite_f(x) && finite_f(y))) {
        return false;
    }
    *cx = static_cast<int>(__fsub_rn(cell_of(x, g.inv), g.x0));
    *cy = static_cast<int>(__fsub_rn(cell_of(y, g.inv), g.y0));
    return true;
}

// The pair test, as the plain version rounds it (fl(a - b) = -fl(b - a),
// so either order gives the same d2).
__device__ __forceinline__ bool near(const Entry& a, float x, float y, float r2) {
    const float dx = __fsub_rn(a.x, x);
    const float dy = __fsub_rn(a.y, y);
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < r2;
}

// f(q.j) for every entry q of [e, end) with near(q, x, y).
template <typename F>
__device__ __forceinline__ void scan_run(const Entry* ent, int e, int end, float x, float y,
                                         float r2, F&& f) {
    for (; e < end; ++e) {
        const Entry v = ent[e];
        if (near(v, x, y, r2)) {
            f(v.j);
        }
    }
}

// f(j) for every earlier candidate j in the 3 x 3 cells around (cx, cy)
// that conflicts with candidate i at (x, y).
template <typename F>
__device__ __forceinline__ void for_conflicts(const Grid& g, const int* start, const Entry* ent,
                                              int i, float x, float y, int cx, int cy, float r2,
                                              F&& f) {
    const int x_lo = max(cx - 1, 0);
    const int x_hi = min(cx + 1, g.gx - 1);
    const int y_hi = min(cy + 1, g.gy - 1);
    for (int ny = max(cy - 1, 0); ny <= y_hi; ++ny) {
        scan_run(ent, start[ny * g.gx + x_lo], start[ny * g.gx + x_hi + 1], x, y, r2,
                 [&](int j) {
                     if (j < i) {
                         f(j);
                     }
                 });
    }
}

// kShared: the plan keeps every array in shared memory (C up to about
// 4096), so the compiler addresses them as shared and not generically.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
greedy_nms_kernel(const float* __restrict__ cxy, const unsigned char* __restrict__ cvalid,
                  const float* __restrict__ cvals, unsigned char* accepted_out,
                  float* xy_out, float* resp_out, unsigned char* valid_out,
                  int c, int k, float r2, const Plan p, unsigned char* scratch,
                  long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red[4][kWarps];
    __shared__ long long warp_sums[kWarps];
    __shared__ Grid grid;
    __shared__ unsigned long long pair_count;
    __shared__ unsigned long long row_count;

    const long long t0 = clock64();
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int w = p.words;
    const int slot_n = p.slot_n;
    unsigned* const valid_bits = reinterpret_cast<unsigned*>(
        kShared ? smem + p.bits : (p.bits_shared ? smem : scratch) + p.bits);
    unsigned* const kill_bits = valid_bits + w;
    unsigned* const row_bits = kill_bits + w;
    unsigned* const acc_prefix = row_bits + w;
    // each word's (pending, accepted) bits, twice: a round reads one set
    uint2* const state0 = reinterpret_cast<uint2*>(acc_prefix + w);
    uint2* const state1 = state0 + w;
    int* const start = reinterpret_cast<int*>(smem + p.cells);
    Entry* const ent = reinterpret_cast<Entry*>(
        kShared ? smem + p.cand : (p.cand_shared ? smem : scratch) + p.cand);
    // .x: the candidate's earlier conflicts (its bit row's first word once
    // it has one), .y: its rank within its cell (its bit row's end word)
    int2* const count = reinterpret_cast<int2*>(ent + c);
    unsigned short* const slots = reinterpret_cast<unsigned short*>(smem + p.slots);
    unsigned* const rows = reinterpret_cast<unsigned*>(scratch + p.rows);

    // ---- the valid bits, the counts zeroed, and the valid finite
    // candidates' bounding box
    for (int q = tid; q <= kMaxCells; q += kThreads) {
        start[q] = 0;
    }
    if (tid == 0) {
        pair_count = 0ull;
        row_count = 0ull;
    }
    float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
    for (int base = warp * 32; base < c; base += kThreads) {
        const int i = base + lane;
        bool v = false;
        if (i < c) {
            v = cvalid[i] != 0;
            const float x = cxy[2 * i];
            const float y = cxy[2 * i + 1];
            if (v && finite_f(x) && finite_f(y)) {
                x0 = fminf(x0, x);
                x1 = fmaxf(x1, x);
                y0 = fminf(y0, y);
                y1 = fmaxf(y1, y);
            }
            count[i] = make_int2(0, 0);
        }
        const unsigned vb = __ballot_sync(kFull, v);
        if (lane == 0) {
            const int q = base >> 5;
            valid_bits[q] = vb;
            kill_bits[q] = 0u;
        }
    }
    int kx0 = __reduce_min_sync(kFull, order_key(x0));
    int kx1 = __reduce_max_sync(kFull, order_key(x1));
    int ky0 = __reduce_min_sync(kFull, order_key(y0));
    int ky1 = __reduce_max_sync(kFull, order_key(y1));
    // the cell side depends on r2 alone: one thread finds it while the box
    // reduces (0: no pair conflicts under r2 <= 0 or NaN)
    float side = 0.0f;
    if (tid == 0 && r2 > 0.0f) {
        side = 1.0f;
        while (__fmul_rn(side, side) < r2) {
            side = __fmul_rn(side, 2.0f);
        }
        for (;;) {
            const float h = __fmul_rn(side, 0.5f);
            if (h > 0.0f && __fmul_rn(h, h) >= r2) {
                side = h;
            } else {
                break;
            }
        }
    }
    if (lane == 0) {
        red[0][warp] = kx0;
        red[1][warp] = kx1;
        red[2][warp] = ky0;
        red[3][warp] = ky1;
    }
    __syncthreads();

    // ---- the grid: warp 0 folds the box, one thread sizes the cells
    if (warp == 0) {
        const bool in = lane < kWarps;
        kx0 = __reduce_min_sync(kFull, in ? red[0][lane] : INT_MAX);
        kx1 = __reduce_max_sync(kFull, in ? red[1][lane] : INT_MIN);
        ky0 = __reduce_min_sync(kFull, in ? red[2][lane] : INT_MAX);
        ky1 = __reduce_max_sync(kFull, in ? red[3][lane] : INT_MIN);
        x0 = key_value(kx0);
        x1 = key_value(kx1);
        y0 = key_value(ky0);
        y1 = key_value(ky1);
    }
    if (tid == 0) {
        Grid g;
        g.on = 0;
        g.inv = 1.0f;
        g.x0 = g.y0 = 0.0f;
        g.gx = g.gy = 1;
        // none without a valid finite candidate either
        if (side > 0.0f && x0 <= x1) {
            float s = side;
            float inv = 1.0f / s;   // exact: s is a power of two
            float gxf, gyf, cx0, cy0;
            for (;;) {
                cx0 = cell_of(x0, inv);
                cy0 = cell_of(y0, inv);
                gxf = __fadd_rn(__fsub_rn(cell_of(x1, inv), cx0), 1.0f);
                gyf = __fadd_rn(__fsub_rn(cell_of(y1, inv), cy0), 1.0f);
                if (__fmul_rn(gxf, gyf) <= static_cast<float>(kMaxCells)) {
                    break;
                }
                s = __fmul_rn(s, 2.0f);
                inv = __fmul_rn(inv, 0.5f);
            }
            g.on = 1;
            g.inv = inv;
            g.x0 = cx0;
            g.y0 = cy0;
            g.gx = static_cast<int>(gxf);
            g.gy = static_cast<int>(gyf);
            if (stats != nullptr) {
                stats[4] = static_cast<long long>(__float_as_int(s));
            }
        }
        grid = g;
    }
    __syncthreads();
    const long long t1 = clock64();
    const Grid g = grid;
    const int ncell = g.gx * g.gy;

    // ---- counting sort by cell: histogram (each candidate's rank within
    // its cell kept in count[i].y), exclusive scan, scatter
    int binned = 0;
    if (g.on) {
        for (int i = tid; i < c; i += kThreads) {
            int cx, cy;
            if (cell_at(g, cxy[2 * i], cxy[2 * i + 1], bit(valid_bits, i), &cx, &cy)) {
                count[i].y = atomicAdd(&start[cy * g.gx + cx], 1);
            }
        }
        __syncthreads();
        long long carry = 0;
        for (int base = 0; base < ncell; base += kThreads) {
            const int q = base + tid;
            long long total;
            const long long before = block_exclusive_scan(q < ncell ? start[q] : 0, warp_sums,
                                                          &total);
            if (q < ncell) {
                start[q] = static_cast<int>(carry + before);
            }
            carry += total;
        }
        binned = static_cast<int>(carry);
        if (tid == 0) {
            start[ncell] = binned;
        }
        __syncthreads();
        for (int i = tid; i < c; i += kThreads) {
            const float x = cxy[2 * i];
            const float y = cxy[2 * i + 1];
            int cx, cy;
            if (cell_at(g, x, y, bit(valid_bits, i), &cx, &cy)) {
                Entry v;
                v.x = x;
                v.y = y;
                v.j = i;
                v.cell = (cy << 16) | cx;
                ent[start[cy * g.gx + cx] + count[i].y] = v;
            }
        }
        __syncthreads();
    }
    const long long t2 = clock64();

    // ---- every pair of binned entries within a cell of each other, tested
    // once: from entry e, the later entries of its cell and of the cell to
    // its right (one run), and the three cells of the next row (another).
    // A conflict goes to the later candidate's list, in its slots while
    // they last
    for (int e = tid; e < binned; e += kThreads) {
        const Entry me = ent[e];
        const int cx = me.cell & 0xffff;
        const int cy = me.cell >> 16;
        const auto add = [&](int j) {
            const int hi = max(j, me.j);
            const int lo = min(j, me.j);
            const int n = atomicAdd(&count[hi].x, 1);
            if (n < slot_n) {
                slots[static_cast<size_t>(n) * c + hi] = static_cast<unsigned short>(lo);
            }
        };
        scan_run(ent, e + 1, start[cy * g.gx + min(cx + 1, g.gx - 1) + 1], me.x, me.y, r2, add);
        if (cy + 1 < g.gy) {
            const int row = (cy + 1) * g.gx;
            scan_run(ent, start[row + max(cx - 1, 0)], start[row + min(cx + 1, g.gx - 1) + 1],
                     me.x, me.y, r2, add);
        }
    }
    __syncthreads();
    const long long t3 = clock64();

    // ---- bit rows for the candidates whose conflicts outgrew their slots
    // (rescanned: their earlier conflicts in the 3 x 3 cells), and the state
    // after the first round: accepted, the valid candidates with no earlier
    // conflict; pending, the others; none killed
    unsigned long long pairs = 0ull;
    unsigned long long in_rows = 0ull;
    bool any_pending = false;
    for (int base = warp * 32; base < c; base += kThreads) {
        const int i = base + lane;
        int n = 0;
        bool in_row = false;
        if (i < c) {
            n = count[i].x;
            if (n > slot_n) {
                in_row = true;
                const float x = cxy[2 * i];
                const float y = cxy[2 * i + 1];
                int cx, cy;
                cell_at(g, x, y, true, &cx, &cy);
                unsigned* const row = rows + static_cast<size_t>(i) * w;
                for (int u = 0; u <= (i >> 5); ++u) {
                    row[u] = 0u;
                }
                int lo = INT_MAX;
                int hi = -1;
                for_conflicts(g, start, ent, i, x, y, cx, cy, r2, [&](int j) {
                    atomicOr(&row[j >> 5], 1u << (j & 31));
                    lo = min(lo, j);
                    hi = max(hi, j);
                });
                count[i] = make_int2(lo >> 5, (hi >> 5) + 1);
            }
        }
        pairs += static_cast<unsigned long long>(n);
        in_rows += in_row ? 1ull : 0ull;
        const unsigned vb = valid_bits[base >> 5];
        const unsigned later = __ballot_sync(kFull, n > 0);
        const unsigned rb = __ballot_sync(kFull, in_row);
        if (lane == 0) {
            const int q = base >> 5;
            row_bits[q] = rb;
            state0[q] = make_uint2(vb & later, vb & ~later);
            any_pending = any_pending || (vb & later) != 0u;
        }
    }
    int still = __syncthreads_or(any_pending);
    const long long t4 = clock64();

    // ---- the rounds after the first. Round r reads pending and accepted
    // from one set and the owner warp of each word writes its new bits to
    // the other, so a round needs one barrier
    bool odd = false;
    while (still) {
        const uint2* const state = odd ? state1 : state0;
        uint2* const state_next = odd ? state0 : state1;
        bool more = false;
        for (int q = warp; q < w; q += kWarps) {
            const uint2 sw = state[q];
            unsigned na = 0u;
            unsigned nk = 0u;
            if (sw.x != 0u) {
                const int i = (q << 5) + lane;
                const bool pending = (sw.x >> lane) & 1u;
                // the pending and the accepted bits of the conflicts, or-ed
                unsigned blocked = 0u;
                unsigned by_acc = 0u;
                if (pending) {
                    const int2 rg = count[i];
                    if ((row_bits[q] >> lane) & 1u) {
                        const unsigned* const row = rows + static_cast<size_t>(i) * w;
                        for (int u = rg.x; u < rg.y; ++u) {
                            const unsigned r = __ldcg(row + u);     // set by atomics, in L2
                            const uint2 su = state[u];
                            blocked |= r & su.x;
                            by_acc |= r & su.y;
                        }
                    } else {
                        const unsigned short* list = slots + i;
                        for (int e = 0; e < rg.x; ++e, list += c) {
                            const int j = *list;
                            const unsigned b = 1u << (j & 31);
                            const uint2 sj = state[j >> 5];
                            blocked |= sj.x & b;
                            by_acc |= sj.y & b;
                        }
                    }
                }
                na = __ballot_sync(kFull, pending && by_acc == 0u && blocked == 0u);
                nk = __ballot_sync(kFull, pending && by_acc != 0u);
            }
            if (lane == 0) {
                const unsigned a = sw.y | na;
                const unsigned kw = kill_bits[q] | nk;   // read by this warp only
                kill_bits[q] = kw;
                const unsigned pn = valid_bits[q] & ~a & ~kw;
                state_next[q] = make_uint2(pn, a);
                more = more || pn != 0u;
            }
        }
        still = __syncthreads_or(more);
        odd = !odd;
    }
    const long long t5 = clock64();
    // the accepted bits, in the final state
    const uint2* const final_state = odd ? state1 : state0;

    // ---- the results
    if (accepted_out != nullptr) {
        for (int i = tid; i < c; i += kThreads) {
            accepted_out[i] = (final_state[i >> 5].y >> (i & 31)) & 1u;
        }
    }
    if (xy_out != nullptr && k > 0) {
        long long carry = 0;
        for (int base = 0; base < w; base += kThreads) {
            const int q = base + tid;
            long long total;
            const long long before = block_exclusive_scan(q < w ? __popc(final_state[q].y) : 0,
                                                          warp_sums, &total);
            if (q < w) {
                acc_prefix[q] = static_cast<unsigned>(carry + before);
            }
            carry += total;
        }
        __syncthreads();
        const long long kk = k;
        const long long n_acc = min(carry, kk);
        const long long rows_out = min(static_cast<long long>(c), kk);
        for (int i = tid; i < c; i += kThreads) {
            const unsigned aw = final_state[i >> 5].y;
            const long long rank = acc_prefix[i >> 5] + __popc(aw & ((1u << (i & 31)) - 1u));
            const bool acc = ((aw >> (i & 31)) & 1u) && rank < kk;
            const long long slot = acc ? rank : n_acc + i - min(rank, kk);
            if (slot < rows_out) {
                xy_out[2 * slot] = cxy[2 * i];
                xy_out[2 * slot + 1] = cxy[2 * i + 1];
                resp_out[slot] = acc ? cvals[i] : -1.0f;
                valid_out[slot] = acc ? 1 : 0;
            }
        }
    }
    if (stats != nullptr) {
        for (int d = 16; d > 0; d >>= 1) {
            pairs += __shfl_xor_sync(kFull, pairs, d);
            in_rows += __shfl_xor_sync(kFull, in_rows, d);
        }
        if (lane == 0) {
            atomicAdd(&pair_count, pairs);
            atomicAdd(&row_count, in_rows);
        }
        __syncthreads();
        if (tid == 0) {
            const long long t6 = clock64();
            stats[0] = static_cast<long long>(pair_count);
            stats[1] = static_cast<long long>(row_count);
            stats[2] = g.gx;
            stats[3] = g.gy;
            if (!g.on) {
                stats[4] = 0;
            }
            // SM cycles of each phase, on thread 0's clock after the barriers
            stats[5] = t1 - t0;
            stats[6] = t2 - t1;
            stats[7] = t3 - t2;
            stats[8] = t4 - t3;
            stats[9] = t5 - t4;
            stats[10] = t6 - t5;
        }
    }
}

}  // namespace

namespace {

bool g_smem_set = false;

}  // namespace

// Bytes of global scratch a call over c candidates needs (the bit rows, and
// whatever of the bit sets and per-candidate arrays shared memory cannot hold).
extern "C" long long svo_greedy_nms_scratch_bytes(int c) {
    return c > 0 ? static_cast<long long>(make_plan(c).scratch_bytes) : 0;
}

// cxy [c, 2] f32 (x, y), cvalid [c] bool; accepted [c] bool out, or null;
// with cvals [c] f32 and k > 0, the k-capped pack xy [min(c, k), 2] f32,
// response [min(c, k)] f32, valid [min(c, k)] bool out (else null); scratch
// of svo_greedy_nms_scratch_bytes(c) bytes; stats [11] int64 out or null
// (conflict pairs, bit-row candidates, grid width and height, the cell
// side's f32 bits, then the SM cycles of the bounding box and grid, the
// counting sort, the pair tests, the bit rows and first round, the other
// rounds and the output).
// All contiguous on the current device; c >= 0.
// Launches on `stream` and returns the first CUDA error (0 on success); it
// does not synchronise.
extern "C" int svo_greedy_nms(const float* cxy, const unsigned char* cvalid, const float* cvals,
                              unsigned char* accepted, float* xy, float* response,
                              unsigned char* valid, int c, int k, float r2, void* scratch,
                              long long* stats, void* stream) {
    if (c <= 0) {
        return 0;
    }
    if (!g_smem_set) {
        for (const void* fn : {reinterpret_cast<const void*>(greedy_nms_kernel<true>),
                               reinterpret_cast<const void*>(greedy_nms_kernel<false>)}) {
            const cudaError_t err = cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDynSmem));
            if (err != cudaSuccess) {
                return static_cast<int>(err);
            }
        }
        g_smem_set = true;
    }
    const Plan p = make_plan(c);
    const auto kernel = p.bits_shared && p.cand_shared ? greedy_nms_kernel<true>
                                                       : greedy_nms_kernel<false>;
    kernel<<<1, kThreads, kDynSmem, static_cast<cudaStream_t>(stream)>>>(
        cxy, cvalid, cvals, accepted, xy, response, valid, c, k, r2, p,
        static_cast<unsigned char*>(scratch), stats);
    return static_cast<int>(cudaGetLastError());
}
