// The rate search's device programs for Hopper (sm_90a): kernels K8s
// (rate_serialize) and K8p (rate_sizes). Both map a row's cached raw
// stream (rate_common.cuh) to its values at a probe's table; K8s writes
// them, K8p sums the bits of their Kagari codes.
//
// K8s replaces ako_tpu/tools/rate.py:_serialize_fn (:82, an XLA program
// over _serialize_raw :55-78: the cached pyramid's quadrants gated and
// divided by a probe's per-(level, channel) q and g, laid out in wire
// order with the q heads) and computes what ops/rate_device.py
// serialize_plain computes: from (rows, n) int16 raw streams the (rows, n)
// int16 streams at a probe's table, which the rate search packs with K3
// (encode_at) or hands to the host coder (a tile near its capacity).
//
// K8p replaces ako_tpu/tools/rate.py:_probe_sizes_fn (:101, an XLA
// program: the probe's _serialize_raw, then kagari_size_device per tile)
// and computes what probe_sizes_plain computes: each row's
// ceil(bits / 8) of the Kagari codes of its values at the probe, one
// int64 a row. Nothing else is written.
//
// Both launch a grid sized to the card (resident CTAs a SM, from the
// occupancy query, times the SMs; asked once a device), over the spans of
// rate_common.cuh: each row cut into equal spans so that the grid takes
// them in one wave; a CTA takes several when the rows outnumber it. Each
// CTA builds the probe's table (a multiplier a segment in place of a
// division) once in shared memory.
//
// K8s: each thread keeps kLoads 16-byte loads in flight, then maps and
// stores them, finding the segment once per 8 values by stepping on from
// its last one. What bounds it: bytes, the streams read once and written
// once (20.98 MB at the north star's 80 x 65560 values: 6.26 us at
// 3.35 TB/s). On an H100 (NVIDIA H100 80GB HBM3, 700 W) it takes 0.0113 ms
// there and 0.0096 ms on the whole-image tile's one row (PR 12's, in the
// same run: 0.0160, 0.0162).
//
// K8p: a CTA streams its span through a ring of kRing stages of kStage
// positions in shared memory, all issued by cp.async up front (stage 0
// first), so one copy's wait is exposed. A thread maps its kItems values as
// it reads them (quantize/gate by the table's multiplier; one entry's
// route, a two-entry route at a segment's start, or any) and codes only
// the positions from its first mismatch on, which its own values and the
// one after them decide; a warp whose values all repeat the one before
// skips the tokenizer. The leading positions before a thread's first
// mismatch continue a run from an earlier mismatch of the span: their
// bits come in closed form (run_bits) once the warps' last mismatches of
// the stage are known, one barrier later. The positions before a span's
// first mismatch depend on other spans: the span publishes a record
// (first and last mismatch, first value, bits) with an acquire-release
// atomic on its row's counter, and the CTA that counts the row's last
// span in (and resets the counter) adds every span's leading run in
// closed form and writes the row's bytes. No CTA waits on another. What
// bounds it: operations, the function's 23 a value (chip_smoke.py
// K8P_OPS: 7.21 us at the card's 32-bit integer rate on the north star's
// 80 x 65560 values), above the bytes (the raw streams read once:
// 10.49 MB, 3.13 us); its own routes take 20.5 SASS instructions a value,
// and 21.6 more where a warp tokenizes. On an H100
// (NVIDIA H100 80GB HBM3, 700 W) it takes 0.0216 ms there and 0.0170 ms
// on the whole-image tile at q 16 (PR 12's, in the same run: 0.0319,
// 0.0317); each row's first span, whose small segments take the slower
// routes, ends last.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rate_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------- grid

// Resident CTAs of `kernel` a SM times the SMs of the current device,
// asked once a device; 0 after an error, which *err then holds.
int grid_ctas(const void* kernel, int* cache, int* err) {
    int dev = 0;
    *err = (int)cudaGetDevice(&dev);
    if (*err) return 0;
    if (dev < 64 && cache[dev]) return cache[dev];
    int per_sm = 0, sms = 0;
    *err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (!*err) *err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err) return 0;
    const int ctas = (per_sm > 0 ? per_sm : 1) * sms;
    if (dev < 64) cache[dev] = ctas;
    return ctas;
}

// ---------------------------------------------------------------- K8s

constexpr int kVec = 8;    // values a 16-byte load
constexpr int kLoads = 4;  // 16-byte loads a thread has in flight
constexpr int kTile = kThreads * kVec * kLoads;

struct SerializeArgs {
    const int16_t* raw;
    int16_t* out;
    SpanCut cut;
    int spans, mis;
    bool vec;  // raw and out share their offset from 16 bytes
};

__global__ void __launch_bounds__(kThreads)
    rate_serialize(const SerializeArgs s, const __grid_constant__ RateArgs r) {
    __shared__ RateTable t;
    load_rate_table(r, t);
    __syncthreads();
    for (int id = blockIdx.x; id < s.spans; id += gridDim.x) {
        const Span sp = span_of(id, s.cut, r.n, s.mis);
        const int16_t* src = s.raw + (long long)sp.row * r.n;
        int16_t* dst = s.out + (long long)sp.row * r.n;
        int e = -1;  // the entry of the thread's last 8 values
        for (int g0 = sp.origin; g0 < sp.end; g0 += kTile) {
            uint4 x[kLoads];
            bool whole[kLoads];
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
                const int p = g0 + kVec * (u * kThreads + (int)threadIdx.x);
                whole[u] = s.vec && p >= sp.begin && p + kVec <= sp.end;
                if (whole[u]) x[u] = *reinterpret_cast<const uint4*>(src + p);
            }
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
                const int p = g0 + kVec * (u * kThreads + (int)threadIdx.x);
                if (p >= sp.end) break;
                const int p0 = max(p, sp.begin);
                if (e < 0)
                    e = rate_entry(t, r.segs, p0);
                else
                    while (p0 >= t.start[e + 1]) ++e;
                if (whole[u] && (p > t.start[e] || !e) && p + kVec <= t.start[e + 1]) {
                    union {
                        uint4 u;
                        int16_t v[kVec];
                    } y;
                    y.u = x[u];
                    const uint32_t mul = t.mul[e];
                    const int gate2 = t.gate2[e];
#pragma unroll
                    for (int j = 0; j < kVec; ++j) y.v[j] = (int16_t)rate_body(y.v[j], mul, gate2);
                    *reinterpret_cast<uint4*>(dst + p) = y.u;
                } else {  // a head, a segment's end, a span's edge or no 16-byte route
                    int ee = e;
                    for (int q = p0; q < min(p + kVec, sp.end); ++q) {
                        while (q >= t.start[ee + 1]) ++ee;
                        dst[q] = (int16_t)rate_value(t, ee, q, src[q]);
                    }
                }
            }
        }
    }
}

int serialize_cache[64];

// ---------------------------------------------------------------- K8p

constexpr int kItems = 16;                  // positions a thread a stage
constexpr int kStage = kThreads * kItems;   // positions a stage
constexpr int kSlot = kStage + 16;          // int16 a ring slot: 8 before the stage, 8 after
constexpr int kRing = 3;
constexpr int kFlush = 65534;               // FLUSH_COUNTER
constexpr int kCross = 5;                   // segment starts kItems + 2 positions cross at most
constexpr long long kMaxN = 1LL << 27;      // 32 bits a position at most: a row's bits fit

struct SizeArgs {
    const int16_t* raw;  // (rows, n) raw streams, n = the table's
    long long* sizes;    // (rows,) payload bytes
    int4* rec;           // per span: first mismatch, last mismatch (-1: none), bits, first value
    unsigned* count;     // per row: spans counted; 0 between calls
    long long total;     // rows * n
    SpanCut cut;
    int spans, mis;
};

// Elias-gamma lengths: of a token u >= 1; of a literal of value v,
// zigzag(v) + 1 mod 2^16, which has the top bit of 2a + 1 with a = |v|
// mod 2^15; and of a token 1 <= u <= 15 (the end tokens inside a thread).
// The last two, the tokenizer's, take floor(log2) from a float's exponent
// (2^23 + m is a float's bits, m exact below 2^23) and from a table in a
// constant: __clz runs on a quarter-rate unit.
__device__ __forceinline__ int gamma_len(unsigned u) { return 2 * (31 - __clz(u)) + 1; }
__device__ __forceinline__ int lit_len(int v) {
    const unsigned m = ((unsigned)abs(v) << 1 & 0xFFFEu) | 0x4B000001u;
    return 2 * (__float_as_int(__uint_as_float(m) - 8388608.0f) >> 23) - 253;
}
__device__ __forceinline__ int small_gamma_len(int u) {
    return u < 8 ? (int)(0x55553310u >> (u << 2) & 15u) : 7;
}

// The bits of positions [a, b] of a run of value v that starts at
// mismatch m < a, with d = p - m and the run counter rc = (d - 1) % kFlush
// + 1: a literal where rc <= 2, a flush token (65533, 31 bits) where rc ==
// kFlush, and, when the run ends at b (`ends`), the end token rc - 1 there
// if rc >= 2 and b is no flush.
__device__ __forceinline__ unsigned run_bits(int m, int a, int b, int v, bool ends) {
    const unsigned d0 = (unsigned)(a - 1 - m), d1 = (unsigned)(b - m);
    const unsigned lits = 2u * (d1 / kFlush) + min(d1 % kFlush, 2u) - 2u * (d0 / kFlush) -
                          min(d0 % kFlush, 2u);
    unsigned bits = lits * (unsigned)lit_len(v) + 31u * (d1 / kFlush - d0 / kFlush);
    const unsigned rc = (d1 - 1) % kFlush + 1;
    if (ends && rc >= 2 && rc != kFlush) bits += (unsigned)gamma_len(rc - 1);
    return bits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(smem)),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage m of span sp into its ring slot: slot index i holds position
// origin + m kStage - 8 + i, in 16-byte copies (a copy that would cross
// the tensor's ends, one value at a time); only the copies that hold a
// position in [first - 1, last + 1] of the stage, inside the row.
__device__ __forceinline__ void issue_stage(const SizeArgs& a, int n, const Span& sp, int m,
                                           int16_t* slot) {
    const int p0 = sp.origin + m * kStage - 8;
    const int lo = max(max(sp.begin, sp.origin + m * kStage) - 1, 0);
    const int hi = min(min(sp.end, sp.origin + (m + 1) * kStage) + 1, n);  // exclusive
    const long long base = (long long)sp.row * n;
    for (int i = threadIdx.x; i < kSlot / 8; i += kThreads) {
        const int p = p0 + 8 * i;
        if (p + 8 <= lo || p >= hi) continue;
        const long long f = base + p;
        if (f >= 0 && f + 8 <= a.total) {
            cp_async16(slot + 8 * i, a.raw + f);
        } else {
            for (int j = 0; j < 8; ++j)
                if (f + j >= 0 && f + j < a.total) slot[8 * i + j] = a.raw[f + j];
        }
    }
}

// What a thread keeps of a stage until the warps' last mismatches are
// known: its leading positions [lead_a, lead_b] (lead_a > lead_b: none),
// their value, whether their run ends at lead_b, its first mismatch (-1:
// none), the last mismatch of the warp's lanes before it (excl) and up to
// it (incl).
struct Pending {
    int lead_a, lead_b, v, fm, excl, incl;
    bool ends;
};

// The leading positions' bits of a stage, with `carry` the span's last
// mismatch before the stage (-1: none) and wl its warps' last mismatches;
// carry moves past the stage. A thread with no mismatch before it in the
// span leaves its leading positions to the row's finisher, and the one
// whose own mismatch is the span's first records it.
__device__ __forceinline__ unsigned finish_stage(const Pending& pd, const int* wl, int& carry,
                                                 int* span_fm) {
    const int warp = threadIdx.x >> 5;
    int before = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before = max(before, wl[w]);
        carry = max(carry, wl[w]);
    }
    const int m = max(before, pd.excl);
    if (m < 0) {
        if (pd.fm >= 0) *span_fm = pd.fm;
        return 0u;
    }
    return pd.lead_a <= pd.lead_b ? run_bits(m, pd.lead_a, pd.lead_b, pd.v, pd.ends) : 0u;
}

// The bits of positions whose run counter is the distance d to the last
// mismatch (d < kItems): a literal of value x at d <= 2, and the end
// token d - 1 at d >= 2 where the next value differs.
__device__ __forceinline__ int item_bits(int x, int d, bool next_differs) {
    const bool end = (unsigned)(d - 2) < 14u && next_differs;
    return ((unsigned)d <= 2u ? lit_len(x) : 0) + (end ? small_gamma_len(d - 1) : 0);
}

// The bits of the thread's positions from its first mismatch on: within
// kItems positions the run counter is the distance to the last mismatch.
// kMasked: only the items below hi count (mm holds the mismatches of the
// items from lo on).
template <bool kMasked>
__device__ __forceinline__ int thread_bits(const int (&v)[kItems + 2], unsigned mm, int hi) {
    int last = -64, bits = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (kMasked ? (mm >> j) & 1u : v[j + 1] != v[j]) last = j;
        const int b = item_bits(v[j + 1], j - last, v[j + 2] != v[j + 1]);
        bits += !kMasked || j < hi ? b : 0;
    }
    return bits;
}

// The thread's part of a stage: its items [lo, hi) (positions first + lo
// .. first + hi - 1 of the span and the stage), its own bits (the positions
// from its first mismatch on, within kItems positions of which the run
// counter is the distance to the last mismatch) added to `own`, and what
// it keeps for finish_stage. At a row's ends the neighbour is made to
// differ, so that position 0 is a mismatch and position n - 1 ends its
// run. Spans are whole kItems groups but at a row's ends (rate_common.cuh),
// so a thread has all kItems items but for a row's first and last groups.
// The 18 values from first - 1 on map with one entry's multiplier where
// they lie in its body with no head, with two where they cross one
// segment's start, else each with its entry from e and the starts it
// passes. Everything is unrolled with no loop whose steps differ between
// lanes, and a warp takes one route for all its lanes: a warp gets about
// an eighth of its scheduler's issue on a busy SM, so extra code on one
// lane holds its CTA's barrier about eight cycles an instruction. Every
// thread of the warp calls it, so that its vote and shuffles run with all
// lanes together.
__device__ __forceinline__ Pending stage_thread(const RateTable& t, int segs, int n, int first,
                                                int lo, int hi, const int16_t* sv, int& e,
                                                unsigned& own) {
    const int lane = threadIdx.x & 31;
    const bool edge = lo != 0 || hi != kItems;
    int v[kItems + 2];
    unsigned mm = 0;
    int lead_v = 0, last_v = 0, after = 0;
    // the route of the 18 values from first - 1 on: 0, in one entry's body
    // with no head; 1, in e's and e + 1's, with their heads; 2, any. The
    // warp takes the costliest any lane needs, once for all its lanes.
    int route = 0;
    if (hi > lo) {
        const int at = min(max(first - 1, 0), n - 1);  // e: the entry of the value before
        while (at >= t.start[e + 1]) ++e;
        route = first > 0 && first - 1 > t.start[e] && first + kItems < t.start[e + 1] ? 0
                : e < segs && first + kItems < t.start[e + 2]                        ? 1
                                                                                     : 2;
    }
    route = __reduce_max_sync(0xFFFFFFFFu, route);
    if (hi > lo) {
        union {
            uint4 u[2];
            int16_t h[kItems];
        } x;
        x.u[0] = reinterpret_cast<const uint4*>(sv)[0];
        x.u[1] = reinterpret_cast<const uint4*>(sv)[1];
        const int before = sv[-1], next = sv[kItems];
        if (route == 0) {
            const uint32_t mul = t.mul[e];
            const int gate2 = t.gate2[e];
            v[0] = rate_body(before, mul, gate2);
#pragma unroll
            for (int j = 0; j < kItems; ++j) v[j + 1] = rate_body(x.h[j], mul, gate2);
            v[kItems + 1] = rate_body(next, mul, gate2);
        } else if (route == 1) {  // value j past k1 in e + 1, heads at k0 and k1
            const int e1 = min(e + 1, segs), k1 = t.start[e + 1] - (first - 1);
            const int k0 = e ? t.start[e] - (first - 1) : -1;
            const uint32_t mul0 = t.mul[e], mul1 = t.mul[e1];
            const int gate0 = t.gate2[e], gate1 = t.gate2[e1];
            const int head0 = t.head[e], head1 = t.head[e1];
#pragma unroll
            for (int j = 0; j < kItems + 2; ++j) {
                const int raw = j == 0 ? before : (j == kItems + 1 ? next : x.h[j - 1]);
                const int y = rate_body(raw, j >= k1 ? mul1 : mul0, j >= k1 ? gate1 : gate0);
                v[j] = j == k1 ? head1 : (j == k0 ? head0 : y);
            }
        } else {  // a head or a segment's end among them, or the row's
            // A segment holds 4 values or more (1 + 3 h w), the LP region
            // 1 or more, so 18 positions cross at most kCross starts past
            // e's: each value's entry is e and a count of them.
            int b[kCross];
#pragma unroll
            for (int k = 0; k < kCross; ++k) b[k] = t.start[min(e + 1 + k, segs + 1)];
#pragma unroll
            for (int j = 0; j < kItems + 2; ++j) {
                const int p = first - 1 + j, pc = min(max(p, 0), n - 1);
                int ee = e;
#pragma unroll
                for (int k = 0; k < kCross; ++k) ee += pc >= b[k] ? 1 : 0;
                const int raw = j == 0 ? before : (j == kItems + 1 ? next : x.h[j - 1]);
                v[j] = p == pc ? rate_value(t, ee, pc, raw) : 0;
            }
        }
        if (first + lo == 0 || first + hi == n) {  // a row's first or last group
#pragma unroll
            for (int j = 0; j < kItems; ++j)
                if (j == lo && first + lo == 0) v[j] = v[j + 1] ^ 1;
#pragma unroll
            for (int j = 1; j <= kItems; ++j)
                if (j == hi && first + hi == n) v[j + 1] = v[j] ^ 1;
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j) mm |= (v[j + 1] != v[j] ? 1u : 0u) << j;
        lead_v = v[1], last_v = v[kItems], after = v[kItems + 1];
        if (edge) {
            mm &= (0xFFFFFFFFu >> (32 - hi + lo)) << lo;
#pragma unroll
            for (int j = 0; j < kItems; ++j) {
                if (j == lo) lead_v = v[j + 1];
                if (j + 1 == hi) last_v = v[j + 1], after = v[j + 2];
            }
        }
    }
    if (__any_sync(0xFFFFFFFFu, mm != 0))  // else every position of the warp repeats
        own += (unsigned)(edge ? thread_bits<true>(v, mm, hi) : thread_bits<false>(v, mm, hi));
    Pending pd;
    pd.fm = mm ? first + __ffs(mm) - 1 : -1;
    pd.lead_a = first + lo;
    pd.lead_b = mm ? pd.fm - 1 : first + hi - 1;
    pd.v = lead_v;
    pd.ends = mm || after != last_v;
    // the warp's last mismatch before this lane and up to it: the last
    // mismatch of the nearest lane below (at or below) that has one
    const int lm = mm ? first + 31 - __clz(mm) : -1;
    const unsigned has = __ballot_sync(0xFFFFFFFFu, mm != 0);
    const unsigned below = has & ((1u << lane) - 1u);
    const int from = below ? 31 - __clz(below) : 0, top = has ? 31 - __clz(has) : 0;
    const int excl = __shfl_sync(0xFFFFFFFFu, lm, from);
    const int incl = __shfl_sync(0xFFFFFFFFu, lm, top);
    pd.excl = below ? excl : -1;
    pd.incl = has ? incl : -1;  // the same in every lane: the warp's
    return pd;
}

// One more span of the row counted in at p: the span's record, stored
// before, released with it, and the records of the spans counted in
// before acquired (__threadfence would be a fence.sc, the costliest).
__device__ __forceinline__ unsigned count_span(unsigned* p) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
    return old;
}

// The sum of x over the CTA, in thread 0's return (every thread calls it).
__device__ __forceinline__ unsigned long long cta_sum(unsigned long long x,
                                                      unsigned long long* tmp) {
#pragma unroll
    for (int off = 16; off; off >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, off);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) tmp[threadIdx.x >> 5] = x;
    __syncthreads();
    unsigned long long s = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < kWarps; ++w) s += tmp[w];
    return s;
}

// The row's finisher: every span's leading run (the positions before its
// first mismatch, which continue the run of the row's last mismatch
// before the span) in closed form, the spans' own bits, and the row's
// bytes. The records come into `buf` (the ring, free by now) kBuf at a
// time, all loads in flight at once; each thread takes a block of
// consecutive records, after the CTA's exclusive max of the blocks' last
// mismatches.
constexpr int kBuf = kRing * kSlot * 2 / 16;  // 16-byte records the ring holds

// A span's leading run in closed form (finish_row's step): the run of the
// row's last mismatch m before the span, from the span's begin to the
// position before its first mismatch or to its end.
__device__ __forceinline__ unsigned span_lead(const SizeArgs& a, int n, int row, int k, int4 x,
                                              int next_fm, int m) {
    const Span sp = span_of(row * a.cut.spr + k, a.cut, n, a.mis);
    if (x.x == sp.begin) return 0u;  // span 0 starts with a mismatch, so m >= 0 past here
    const bool ends = x.x >= 0 || sp.end == n || next_fm == sp.end;
    return run_bits(m, sp.begin, x.x >= 0 ? x.x - 1 : sp.end - 1, x.w, ends);
}

// The finisher of a row of 32 spans or fewer, by warp 0 alone: a span a
// lane, the scan by shuffles, no barrier.
__device__ void finish_row_warp(const SizeArgs& a, int n, int row) {
    const int spr = a.cut.spr, lane = threadIdx.x;
    const int4* rec = a.rec + (long long)row * spr;
    const int4 x = lane < spr ? __ldcg(rec + lane) : make_int4(-1, -1, 0, 0);
    int incl = x.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (lane >= off) incl = max(incl, y);
    }
    const int m = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    const int next_fm = __shfl_down_sync(0xFFFFFFFFu, x.x, 1);
    unsigned bits = 0;
    if (lane < spr)
        bits = (unsigned)x.z + span_lead(a, n, row, lane, x, lane + 1 < spr ? next_fm : -1,
                                         lane ? m : -1);
    unsigned long long total = bits;
#pragma unroll
    for (int off = 16; off; off >>= 1) total += __shfl_down_sync(0xFFFFFFFFu, total, off);
    if (lane == 0) a.sizes[row] = (long long)((total + 7) >> 3);
}

__device__ void finish_row(const SizeArgs& a, int n, int row, int4* buf, unsigned long long* tmp,
                           int* scan) {
    const int spr = a.cut.spr;
    const int4* rec = a.rec + (long long)row * spr;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int carry = -1;
    unsigned long long bits = 0;
    for (int c0 = 0; c0 < spr; c0 += kBuf) {
        const int cn = min(kBuf, spr - c0);
        __syncthreads();  // buf and scan are free
        for (int i = threadIdx.x; i < cn; i += kThreads) buf[i] = __ldcg(rec + c0 + i);
        __syncthreads();
        const int per = (cn + kThreads - 1) / kThreads;
        const int i0 = min(cn, per * (int)threadIdx.x), i1 = min(cn, i0 + per);
        int incl = -1;
        for (int i = i0; i < i1; ++i) incl = max(incl, buf[i].y);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
            if (lane >= off) incl = max(incl, y);
        }
        if (lane == 31) scan[warp] = incl;
        __syncthreads();
        int m = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
        if (lane == 0) m = -1;
        m = max(m, carry);
        for (int w = 0; w < kWarps; ++w) {
            if (w < warp) m = max(m, scan[w]);
            carry = max(carry, scan[w]);
        }
        for (int i = i0; i < i1; ++i) {
            const int4 x = buf[i];
            const int k = c0 + i;
            const int next_fm =
                k + 1 < spr ? (i + 1 < cn ? buf[i + 1].x : __ldcg(&rec[k + 1].x)) : -1;
            bits += (unsigned)x.z + span_lead(a, n, row, k, x, next_fm, m);
            m = max(m, x.y);
        }
    }
    const unsigned long long total = cta_sum(bits, tmp);
    if (threadIdx.x == 0) a.sizes[row] = (long long)((total + 7) >> 3);
}

__global__ void __launch_bounds__(kThreads, 4)
    rate_sizes(const SizeArgs a, const __grid_constant__ RateArgs r) {
    __shared__ RateTable t;
    __shared__ __align__(16) int16_t ring[kRing][kSlot];
    __shared__ int warp_lm[2][kWarps];  // each warp's last mismatch of the last two stages
    __shared__ int scan[kWarps];
    __shared__ unsigned long long tmp[kWarps];
    __shared__ int span_fm, span_v0;
    __shared__ bool row_last;
    const int n = r.n, warp = threadIdx.x >> 5;
    for (int id = blockIdx.x; id < a.spans; id += gridDim.x) {
        const Span sp = span_of(id, a.cut, n, a.mis);
        const int stages = (sp.end - sp.origin + kStage - 1) / kStage;
        // every stage the ring holds at once, a commit group each (empty
        // past the span's stages), then one more a stage; stage 0 first,
        // alone in flight while the first span's CTA builds its table, so
        // that the copies of later stages do not queue before it
        issue_stage(a, n, sp, 0, ring[0]);
        cp_async_commit();
        if (id == (int)blockIdx.x) load_rate_table(r, t);
#pragma unroll
        for (int m = 1; m < kRing; ++m) {
            if (m < stages) issue_stage(a, n, sp, m, ring[m]);
            cp_async_commit();
        }
        if (threadIdx.x == 0) span_fm = -1;
        int e = -1, carry = -1;
        unsigned own = 0;
        Pending pd;
        for (int m = 0; m < stages; ++m) {
            // stage m's group and every one before it are in (a refill is
            // committed from m = 1 on, after the wait)
            if (m == 0)
                cp_async_wait<kRing - 1>();
            else
                cp_async_wait<kRing - 2>();
            __syncthreads();  // ... for every thread, which is done with stage m - 1's slot
            if (m) {
                if (m - 1 + kRing < stages)
                    issue_stage(a, n, sp, m - 1 + kRing, ring[(m - 1) % kRing]);
                cp_async_commit();
            }
            if (m) own += finish_stage(pd, warp_lm[(m - 1) & 1], carry, &span_fm);
            const int s0 = sp.origin + m * kStage;
            const int first = s0 + kItems * (int)threadIdx.x;
            const int lo = max(sp.begin - first, 0);
            const int hi = max(min(min(sp.end, s0 + kStage) - first, kItems), lo);
            if (e < 0) e = rate_entry(t, r.segs, min(max(first - 1, 0), n - 1));
            const int16_t* sv = ring[m % kRing] + 8 + kItems * threadIdx.x;
            pd = stage_thread(t, r.segs, n, first, lo, hi, sv, e, own);
            if (m == 0 && threadIdx.x == 0) span_v0 = pd.v;
            if ((threadIdx.x & 31) == 31) warp_lm[m & 1][warp] = pd.incl;
        }
        cp_async_wait<0>();
        __syncthreads();
        own += finish_stage(pd, warp_lm[(stages - 1) & 1], carry, &span_fm);
        const unsigned long long bits = cta_sum(own, tmp);  // its barriers publish span_fm
        if (threadIdx.x == 0) {
            if (a.cut.spr == 1) {  // the row's one span starts with a mismatch
                a.sizes[sp.row] = (long long)((bits + 7) >> 3);
                row_last = false;
            } else {
                a.rec[id] = make_int4(span_fm, carry, (int)bits, span_v0);
                row_last = count_span(a.count + sp.row) == (unsigned)a.cut.spr - 1;
                if (row_last) a.count[sp.row] = 0u;  // every span is counted in: for the next call
            }
        }
        __syncthreads();
        if (row_last) {
            asm volatile("fence.acq_rel.gpu;" ::: "memory");
            if (a.cut.spr > 32)
                finish_row(a, n, sp.row, reinterpret_cast<int4*>(&ring[0][0]), tmp, scan);
            else if (warp == 0)
                finish_row_warp(a, n, sp.row);
        }
        __syncthreads();  // the shared memory is free for the next span
    }
}

int sizes_cache[64];

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).

// K8s. raw, out: (rows, n) int16, n = args->n; args: the probe's table,
// copied into the launch. One launch on `stream`, no synchronisation.
// Returns the first cudaError_t.
extern "C" int ako_rate_serialize(const int16_t* raw, int16_t* out, int rows, const RateArgs* args,
                                  void* stream) {
    if (rows == 0) return 0;
    const RateArgs& a = *args;
    if (rows < 0 || a.n <= 0 || a.lp <= 0 || a.lp > a.n || a.segs < 0 || a.segs > kRateSegs ||
        (a.segs > 0 && a.start[0] != a.lp))
        return (int)cudaErrorInvalidValue;
    int err = 0;
    const int ctas = grid_ctas((const void*)rate_serialize, serialize_cache, &err);
    if (err) return err;
    SerializeArgs s;
    s.raw = raw;
    s.out = out;
    s.cut = span_cut(rows, a.n, ctas);
    if ((long long)rows * s.cut.spr > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    s.spans = rows * s.cut.spr;
    s.mis = (int)(((uintptr_t)raw >> 1) & 7);
    s.vec = (((uintptr_t)raw ^ (uintptr_t)out) & 15) == 0;
    rate_serialize<<<(unsigned)min(s.spans, ctas), kThreads, 0, (cudaStream_t)stream>>>(s, a);
    return (int)cudaGetLastError();
}

// K8p's grid on the current device (resident CTAs a SM times the SMs):
// the wrapper sizes the scratch for max(rows, *ctas) spans.
extern "C" int ako_rate_sizes_ctas(int* ctas) {
    int err = 0;
    *ctas = grid_ctas((const void*)rate_sizes, sizes_cache, &err);
    return err;
}

// K8p. raw: (rows, n) int16, n = args->n; sizes: (rows,) int64 payload
// bytes. scratch: the caller's, zeroed once and reused, scratch_words
// 64-bit words laid out for up to rows_cap rows and spans_cap spans:
// spans_cap 16-byte span records, then rows_cap 32-bit row counters (zero
// between calls; each call leaves them so). One launch on `stream`, no
// synchronisation. Returns the first cudaError_t.
extern "C" int ako_rate_sizes(const int16_t* raw, long long* sizes, unsigned long long* scratch,
                              long long scratch_words, int rows_cap, int spans_cap, int rows,
                              const RateArgs* args, void* stream) {
    if (rows == 0) return 0;
    const RateArgs& r = *args;
    if (rows < 0 || r.n <= 0 || r.n > kMaxN || r.lp <= 0 || r.lp > r.n || r.segs < 0 ||
        r.segs > kRateSegs || (r.segs > 0 && r.start[0] != r.lp))
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < r.segs; ++k)  // 4 values a segment at least (kCross)
        if ((k + 1 < r.segs ? r.start[k + 1] : r.n) - r.start[k] < 4) return (int)cudaErrorInvalidValue;
    int err = 0;
    const int ctas = grid_ctas((const void*)rate_sizes, sizes_cache, &err);
    if (err) return err;
    SizeArgs a;
    a.cut = span_cut(rows, r.n, ctas);
    const long long spans = (long long)rows * a.cut.spr;
    if (spans > 0x7FFFFFFFLL || rows > rows_cap || spans > spans_cap ||
        2LL * spans_cap + (rows_cap + 1) / 2 > scratch_words)
        return (int)cudaErrorInvalidValue;
    a.raw = raw;
    a.sizes = sizes;
    a.rec = reinterpret_cast<int4*>(scratch);
    a.count = reinterpret_cast<unsigned*>(scratch + 2LL * spans_cap);
    a.total = (long long)rows * r.n;
    a.spans = (int)spans;
    a.mis = (int)(((uintptr_t)raw >> 1) & 7);
    rate_sizes<<<(unsigned)min((long long)ctas, spans), kThreads, 0, (cudaStream_t)stream>>>(a, r);
    return (int)cudaGetLastError();
}
