// The rate search's per-probe quantize/gate of a cached raw stream, and
// the cut of a launch's rows into spans, shared by kernels K8s and K8p
// (rate.cu); ako_tpu/tools/rate.py _serialize_raw (:55-78) computes the
// quantize/gate from the pyramid's quadrants.
//
// The cached stream is a tile's wire-order stream lifted at q = 1, g = 0
// (ops/rate_device.py): the LP planes in [0, lp), then one segment per
// (level, channel), levels smallest first, each [q head][C][B][D]. At a
// probe's table, position p of a row takes
//   in the LP region     its raw value;
//   at a segment's head  int16(q), the probe's q of the segment;
//   elsewhere            |x| <= g ? 0 : x / max(q, 1) (truncating),
// as the lift kernels' fused quantize/gate does (lift_pyramid.cu).

#pragma once

#include <stdint.h>

// (level, channel) segments a row at most: 30 levels (a 2^31-px side) of
// MAX_CHANNELS (16) channels, and a table that stays under the 4 KB of
// kernel parameters
constexpr int kRateSegs = 496;

// A probe's table, passed to the kernel by value (__grid_constant__):
// segment k starts at start[k] (start[0] == lp) and ends where the next
// starts, the last at n; q[k] and g[k] are the probe's int16 values. Out
// of the unnamed namespace, so that the C entry points taking it keep
// their external linkage.
struct RateArgs {
    int n, lp, segs;
    int start[kRateSegs];
    int16_t q[kRateSegs];
    int16_t g[kRateSegs];
};

namespace {

// The table in shared memory, made once a CTA. Entry 0 is the LP region
// (no head, every value kept: a multiplier of 2^31 and no gate), entry
// k + 1 segment k of RateArgs; start[segs + 1] == n.
struct RateTable {
    int start[kRateSegs + 2];
    uint32_t mul[kRateSegs + 1];  // ceil(2^31 / max(q, 1))
    int gate2[kRateSegs + 1];     // 2 g
    int head[kRateSegs + 1];      // int16(q), the value at the head
};

// Fill t from a; every thread of the block calls it, and the caller
// synchronises before reading t.
__device__ __forceinline__ void load_rate_table(const RateArgs& a, RateTable& t) {
    for (int k = threadIdx.x; k <= a.segs; k += blockDim.x) {
        const int q = k ? a.q[k - 1] : 1, qd = q > 1 ? q : 1;
        t.start[k] = k ? a.start[k - 1] : 0;
        t.mul[k] = (0x80000000u + (unsigned)qd - 1u) / (unsigned)qd;
        t.gate2[k] = k ? 2 * a.g[k - 1] : -2;
        t.head[k] = q;
    }
    if (threadIdx.x == 0) t.start[a.segs + 1] = a.n;
}

// The entry of row position p (0 <= p < n): the last k with start[k] <= p.
__device__ __forceinline__ int rate_entry(const RateTable& t, int segs, int p) {
    int lo = 0, hi = segs;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= p)
            lo = mid;
        else
            hi = mid - 1;
    }
    return lo;
}

// The probe's value of raw x (an int16) at a position of entry e that is
// not its head. 2|x| * ceil(2^31 / q) / 2^32 is |x| / q truncated for
// every |x| <= 2^15 and q < 2^15 (the multiplier's excess below q, times
// |x|, stays under 2^31), so no q needs its own route; the result is an
// int16 (-32768 only from x = -32768 at q = 1).
__device__ __forceinline__ int rate_body(int x, uint32_t mul, int gate2) {
    const int a2 = abs(x) << 1;
    const int f = a2 > gate2 ? (int)__umulhi((unsigned)a2, mul) : 0;
    return x < 0 ? -f : f;
}

// The probe's value at row position p of entry e, from its raw value x.
__device__ __forceinline__ int rate_value(const RateTable& t, int e, int p, int x) {
    return e && p == t.start[e] ? t.head[e] : rate_body(x, t.mul[e], t.gate2[e]);
}

// ---------------------------------------------------------------- spans
//
// A launch cuts each row into spr spans from the row's origin o: o = 0
// where the row starts on 16 bytes, else al - 8, al being its first
// position whose address is a multiple of 16 bytes. Span 0 is
// [0, o + len), span k [o + k len, o + (k + 1) len), the last ends at n,
// len a multiple of 16: every span but a row's first starts on 16 bytes,
// a span is whole kItems groups from its origin but at a row's ends (so
// that no thread's group straddles a span's edge), and every span holds
// at least one position. spr is the largest count with spr * rows <= ctas
// (at least 1) that leaves the last span non-empty: the grid takes every
// span in one wave when rows <= ctas.
struct SpanCut {
    int spr, len;
};

__host__ __forceinline__ SpanCut span_cut(int rows, int n, int ctas) {
    const int want = rows < ctas ? ctas / rows : 1;
    const long long len = (((long long)n + want - 1) / want + 15) / 16 * 16;
    const long long spr = n > 7 ? ((long long)n - 7 + len - 1) / len : 1;
    return SpanCut{(int)spr, (int)len};
}

struct Span {
    int row, begin, end;  // positions [begin, end) of the row
    int origin;           // begin, or for a row's first span the row's origin
};

// Span s of a launch over rows of n values at raw + row * n; mis is raw's
// offset in int16 from a 16-byte boundary.
__device__ __forceinline__ Span span_of(int s, SpanCut c, int n, int mis) {
    Span x;
    x.row = s / c.spr;
    const int k = s - x.row * c.spr;
    const int al = (int)((8 - (mis + (long long)x.row * n) % 8) % 8);
    const int o = al ? al - 8 : 0;
    x.begin = k ? o + k * c.len : 0;
    x.end = k == c.spr - 1 ? n : o + (k + 1) * c.len;
    x.origin = k ? x.begin : o;
    return x;
}

}  // namespace
