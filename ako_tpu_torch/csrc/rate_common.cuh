// The rate search's per-probe quantize/gate of a cached raw stream, shared
// by kernels K8s (rate.cu, rate_serialize) and K8p (kagari_encode.cu,
// rate_sizes); ako_tpu/tools/rate.py _serialize_raw (:55-78) computes it
// from the pyramid's quadrants.
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

#include "lift_common.cuh"

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

// The table in shared memory, with each segment's divider made once.
struct RateTable {
    int start[kRateSegs + 1];  // start[segs] == n
    int q[kRateSegs];
    int g[kRateSegs];
    ako::Divider div[kRateSegs];
};

// Fill t from a; every thread of the block calls it, and the caller
// synchronises before reading t.
__device__ __forceinline__ void load_rate_table(const RateArgs& a, RateTable& t) {
    for (int k = threadIdx.x; k < a.segs; k += blockDim.x) {
        t.start[k] = a.start[k];
        t.q[k] = a.q[k];
        t.g[k] = a.g[k];
        t.div[k] = ako::Divider(max((int)a.q[k], 1));
    }
    if (threadIdx.x == 0) t.start[a.segs] = a.n;
}

// The segment of row position p: -1 in the LP region, else the last k
// with start[k] <= p.
__device__ __forceinline__ int rate_segment(const RateTable& t, int lp, int segs, int p) {
    if (p < lp) return -1;
    int lo = 0, hi = segs - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= p)
            lo = mid;
        else
            hi = mid - 1;
    }
    return lo;
}

// The segment of position p + 1, from k, p's own (segments are at least
// four values long, so one step at most; no wrap past the row's end).
__device__ __forceinline__ int rate_next_segment(const RateTable& t, int segs, int k, int p) {
    return k + 1 < segs && p + 1 >= t.start[k + 1] ? k + 1 : k;
}

// The probe's value at row position p of segment k, from its raw value x.
__device__ __forceinline__ int rate_value(const RateTable& t, int k, int p, int x) {
    if (k < 0) return x;
    if (p == t.start[k]) return t.q[k];
    const int g = t.g[k];
    return (x < -g || x > g) ? ako::wrap16(t.div[k](x)) : 0;
}

}  // namespace
