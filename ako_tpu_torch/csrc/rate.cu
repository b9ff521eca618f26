// The rate search's serialization for Hopper (sm_90a): kernel K8s.
//
// Replaces ako_tpu/tools/rate.py:_serialize_fn (:82, an XLA program over
// _serialize_raw :55-78: the cached pyramid's quadrants gated and divided
// by a probe's per-(level, channel) q and g, laid out in wire order with
// the q heads) and computes what ops/rate_device.py serialize_plain
// computes: from (rows, n) int16 raw streams, cached once per colour
// variant (rate_common.cuh), the (rows, n) int16 streams at a probe's
// table, which the rate search packs with K3 (encode_at) or hands to the
// host coder (a tile near its capacity).
//
// Design: one elementwise pass over the flattened (rows, n) values, eight
// consecutive values a thread, 16 bytes loaded and stored at once where
// both tensors fall on 16 bytes. A thread finds its first value's segment
// by binary search over the table in shared memory and steps on from
// there. What bounds it: bytes, the streams read once and written once
// (20.98 MB at the north star's 80 x 65560 values: 6.26 us at 3.35 TB/s).
// On an H100 (700 W) it takes about 0.016 ms there: each of its 2561
// short-lived blocks first builds the table in shared memory (a 64-bit
// division a segment for its divider) before its one load and store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rate_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // values a thread

__global__ void __launch_bounds__(kThreads)
    rate_serialize(const int16_t* __restrict__ raw, int16_t* __restrict__ out, long long total,
                   bool vec, const __grid_constant__ RateArgs a) {
    __shared__ RateTable t;
    load_rate_table(a, t);
    __syncthreads();
    const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
    if (i0 >= total) return;
    const int count = (int)min((long long)kVec, total - i0);
    union {
        uint4 u;
        int16_t v[kVec];
    } x;
    int16_t* v = x.v;
    if (vec && count == kVec) {
        x.u = *reinterpret_cast<const uint4*>(raw + i0);
    } else {
        for (int j = 0; j < count; ++j) v[j] = raw[i0 + j];
    }
    int p = (int)(i0 % a.n);
    int k = rate_segment(t, a.lp, a.segs, p);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
        if (j < count) v[j] = (int16_t)rate_value(t, k, p, v[j]);
        if (++p == a.n) {  // the next row, from its LP region
            p = 0;
            k = -1;
        } else {
            k = rate_next_segment(t, a.segs, k, p - 1);
        }
    }
    if (vec && count == kVec) {
        *reinterpret_cast<uint4*>(out + i0) = x.u;
    } else {
        for (int j = 0; j < count; ++j) out[i0 + j] = v[j];
    }
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// raw, out: (rows, n) int16, n = args->n; args: the probe's table, copied
// into the launch. One launch on `stream`, no synchronisation. Returns the
// first cudaError_t.
extern "C" int ako_rate_serialize(const int16_t* raw, int16_t* out, int rows, const RateArgs* args,
                                  void* stream) {
    if (rows == 0) return 0;
    const RateArgs& a = *args;
    if (rows < 0 || a.n <= 0 || a.lp <= 0 || a.lp > a.n || a.segs < 0 || a.segs > kRateSegs ||
        (a.segs > 0 && a.start[0] != a.lp))
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)rows * a.n;
    const long long blocks = (total + (long long)kThreads * kVec - 1) / ((long long)kThreads * kVec);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const bool vec = (((uintptr_t)raw | (uintptr_t)out) & 15) == 0;
    rate_serialize<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(raw, out, total, vec, a);
    return (int)cudaGetLastError();
}
