// One 2-D integer lift level, forward and inverse, for Hopper (sm_90a):
// the per-level API's K1/K2.
//
// Replaces the TPU kernels of ako_tpu/ops/pallas_lift.py:
//   ako_lift2d   <- _lift2d_kernel   (pallas_lift.py:90, driven by lift2d_pallas)
//   ako_unlift2d <- _unlift2d_kernel (pallas_lift.py:184, driven by unlift2d_pallas)
// and computes what ako_tpu/ops/wavelets.py lift2d / unlift2d compute:
// Haar, CDF 5/3 and DD 13/7 lifting with the four wrap modes, C
// truncating division in the bias+shift form of ops/intmath.py, and an
// int16 wrap at every store. Unlike the Pallas kernels these also take
// odd dimensions (the fake last row / column of library/lifting.c:43-76),
// so they take every level of any tile. The split wiring's V-only pair
// (K1v/K2v, _vlift_kernel / _vunlift_kernel) is vlift.cu.
//
// What bounds it: bytes. Each pass reads about 2 B and writes about 2 B
// per coefficient and does a few dozen integer operations on them, far
// below what the SMs can execute per byte of HBM traffic. A level's plane
// does not fit in shared memory in general (the default whole-image
// tile is 1024x1280 int16 = 2.5 MiB per channel, against 227 KB a
// block), so each direction is two launches through an int16 scratch
// in device memory: forward H pass then V pass, inverse V pass then H
// pass. Each thread owns one output index and recomputes the
// neighbouring high-pass (forward) or even (inverse) taps its own
// output needs, so no thread waits on another; neighbouring threads
// take neighbouring columns, so loads and stores coalesce and the
// recomputed taps come from L1. The codec's fused wiring no longer calls
// K1/K2: the levels whose planes do not fit a pyramid block run one
// launch each of lift_level.cu, the rest one launch of lift_pyramid.cu,
// with colour and quantize fused in both. K1/K2 serve the per-level API
// (ops/lift_kernels.py lift2d_level / unlift2d_level, which
// ops/lifting.py forward_tile / inverse_tile take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lift_common.cuh"

namespace {

using namespace ako;

// A stream of int16 samples at p[k * stride].
struct Strided {
    const int16_t* p;
    long long stride;
    __device__ __forceinline__ int operator()(int k) const { return p[k * stride]; }
};

// Odd samples of a stream of length len at p[k * stride]: the fake
// last one (odd len) repeats the last even sample (wavelets.py lift1d,
// library/lifting.c:46-47).
struct OddOf {
    const int16_t* p;
    long long stride;
    int n_real;  // len / 2
    __device__ __forceinline__ int operator()(int k) const {
        return k < n_real ? p[(2 * k + 1) * stride] : p[2 * k * stride];
    }
};

template <class S>
__device__ __forceinline__ int at(const S& s, int i, int d, int n, int wrap) {
    const int k = tap(i, d, n, wrap);
    return k < 0 ? 0 : s(k);
}

// Forward: hp at k from the even/odd streams (int16-wrapped).
template <int WAV, class EV, class OD>
__device__ __forceinline__ int fwd_hp(const EV& ev, const OD& od, int k, int n, int wrap) {
    const int e = ev(k);
    if (WAV == HAAR) return wrap16(od(k) - e);
    const int e1 = at(ev, k, 1, n, wrap);
    if (WAV == CDF53) return wrap16(od(k) - div2(e + e1));
    return wrap16(od(k) + div16(at(ev, k, -1, n, wrap) + at(ev, k, 2, n, wrap) - 9 * (e + e1)));
}

template <int WAV, class EV, class OD>
__device__ __forceinline__ int fwd_hp_at(const EV& ev, const OD& od, int i, int d, int n, int wrap) {
    const int k = tap(i, d, n, wrap);
    return k < 0 ? 0 : fwd_hp<WAV>(ev, od, k, n, wrap);
}

// Forward lift at stream index i: (lp, hp), each int16-wrapped.
template <int WAV, class EV, class OD>
__device__ __forceinline__ void fwd_lift(const EV& ev, const OD& od, int i, int n, int wrap,
                                         int16_t* lp, int16_t* hp) {
    const int h = fwd_hp<WAV>(ev, od, i, n, wrap);
    *hp = (int16_t)h;
    if (WAV == HAAR) {
        *lp = (int16_t)ev(i);
    } else if (WAV == CDF53) {
        *lp = (int16_t)(ev(i) + div4(fwd_hp_at<WAV>(ev, od, i, -1, n, wrap) + h));
    } else {
        const int hl2 = fwd_hp_at<WAV>(ev, od, i, -2, n, wrap);
        const int hl1 = fwd_hp_at<WAV>(ev, od, i, -1, n, wrap);
        const int hp1 = fwd_hp_at<WAV>(ev, od, i, 1, n, wrap);
        *lp = (int16_t)(ev(i) + div32(-hl2 - hp1 + 9 * (hl1 + h)));
    }
}

// Inverse: the even sample at k from the lp/hp streams (int16-wrapped).
template <int WAV, class LP, class HP>
__device__ __forceinline__ int inv_ev(const LP& lp, const HP& hp, int k, int n, int wrap) {
    if (WAV == HAAR) return wrap16(lp(k));
    const int h = hp(k);
    const int hl1 = at(hp, k, -1, n, wrap);
    if (WAV == CDF53) return wrap16(lp(k) - div4(hl1 + h));
    return wrap16(lp(k) - div32(-at(hp, k, -2, n, wrap) - at(hp, k, 1, n, wrap) + 9 * (hl1 + h)));
}

template <int WAV, class LP, class HP>
__device__ __forceinline__ int inv_ev_at(const LP& lp, const HP& hp, int i, int d, int n, int wrap) {
    const int k = tap(i, d, n, wrap);
    return k < 0 ? 0 : inv_ev<WAV>(lp, hp, k, n, wrap);
}

// Inverse lift at stream index i: (even, odd), each int16-wrapped.
template <int WAV, class LP, class HP>
__device__ __forceinline__ void inv_lift(const LP& lp, const HP& hp, int i, int n, int wrap,
                                         int16_t* ev, int16_t* od) {
    const int e = inv_ev<WAV>(lp, hp, i, n, wrap);
    *ev = (int16_t)e;
    if (WAV == HAAR) {
        *od = (int16_t)(lp(i) + hp(i));
    } else if (WAV == CDF53) {
        *od = (int16_t)(hp(i) + div2(e + inv_ev_at<WAV>(lp, hp, i, 1, n, wrap)));
    } else {
        const int el1 = inv_ev_at<WAV>(lp, hp, i, -1, n, wrap);
        const int ep1 = inv_ev_at<WAV>(lp, hp, i, 1, n, wrap);
        const int ep2 = inv_ev_at<WAV>(lp, hp, i, 2, n, wrap);
        *od = (int16_t)(hp(i) - div16(el1 + ep2 - 9 * (e + ep1)));
    }
}

// Forward H pass: x (planes, cur_h, cur_w) -> lp, hp (planes, 2*th, tw).
// Row 2*th-1 is the duplicated last row when cur_h is odd.
template <int WAV>
__global__ void lift_h(const int16_t* __restrict__ x, int16_t* __restrict__ lp,
                       int16_t* __restrict__ hp, long long total, int cur_h, int cur_w,
                       int rows, int tw, int wrap) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = (int)(idx % tw);
    const long long pr = idx / tw;
    const int r = (int)(pr % rows);
    const long long plane = pr / rows;
    const int src_r = min(r, cur_h - 1);
    const int16_t* row = x + (plane * cur_h + src_r) * cur_w;
    fwd_lift<WAV>(Strided{row, 2}, OddOf{row, 1, cur_w / 2}, j, tw, wrap, lp + idx, hp + idx);
}

// Forward V pass: lp, hp (planes, 2*th, tw) -> ll, c (from lp) and
// b, d (from hp), each (planes, th, tw).
template <int WAV>
__global__ void lift_v(const int16_t* __restrict__ lp, const int16_t* __restrict__ hp,
                       int16_t* __restrict__ ll, int16_t* __restrict__ b,
                       int16_t* __restrict__ c, int16_t* __restrict__ d, long long total,
                       int th, int tw, int wrap) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = (int)(idx % tw);
    const long long pr = idx / tw;
    const int i = (int)(pr % th);
    const long long plane = pr / th;
    const long long col = plane * 2 * th * (long long)tw + j;
    const long long s2 = 2LL * tw;
    fwd_lift<WAV>(Strided{lp + col, s2}, Strided{lp + col + tw, s2}, i, th, wrap, ll + idx, c + idx);
    fwd_lift<WAV>(Strided{hp + col, s2}, Strided{hp + col + tw, s2}, i, th, wrap, b + idx, d + idx);
}

// Inverse V pass: ll, b, c, d (planes, th, tw) -> left (from ll, c)
// and right (from b, d), each (planes, 2*th, tw) with rows interleaved.
template <int WAV>
__global__ void unlift_v(const int16_t* __restrict__ ll, const int16_t* __restrict__ b,
                         const int16_t* __restrict__ c, const int16_t* __restrict__ d,
                         int16_t* __restrict__ left, int16_t* __restrict__ right,
                         long long total, int th, int tw, int wrap) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = (int)(idx % tw);
    const long long pr = idx / tw;
    const int i = (int)(pr % th);
    const long long plane = pr / th;
    const long long col = plane * th * (long long)tw + j;
    const long long out = (plane * 2 * th + 2 * i) * (long long)tw + j;
    inv_lift<WAV>(Strided{ll + col, tw}, Strided{c + col, tw}, i, th, wrap, left + out, left + out + tw);
    inv_lift<WAV>(Strided{b + col, tw}, Strided{d + col, tw}, i, th, wrap, right + out, right + out + tw);
}

// Inverse H pass: left, right (planes, 2*th, tw) -> out (planes, cur_h,
// cur_w), dropping the fake last row and column.
template <int WAV>
__global__ void unlift_h(const int16_t* __restrict__ left, const int16_t* __restrict__ right,
                         int16_t* __restrict__ out, long long total, int cur_h, int cur_w,
                         int rows, int tw, int wrap) {
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int j = (int)(idx % tw);
    const long long pr = idx / tw;
    const int r = (int)(pr % cur_h);
    const long long plane = pr / cur_h;
    const long long src = (plane * rows + r) * (long long)tw;
    int16_t ev, od;
    inv_lift<WAV>(Strided{left + src, 1}, Strided{right + src, 1}, j, tw, wrap, &ev, &od);
    int16_t* dst = out + (plane * cur_h + r) * (long long)cur_w + 2 * j;
    dst[0] = ev;
    if (2 * j + 1 < cur_w) dst[1] = od;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long total) {
    return (unsigned)((total + kThreads - 1) / kThreads);
}

template <int WAV>
int lift2d_impl(const int16_t* x, int16_t* lp, int16_t* hp, int16_t* ll, int16_t* b,
                int16_t* c, int16_t* d, long long n, int cur_h, int cur_w, int wrap,
                cudaStream_t s) {
    const int th = (cur_h + 1) / 2, tw = (cur_w + 1) / 2;
    const long long h_total = n * 2 * th * tw, v_total = n * th * tw;
    lift_h<WAV><<<blocks_for(h_total), kThreads, 0, s>>>(x, lp, hp, h_total, cur_h, cur_w, 2 * th, tw, wrap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lift_v<WAV><<<blocks_for(v_total), kThreads, 0, s>>>(lp, hp, ll, b, c, d, v_total, th, tw, wrap);
    return (int)cudaGetLastError();
}

template <int WAV>
int unlift2d_impl(const int16_t* ll, const int16_t* b, const int16_t* c, const int16_t* d,
                  int16_t* left, int16_t* right, int16_t* out, long long n, int cur_h,
                  int cur_w, int wrap, cudaStream_t s) {
    const int th = (cur_h + 1) / 2, tw = (cur_w + 1) / 2;
    const long long v_total = n * th * tw, h_total = n * cur_h * tw;
    unlift_v<WAV><<<blocks_for(v_total), kThreads, 0, s>>>(ll, b, c, d, left, right, v_total, th, tw, wrap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    unlift_h<WAV><<<blocks_for(h_total), kThreads, 0, s>>>(left, right, out, h_total, cur_h, cur_w, 2 * th, tw, wrap);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// Planes are contiguous int16 (n, cur_h, cur_w) and (n, th, tw) with
// th = ceil(cur_h / 2), tw = ceil(cur_w / 2); lp/hp and left/right are
// (n, 2*th, tw) scratch. Returns cudaGetLastError() after the launches
// (0 on success, -1 for an unknown wavelet). Runs on `stream` and does
// not synchronise.
extern "C" int ako_lift2d(const int16_t* x, int16_t* lp, int16_t* hp, int16_t* ll, int16_t* b,
                          int16_t* c, int16_t* d, long long n, int cur_h, int cur_w,
                          int wavelet, int wrap, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (wavelet) {
        case DD137: return lift2d_impl<DD137>(x, lp, hp, ll, b, c, d, n, cur_h, cur_w, wrap, s);
        case CDF53: return lift2d_impl<CDF53>(x, lp, hp, ll, b, c, d, n, cur_h, cur_w, wrap, s);
        case HAAR: return lift2d_impl<HAAR>(x, lp, hp, ll, b, c, d, n, cur_h, cur_w, wrap, s);
        default: return -1;
    }
}

extern "C" int ako_unlift2d(const int16_t* ll, const int16_t* b, const int16_t* c,
                            const int16_t* d, int16_t* left, int16_t* right, int16_t* out,
                            long long n, int cur_h, int cur_w, int wavelet, int wrap,
                            void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (wavelet) {
        case DD137: return unlift2d_impl<DD137>(ll, b, c, d, left, right, out, n, cur_h, cur_w, wrap, s);
        case CDF53: return unlift2d_impl<CDF53>(ll, b, c, d, left, right, out, n, cur_h, cur_w, wrap, s);
        case HAAR: return unlift2d_impl<HAAR>(ll, b, c, d, left, right, out, n, cur_h, cur_w, wrap, s);
        default: return -1;
    }
}
