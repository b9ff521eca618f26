// The split wiring's V-only lift levels, forward and inverse, along either
// axis of the stored plane, for Hopper (sm_90a).
//
// Replaces the TPU kernels of ako_tpu/ops/pallas_lift.py:
//   vlift   <- _vlift_kernel   (pallas_lift.py:127, called at :139)
//   vunlift <- _vunlift_kernel (pallas_lift.py:211, called at :221)
// and computes what ops/wavelets.py vlift / vunlift compute (one lift1d /
// unlift1d_pair + interleave along one axis): Haar, CDF 5/3 and DD 13/7
// with the four wrap modes, the fake last odd sample of an odd length (the
// last even one, library/lifting.c:46-47), C truncating division and an
// int16 wrap at every store. Along the rows (axis -2, Pallas's own
// contract) or along the columns (axis -1): the split wiring's H pass,
// which the Pallas wiring runs as transpose -> V-lift -> transpose, lifts
// the stored plane along -1 instead, so no transpose runs between a
// level's calls (ops/lift_kernels.py lift2d_level / unlift2d_level).
//
// What bounds it: bytes. A call reads its planes once and writes as many
// samples once, with a few dozen integer operations a sample; the north
// star's levels 2-5 at 128-px tiles are so small that a launch's fixed
// cost sets their time. The first kernels took one thread per output
// pair, each recomputing up to four neighbouring high-pass (or even)
// values through about 20 strided two-byte loads. Measured on the H100
// (PERF.md, K1v/K2v's findings): a CTA lifting a window in shared memory
// one step at a time between barriers, as lift_level.cu does, was
// issue-bound (every warp held lanes at a line's end and ran the edge
// steps beside the inner ones, and each (line, pair) item paid its own
// index arithmetic); a thread lifting a run of pairs from registers
// loaded straight from device memory was bound by its accesses (two
// bytes a lane along -2, a row a lane along -1). Here:
// - A CTA takes up to 8 runs of kRun pairs along the lift axis (a warp
//   each) across 32 lines (a lane each): along -1 32 rows of the (n * h,
//   w) array; along -2 a strip of up to 32 columns of one plane, or a few
//   narrow planes. It loads its tile in the plane's own layout, the runs'
//   samples and 3 or 4 pairs beyond each side, with 16-byte cp.async
//   copies where rows are a multiple of 8 samples, neighbouring threads on
//   neighbouring chunks; elsewhere (odd lengths, the fake odd sample,
//   REPEAT's wrapped window: lift_common.cuh line_sample / line_pair, the
//   rules lift_level.cu's windows follow) one sample at a time, four
//   chunks a thread in flight.
// - Each thread lifts its run of one line from a window of registers read
//   from the tile: the run and 3 pairs each side (DD 13/7's taps). The
//   predict runs on the run and the pairs the update reads (kRun + 3
//   high-pass values, each computed once by the thread), then the update;
//   the inverse undoes the update on kRun + 3 pairs, then the predict. No
//   barrier between the steps. Along -1 a lane reads its row's window as
//   16-byte words, the tile's rows an odd number of 16-byte units apart
//   (no bank conflict); along -2 neighbouring lanes read neighbouring
//   columns.
// - A warp's lanes share one run, so a warp is at a line's end or inside
//   it as one. Inside, every tap is a fixed register. At an end, a thread
//   takes the steps on its run's pairs that lie on the line one at a time,
//   each tap at lift_common.cuh tap()'s pair (the wrap rules; the wrap
//   mode a template parameter, so tap() folds to a few instructions) read
//   by address: the samples from the tile, the high-pass (inverse: even)
//   values from the thread's slots of shared memory. REPEAT is exactly
//   periodic in pair space: its tile is loaded modulo the line's pairs and
//   every run is an inner one.
// - The results go to an output tile, then to device memory in 16-byte
//   coalesced stores where rows are a multiple of 8 samples: lp, hp (the
//   inverse: the samples interleaved, the fake last one dropped).
// - One launch takes one or two calls of one shape (gridDim.y): a level's
//   two V calls along -2 (lp and hp; (ll, c) and (b, d)) share a launch.
// Element offsets into the planes are 64-bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lift_common.cuh"

// Mirrors kernels.VliftArgs (ctypes); all ints, so no padding.
struct VliftArgs {
    int n;        // planes
    int h;        // a plane's rows and columns: the forward's input, the
    int w;        // inverse's output
    int axis;     // 0: the lift runs along axis -2 (a column's h samples);
                  // 1: along axis -1 (a row's w samples)
    int wavelet;  // the level's effective wavelet
    int wrap;
    int groups;   // calls of this shape in the launch, 1 or 2
};

// The device pointers of a launch's calls: forward, group g reads in[g]
// and writes lp, hp to out[2g], out[2g + 1]; inverse, group g reads lp, hp
// from in[2g], in[2g + 1] and writes the plane to out[g].
struct VliftPtrs {
    const int16_t* in[4];
    int16_t* out[4];
};

namespace {

using namespace ako;

constexpr int kRun = 8;         // pairs a thread lifts: a 16-byte chunk of lp (hp)
constexpr int kWin = kRun + 6;  // pairs of its window: the run and 3 on each side
constexpr int kLines = 32;      // lines a CTA: a warp's lanes
constexpr int kMaxRuns = 8;     // runs a CTA: its warps
constexpr int kThreads = kLines * kMaxRuns;
// int16 of shared memory a CTA: the input tile and the output tiles of
// the largest layout (the inverse along -1: two 32 x 88 tiles of lp and
// hp and a 32 x 136 tile of samples)
constexpr int kSmem = 10240;
constexpr int kBatch = 4;  // tile chunks a thread loads at a time

// A thread's run of a line of n pairs: pairs [a, a + kRun), its window
// pairs [a - 3, a + kRun + 3) at register index pair - (a - 3).
struct Run {
    int n, a;
    bool rep;
    // no step is within two pairs of an end (lift_common.cuh tap()), or
    // REPEAT: the forward's predict on pairs a - 2 .. a + kRun, the
    // inverse's undo-update on a - 1 .. a + kRun + 1
    __device__ __forceinline__ bool inner_fwd() const { return rep || (a >= 4 && a + kRun + 3 <= n); }
    __device__ __forceinline__ bool inner_inv() const { return rep || (a >= 3 && a + kRun + 4 <= n); }
};

// The lifting steps at one pair, each tap by a callable: ev(d) the even
// sample of the pair d away, hp(d) its high-pass value. The forward's
// predict gives the high-pass value from the odd sample o; unpredict the
// odd sample from the high-pass value h; update the term the forward adds
// to the even sample and the inverse subtracts (not for Haar).
template <int WAV, class E>
__device__ __forceinline__ int predict(int o, E ev) {
    if (WAV == HAAR) return wrap16(o - ev(0));
    if (WAV == CDF53) return wrap16(o - div2(ev(0) + ev(1)));
    return wrap16(o + div16(ev(-1) + ev(2) - 9 * (ev(0) + ev(1))));
}

template <int WAV, class E>
__device__ __forceinline__ int unpredict(int h, E ev) {
    if (WAV == HAAR) return wrap16(h + ev(0));
    if (WAV == CDF53) return wrap16(h + div2(ev(0) + ev(1)));
    return wrap16(h - div16(ev(-1) + ev(2) - 9 * (ev(0) + ev(1))));
}

template <int WAV, class H>
__device__ __forceinline__ int update(H hp) {
    if (WAV == CDF53) return div4(hp(-1) + hp(0));
    return div32(-hp(-2) - hp(1) + 9 * (hp(-1) + hp(0)));
}

// Forward lift of an inner run (no step within two pairs of a line's
// end): ev, od the window of registers (kWin pairs from a - 3) -> lp, hp
// of pairs a .. a + kRun - 1; every tap a fixed register.
template <int WAV>
__device__ __forceinline__ void lift_run(const int* ev, const int* od, int* lp, int* hp) {
    int h[kRun + 3];  // high-pass values of pairs a - 2 .. a + kRun
#pragma unroll
    for (int j = 0; j < kRun + 3; ++j) {
        const int* e = ev + j + 1;
        h[j] = predict<WAV>(od[j + 1], [&](int d) { return e[d]; });
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int* t = h + j + 2;
        hp[j] = t[0];
        lp[j] = WAV == HAAR ? ev[j + 3] : wrap16(ev[j + 3] + update<WAV>([&](int d) { return t[d]; }));
    }
}

// Inverse lift of an inner run: lo, hi the window's lp, hp (kWin pairs
// from a - 3) -> the even and odd samples of pairs a .. a + kRun - 1.
template <int WAV>
__device__ __forceinline__ void unlift_run(const int* lo, const int* hi, int* ev, int* od) {
    int e[kRun + 3];  // even samples of pairs a - 1 .. a + kRun + 1
#pragma unroll
    for (int j = 0; j < kRun + 3; ++j) {
        const int* t = hi + j + 2;
        e[j] = WAV == HAAR ? lo[j + 2] : wrap16(lo[j + 2] - update<WAV>([&](int d) { return t[d]; }));
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int* t = e + j + 1;
        ev[j] = t[0];
        od[j] = unpredict<WAV>(hi[j + 3], [&](int d) { return t[d]; });
    }
}

// A thread's slots in shared memory for the values of a run at a line's
// end, a warp's lanes side by side (no bank conflict).
struct Scratch {
    int16_t* p;
    __device__ __forceinline__ int16_t& operator[](int j) const { return p[j * kThreads]; }
};

// Forward lift of a run at a line's end (not REPEAT, whose every run is
// inner): the steps on the pairs of the run and its window that lie on
// the line, each tap tap()'s pair (the wrap rules, or zero) read by
// address: pair m's samples from the tile by ev(m), od(m), the high-pass
// values of pairs a - 2 .. a + kRun in s. Each substituted tap lies within
// an inner pair's taps, so on the line and in the window.
template <int WAV, int WRAP, class EV, class OD>
__device__ void lift_edge(EV ev, OD od, int a, int n, Scratch s, int* lp, int* hp) {
#pragma unroll
    for (int j = 0; j < kRun + 3; ++j) {
        const int k = a - 2 + j;
        if (k < 0 || k >= n) continue;
        s[j] = (int16_t)predict<WAV>(od(k), [&](int d) {
            const int m = tap(k, d, n, WRAP);
            return m < 0 ? 0 : ev(m);
        });
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int k = a + j;
        if (k >= n) break;
        hp[j] = s[j + 2];
        lp[j] = WAV == HAAR ? ev(k) : wrap16(ev(k) + update<WAV>([&](int d) {
            const int m = tap(k, d, n, WRAP);
            return m < 0 ? 0 : (int)s[m - a + 2];
        }));
    }
}

// Inverse lift of a run at a line's end: lp, hp of pair m from the tile
// by lo(m), hi(m), the even samples of pairs a - 1 .. a + kRun + 1 in s.
template <int WAV, int WRAP, class LO, class HI>
__device__ void unlift_edge(LO lo, HI hi, int a, int n, Scratch s, int* ev, int* od) {
#pragma unroll
    for (int j = 0; j < kRun + 3; ++j) {
        const int k = a - 1 + j;
        if (k < 0 || k >= n) continue;
        s[j] = (int16_t)(WAV == HAAR ? lo(k) : wrap16(lo(k) - update<WAV>([&](int d) {
            const int m = tap(k, d, n, WRAP);
            return m < 0 ? 0 : hi(m);
        })));
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const int k = a + j;
        if (k >= n) break;
        ev[j] = s[j + 1];
        od[j] = unpredict<WAV>(hi(k), [&](int d) {
            const int m = tap(k, d, n, WRAP);
            return m < 0 ? 0 : (int)s[m - a + 1];
        });
    }
}

__device__ __forceinline__ int lo16(uint32_t v) { return (int)(int16_t)(v & 0xffff); }
__device__ __forceinline__ int hi16(uint32_t v) { return (int)v >> 16; }
__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
    return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// 8 int16 at a 16-byte aligned p -> v[0 .. 8), and back
__device__ __forceinline__ void load8(const int16_t* p, int* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = lo16(u[i]);
        v[2 * i + 1] = hi16(u[i]);
    }
}
__device__ __forceinline__ void store8(int16_t* p, const int* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// i / d for 0 <= i < 2^32 / d: the high word of i * ceil(2^32 / d), whose
// error stays under i / 2^32 < 1 / d; ceil(2^32 / d) is floor((2^32 - 1)
// / d) + 1, a 32-bit division, once a CTA.
struct FastDiv {
    unsigned m;
    __device__ explicit FastDiv(int d) : m(d > 1 ? 0xffffffffu / (unsigned)d + 1u : 0u) {}
    __device__ __forceinline__ int operator()(int i) const {
        return m ? (int)__umulhi((unsigned)i, m) : i;
    }
};

// A chunk of 8 tile slots to load: whole, one 16-byte cp.async of 8
// samples from a 16-byte aligned src; else element e from src[index],
// index from the chunk's `first` by the caller's rule (negative: none, the
// slot is left 0 and never read).
struct Chunk {
    int16_t* dst;
    const int16_t* src;
    int first;
    bool whole;
};

// Loads `items` chunks into the tile, kBatch a thread at a time: the
// one-sample loads of a batch are all in flight before its stores to
// shared memory (one after another they would each wait a trip to device
// memory). chunk(i) describes chunk i, index(c, e) its element e.
template <class C, class I>
__device__ __forceinline__ void fill(int items, C chunk, I index) {
    for (int i0 = threadIdx.x; i0 < items; i0 += kBatch * blockDim.x) {
        int16_t v[kBatch][8];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i >= items) break;
            const Chunk c = chunk(i);
            if (c.whole) {
                cp_async16(c.dst, c.src);
                continue;
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int j = index(c, e);
                v[u][e] = j >= 0 ? c.src[j] : 0;
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i >= items) break;
            const Chunk c = chunk(i);
            if (c.whole) continue;
#pragma unroll
            for (int e = 0; e < 8; ++e) c.dst[e] = v[u][e];
        }
    }
}

// A launch's CTAs, the same on the host and the card. A CTA takes rc runs
// of kRun pairs along the lift axis (its warps) across up to kLines lines
// (a warp's lanes, one line each): along -1 kLines rows of the (n * h, w)
// array; along -2 a strip of up to kLines columns of one plane, or of
// planes narrower than that pp planes a CTA, pc columns apart in its tiles
// (a multiple of 8, so tile rows are whole 16-byte chunks).
struct Geometry {
    int len, n, runs, rc, rblocks;  // the line's samples, pairs, runs; a CTA's runs; run blocks
    int strips, pc, pp;             // axis 0: strips of a plane, tile columns, planes a CTA
    long long lblocks;              // line blocks: of kLines rows, or (axis 0) of planes x strips
    __host__ __device__ explicit Geometry(const VliftArgs& a) {
        len = a.axis ? a.w : a.h;
        n = (len + 1) / 2;
        runs = (n + kRun - 1) / kRun;
        rc = runs < kMaxRuns ? runs : kMaxRuns;
        rblocks = (runs + rc - 1) / rc;
        if (a.axis) {
            strips = pc = pp = 1;
            lblocks = ((long long)a.n * a.h + kLines - 1) / kLines;
        } else {
            strips = (a.w + kLines - 1) / kLines;
            pc = a.w >= kLines ? kLines : (a.w + 7) / 8 * 8;
            pp = kLines / pc;
            lblocks = (long long)((a.n + pp - 1) / pp) * strips;
        }
    }
    __host__ __device__ long long ctas() const { return lblocks * rblocks; }
};

// The CTA's part of the call: its first pair a0 and, along -1, rows
// [l0, l0 + lines); along -2, planes [p0, p0 + planes) and columns
// [c0, c0 + cols) of each.
struct Block {
    int a0, lines, p0, planes, c0, cols;
    long long l0;
    __device__ Block(const VliftArgs& a, const Geometry& g) {
        // 32-bit divisions: a 64-bit one is a call to a long software routine
        const unsigned lb = blockIdx.x / (unsigned)g.rblocks, rb = blockIdx.x - lb * g.rblocks;
        a0 = (int)rb * g.rc * kRun;
        if (a.axis) {
            l0 = (long long)lb * kLines;
            lines = (int)min((long long)kLines, (long long)a.n * a.h - l0);
            p0 = c0 = 0;
            planes = cols = 1;
        } else {
            const unsigned pb = lb / (unsigned)g.strips, strip = lb - pb * g.strips;
            p0 = (int)pb * g.pp;
            planes = min(g.pp, a.n - p0);
            c0 = (int)strip * kLines;
            cols = min(g.pc, a.w - c0);
            l0 = 0;
            lines = 0;
        }
    }
};

template <int WAV, int AXIS, int WRAP>
__global__ void __launch_bounds__(kThreads) vlift(const VliftArgs a, const VliftPtrs ptr) {
    __shared__ __align__(16) int16_t sm[kSmem];
    __shared__ int16_t scratch[(kRun + 3) * kThreads];  // runs at a line's end
    const bool g1 = blockIdx.y;  // selects, not an index: the parameters stay off the stack
    const int16_t* x = g1 ? ptr.in[1] : ptr.in[0];
    int16_t* lp_out = g1 ? ptr.out[2] : ptr.out[0];
    int16_t* hp_out = g1 ? ptr.out[3] : ptr.out[1];
    const Geometry g(a);
    const Block b(a, g);
    const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr bool rep = WRAP == REPEAT;
    const Run r{g.n, b.a0 + kRun * warp, rep};
    int ev[kWin], od[kWin], lp[kRun], hp[kRun];

    if (AXIS) {
        // in: row i of the CTA at sm[i * ps], its sample s at column
        // s - (2 a0 - 8); out: lp, hp of pair a0 + j at column j
        const int ps = 16 * g.rc + 24, nch = 2 * g.rc + 2, po = 8 * (g.rc | 1);
        int16_t* olp = sm + kLines * ps;
        int16_t* ohp = olp + kLines * po;
        const bool vec = ((uintptr_t)x & 15) == 0 && a.w % 8 == 0;
        const FastDiv by_ch(nch);
        fill(b.lines * nch,
             [&](int i) {
                 const int row = by_ch(i), k = i - row * nch, s0 = 2 * b.a0 - 8 + 8 * k;
                 const int16_t* line = x + (b.l0 + row) * a.w;
                 const bool whole = vec && s0 >= 0 && s0 + 8 <= a.w;
                 return Chunk{sm + row * ps + 8 * k, whole ? line + s0 : line, s0, whole};
             },
             [&](const Chunk& c, int e) { return line_sample(c.first + e, a.w, rep); });
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (lane < b.lines && r.a < g.n) {
            if (r.inner_fwd()) {
                // the samples of pairs a - 4 .. a + kRun + 3 (16-byte
                // aligned, rows an odd number of 16-byte units apart: no bank
                // conflict)
                int v[2 * kRun + 16];
#pragma unroll
                for (int c = 0; c < kRun / 4 + 2; ++c) load8(sm + lane * ps + 16 * warp + 8 * c, v + 8 * c);
#pragma unroll
                for (int j = 0; j < kWin; ++j) {
                    ev[j] = v[2 * j + 2];
                    od[j] = v[2 * j + 3];
                }
                lift_run<WAV>(ev, od, lp, hp);
            } else {
                const int16_t* line = sm + lane * ps - (2 * b.a0 - 8);  // sample s at line[s]
                lift_edge<WAV, WRAP>([&](int m) { return (int)line[2 * m]; },
                                     [&](int m) { return (int)line[2 * m + 1]; }, r.a, g.n,
                                     Scratch{scratch + tid}, lp, hp);
            }
            store8(olp + lane * po + kRun * warp, lp);
            store8(ohp + lane * po + kRun * warp, hp);
        }
        __syncthreads();
        const bool ovec = (((uintptr_t)lp_out | (uintptr_t)hp_out) & 15) == 0 && g.n % 8 == 0;
        const FastDiv by_k(g.rc), by_half(b.lines * g.rc);
        for (int i = tid; i < 2 * b.lines * g.rc; i += nt) {
            const int half = by_half(i), j = i - half * b.lines * g.rc, row = by_k(j), k = j - row * g.rc;
            const int p0 = b.a0 + 8 * k;
            if (p0 >= g.n) continue;
            const int16_t* src = (half ? ohp : olp) + row * po + 8 * k;
            int16_t* dst = (half ? hp_out : lp_out) + (b.l0 + row) * g.n + p0;
            if (ovec && p0 + 8 <= g.n) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int e = 0; e < 8 && p0 + e < g.n; ++e) dst[e] = src[e];
            }
        }
    } else {
        // in: plane q's tile row i (sample 2 a0 - 6 + i of its columns) at
        // sm[(q * tr + i) * pc]; out: lp, hp of pair a0 + j at tile row j
        const int tr = 16 * g.rc + 12, pc = g.pc, nch = pc / 8, orows = kRun * g.rc;
        int16_t* olp = sm + g.pp * tr * pc;
        int16_t* ohp = olp + g.pp * orows * pc;
        const bool vec = ((uintptr_t)x & 15) == 0 && a.w % 8 == 0;
        const FastDiv by_ch(nch), by_tr(tr);
        fill(b.planes * tr * nch,
             [&](int i) {
                 const int t = by_ch(i), k = i - t * nch, q = by_tr(t), row = t - q * tr;
                 const int s = line_sample(2 * b.a0 - 6 + row, a.h, rep);
                 const int16_t* src = x + ((long long)(b.p0 + q) * a.h + max(s, 0)) * a.w + b.c0 + 8 * k;
                 // first: the chunk's columns on the plane (none off the line)
                 return Chunk{sm + (q * tr + row) * pc + 8 * k, src, s < 0 ? 0 : b.cols - 8 * k,
                              vec && s >= 0 && 8 * k < b.cols};
             },
             [](const Chunk& c, int e) { return e < c.first ? e : -1; });
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int q = lane / pc, c = lane - q * pc;
        if (q < b.planes && c < b.cols && r.a < g.n) {
            // the column's sample s at line[s * pc], neighbouring lanes on
            // neighbouring columns
            const int16_t* line = sm + (q * tr - (2 * b.a0 - 6)) * pc + c;
            if (r.inner_fwd()) {
#pragma unroll
                for (int j = 0; j < kWin; ++j) {
                    ev[j] = line[2 * (r.a - 3 + j) * pc];
                    od[j] = line[(2 * (r.a - 3 + j) + 1) * pc];
                }
                lift_run<WAV>(ev, od, lp, hp);
            } else {
                lift_edge<WAV, WRAP>([&](int m) { return (int)line[2 * m * pc]; },
                                     [&](int m) { return (int)line[(2 * m + 1) * pc]; }, r.a, g.n,
                                     Scratch{scratch + tid}, lp, hp);
            }
            const int o = (q * orows + kRun * warp) * pc + c;
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                olp[o + j * pc] = (int16_t)lp[j];
                ohp[o + j * pc] = (int16_t)hp[j];
            }
        }
        __syncthreads();
        const bool ovec = (((uintptr_t)lp_out | (uintptr_t)hp_out) & 15) == 0 && a.w % 8 == 0;
        const int per = b.planes * orows * nch;
        const FastDiv by_half(per), by_rows(orows);
        for (int i = tid; i < 2 * per; i += nt) {
            const int half = by_half(i), j = i - half * per, t = by_ch(j), k = j - t * nch;
            const int qq = by_rows(t), row = t - qq * orows, p = b.a0 + row;
            if (p >= g.n || 8 * k >= b.cols) continue;
            const int16_t* src = (half ? ohp : olp) + (qq * orows + row) * pc + 8 * k;
            int16_t* dst = (half ? hp_out : lp_out) + ((long long)(b.p0 + qq) * g.n + p) * a.w + b.c0 + 8 * k;
            if (ovec) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int e = 0; e < 8 && 8 * k + e < b.cols; ++e) dst[e] = src[e];
            }
        }
    }
}

template <int WAV, int AXIS, int WRAP>
__global__ void __launch_bounds__(kThreads) vunlift(const VliftArgs a, const VliftPtrs ptr) {
    __shared__ __align__(16) int16_t sm[kSmem];
    __shared__ int16_t scratch[(kRun + 3) * kThreads];  // runs at a line's end
    const bool g1 = blockIdx.y;
    const int16_t* lp_in = g1 ? ptr.in[2] : ptr.in[0];
    const int16_t* hp_in = g1 ? ptr.in[3] : ptr.in[1];
    int16_t* out = g1 ? ptr.out[1] : ptr.out[0];
    const Geometry g(a);
    const Block b(a, g);
    const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr bool rep = WRAP == REPEAT;
    const Run r{g.n, b.a0 + kRun * warp, rep};
    int lo[kWin], hi[kWin], ev[kRun], od[kRun];

    if (AXIS) {
        // in: lp, hp of pair a0 - 8 + i at column i of the CTA's row; out:
        // sample 2 a0 + i at column i
        const int pi = 8 * ((g.rc + 2) | 1), nch = g.rc + 2, po = 8 * (2 * g.rc + 1);
        int16_t* ihp = sm + kLines * pi;
        int16_t* otile = ihp + kLines * pi;
        const bool vec = (((uintptr_t)lp_in | (uintptr_t)hp_in) & 15) == 0 && g.n % 8 == 0;
        const FastDiv by_ch(nch), by_half(b.lines * nch);
        fill(2 * b.lines * nch,
             [&](int i) {
                 const int half = by_half(i), j = i - half * b.lines * nch, row = by_ch(j), k = j - row * nch;
                 const int p0 = b.a0 - 8 + 8 * k;
                 const int16_t* line = (half ? hp_in : lp_in) + (b.l0 + row) * g.n;
                 const bool whole = vec && p0 >= 0 && p0 + 8 <= g.n;
                 return Chunk{(half ? ihp : sm) + row * pi + 8 * k, whole ? line + p0 : line, p0, whole};
             },
             [&](const Chunk& c, int e) { return line_pair(c.first + e, g.n, rep); });
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (lane < b.lines && r.a < g.n) {
            if (r.inner_inv()) {
                // pairs a - 8 .. a + kRun + 7
                int l[kRun + 16], h[kRun + 16];
#pragma unroll
                for (int c = 0; c < kRun / 8 + 2; ++c) {
                    load8(sm + lane * pi + kRun * warp + 8 * c, l + 8 * c);
                    load8(ihp + lane * pi + kRun * warp + 8 * c, h + 8 * c);
                }
#pragma unroll
                for (int j = 0; j < kWin; ++j) {
                    lo[j] = l[j + 5];
                    hi[j] = h[j + 5];
                }
                unlift_run<WAV>(lo, hi, ev, od);
            } else {
                const int at = lane * pi - (b.a0 - 8);  // pair m at [at + m]
                unlift_edge<WAV, WRAP>([&](int m) { return (int)sm[at + m]; },
                                       [&](int m) { return (int)ihp[at + m]; }, r.a, g.n,
                                       Scratch{scratch + tid}, ev, od);
            }
            int v[2 * kRun];
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                v[2 * j] = ev[j];
                v[2 * j + 1] = od[j];
            }
            store8(otile + lane * po + 2 * kRun * warp, v);
            store8(otile + lane * po + 2 * kRun * warp + 8, v + 8);
        }
        __syncthreads();
        // samples 2 a0 .., the fake last one of an odd width dropped
        const bool ovec = ((uintptr_t)out & 15) == 0 && a.w % 8 == 0;
        const int och = 2 * g.rc;
        const FastDiv by_och(och);
        for (int i = tid; i < b.lines * och; i += nt) {
            const int row = by_och(i), k = i - row * och, s0 = 2 * b.a0 + 8 * k;
            if (s0 >= a.w) continue;
            const int16_t* src = otile + row * po + 8 * k;
            int16_t* dst = out + (b.l0 + row) * a.w + s0;
            if (ovec && s0 + 8 <= a.w) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int e = 0; e < 8 && s0 + e < a.w; ++e) dst[e] = src[e];
            }
        }
    } else {
        // in: lp, hp of plane q's pair a0 - 3 + i at tile row i; out:
        // sample 2 a0 + i at tile row i
        const int tr = kRun * g.rc + 6, pc = g.pc, nch = pc / 8, orows = 2 * kRun * g.rc;
        int16_t* ihp = sm + g.pp * tr * pc;
        int16_t* otile = ihp + g.pp * tr * pc;
        const bool vec = (((uintptr_t)lp_in | (uintptr_t)hp_in) & 15) == 0 && a.w % 8 == 0;
        const int per = b.planes * tr * nch;
        const FastDiv by_ch(nch), by_tr(tr), by_half(per);
        fill(2 * per,
             [&](int i) {
                 const int half = by_half(i), j = i - half * per, t = by_ch(j), k = j - t * nch;
                 const int q = by_tr(t), row = t - q * tr, p = line_pair(b.a0 - 3 + row, g.n, rep);
                 const int16_t* src = (half ? hp_in : lp_in) +
                                      ((long long)(b.p0 + q) * g.n + max(p, 0)) * a.w + b.c0 + 8 * k;
                 return Chunk{(half ? ihp : sm) + (q * tr + row) * pc + 8 * k, src,
                              p < 0 ? 0 : b.cols - 8 * k, vec && p >= 0 && 8 * k < b.cols};
             },
             [](const Chunk& c, int e) { return e < c.first ? e : -1; });
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int q = lane / pc, c = lane - q * pc;
        if (q < b.planes && c < b.cols && r.a < g.n) {
            const int at = (q * tr - (b.a0 - 3)) * pc + c;  // pair m at [at + m * pc]
            if (r.inner_inv()) {
#pragma unroll
                for (int j = 0; j < kWin; ++j) {
                    lo[j] = sm[at + (r.a - 3 + j) * pc];
                    hi[j] = ihp[at + (r.a - 3 + j) * pc];
                }
                unlift_run<WAV>(lo, hi, ev, od);
            } else {
                unlift_edge<WAV, WRAP>([&](int m) { return (int)sm[at + m * pc]; },
                                       [&](int m) { return (int)ihp[at + m * pc]; }, r.a, g.n,
                                       Scratch{scratch + tid}, ev, od);
            }
            const int o = (q * orows + 2 * kRun * warp) * pc + c;
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                otile[o + 2 * j * pc] = (int16_t)ev[j];
                otile[o + (2 * j + 1) * pc] = (int16_t)od[j];
            }
        }
        __syncthreads();
        const bool ovec = ((uintptr_t)out & 15) == 0 && a.w % 8 == 0;
        const FastDiv by_rows(orows);
        for (int i = tid; i < b.planes * orows * nch; i += nt) {
            const int t = by_ch(i), k = i - t * nch, qq = by_rows(t), row = t - qq * orows;
            const int s = 2 * b.a0 + row;
            if (s >= a.h || 8 * k >= b.cols) continue;
            const int16_t* src = otile + (qq * orows + row) * pc + 8 * k;
            int16_t* dst = out + ((long long)(b.p0 + qq) * a.h + s) * a.w + b.c0 + 8 * k;
            if (ovec) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int e = 0; e < 8 && 8 * k + e < b.cols; ++e) dst[e] = src[e];
            }
        }
    }
}

// An empty kernel: its device time is the least any launch takes on the
// stream, the floor under a call of many small launches. A measurement
// (chip_smoke.py, chip_probe.py); the codec never launches it.
__global__ void launch_floor() {}

// The grid's CTAs a call (gridDim.y takes the calls), or -1 for arguments
// beyond the kernels' limits.
long long vlift_grid(const VliftArgs& a) {
    if (a.n < 1 || a.h < 1 || a.w < 1 || a.axis < 0 || a.axis > 1 || a.groups < 1 || a.groups > 2 ||
        a.wavelet < DD137 || a.wavelet > HAAR || a.wrap < CLAMP || a.wrap > ZERO ||
        (long long)a.n * a.h > INT_MAX / 2 || (long long)a.h * a.w > INT_MAX / 2)
        return -1;
    const long long ctas = Geometry(a).ctas();
    return ctas > INT_MAX ? -1 : ctas;
}

template <class... P, class... A>
int launch(void (*kernel)(P...), long long grid, const VliftArgs& a, cudaStream_t s, A... args) {
    kernel<<<dim3((unsigned)grid, (unsigned)a.groups), kLines * Geometry(a).rc, 0, s>>>(args...);
    return (int)cudaGetLastError();
}

template <int WAV, int WRAP>
int wrap_launch(long long grid, const VliftArgs& a, const VliftPtrs& p, cudaStream_t s, bool fwd) {
    if (fwd) return a.axis ? launch(vlift<WAV, 1, WRAP>, grid, a, s, a, p)
                           : launch(vlift<WAV, 0, WRAP>, grid, a, s, a, p);
    return a.axis ? launch(vunlift<WAV, 1, WRAP>, grid, a, s, a, p)
                  : launch(vunlift<WAV, 0, WRAP>, grid, a, s, a, p);
}

template <int WAV>
int wav_launch(long long grid, const VliftArgs& a, const VliftPtrs& p, cudaStream_t s, bool fwd) {
    switch (a.wrap) {
        case CLAMP: return wrap_launch<WAV, CLAMP>(grid, a, p, s, fwd);
        case MIRROR: return wrap_launch<WAV, MIRROR>(grid, a, p, s, fwd);
        case REPEAT: return wrap_launch<WAV, REPEAT>(grid, a, p, s, fwd);
        default: return wrap_launch<WAV, ZERO>(grid, a, p, s, fwd);
    }
}

int vlift_launch(const VliftArgs* args, const VliftPtrs* ptrs, void* stream, bool fwd) {
    const VliftArgs& a = *args;
    const long long grid = vlift_grid(a);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return wav_launch<DD137>(grid, a, *ptrs, s, fwd);
        case CDF53: return wav_launch<CDF53>(grid, a, *ptrs, s, fwd);
        default: return wav_launch<HAAR>(grid, a, *ptrs, s, fwd);
    }
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// Forward (K1v): group g's contiguous int16 planes (n, h, w) at in[g] ->
// lp, hp at out[2g], out[2g + 1], each (n, ceil(h/2), w) along axis -2
// (args->axis 0) or (n, h, ceil(w/2)) along axis -1 (axis 1). Inverse
// (K2v): group g's lp, hp at in[2g], in[2g + 1], each (n, ceil(h/2), w) or
// (n, h, ceil(w/2)) -> the (n, h, w) planes at out[g], samples interleaved
// along the axis, the fake last one of an odd h (w) dropped. Both return
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments beyond the limits), run on `stream` and do not synchronise.
extern "C" int ako_vlift(const VliftArgs* args, const VliftPtrs* ptrs, void* stream) {
    return vlift_launch(args, ptrs, stream, true);
}

extern "C" int ako_vunlift(const VliftArgs* args, const VliftPtrs* ptrs, void* stream) {
    return vlift_launch(args, ptrs, stream, false);
}

// One launch of the empty kernel on `stream` (a measurement of the launch
// floor; see launch_floor).
extern "C" int ako_launch_floor(void* stream) {
    launch_floor<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
