// One 2-D lift level per launch, forward and inverse, for Hopper (sm_90a),
// on the planes too large for lift_pyramid.cu's block: the fused
// wiring's levels before ops/lift_kernels.py pyramid_start (the default
// whole-image tile's levels 0-2, level 0 of tiles of 256 px or more, and
// every level when pyramid_start is None).
//
// Replaces, on those levels, the TPU kernels of ako_tpu/ops/pallas_lift.py
// and the XLA ops around them:
//   lift_level   <- _lift2d_kernel (pallas_lift.py:90), with
//                   colorspace.to_planar_yuv at level 0 and
//                   lifting.forward_tile's quantize/gate and wire order
//                   (ako_tpu/ops/lifting.py:35-84)
//   unlift_level <- _unlift2d_kernel (pallas_lift.py:184), with
//                   inverse_tile's dequantize (lifting.py:87-132) and, at
//                   level 0, colorspace.to_interleaved_u8
// and computes exactly what ops/wavelets.py lift2d / unlift2d compute
// (the lifting steps are lift_common.cuh's lift_step, shared with
// lift_pyramid.cu).
//
// What bounds it: bytes, in principle. A level reads its plane once (the
// u8 tile at level 0) and writes its four quadrants once, with a few
// dozen integer operations per sample. lift2d.cu's route spent two
// launches per level and a round trip through an int16 scratch in device
// memory, one thread per output recomputing its neighbours' taps, with
// torch colour and quantize ops around them. Here one launch per level;
// measured on the H100, a CTA's chain of barrier-separated steps in
// shared memory sets the time, at about the pyramid kernels' rate per
// sample, far above the byte bound (PERF.md):
// - One CTA of 512 threads per (tile, region of rh x rw quadrant samples)
//   holding every channel of its region, so level 0's colour transform
//   and its inverse happen inside the block, with no cluster. The region
//   is chosen per level by ops/lift_kernels.py level_region: the largest
//   of its list that fits two CTAs an SM and whose grid gives no SM two
//   CTAs' work while others have one (the whole tile: 16 x 64 samples x
//   4 channels, 71 KB with DD 13/7's halos and level 0's staging rows,
//   320 CTAs at level 0, 80 at level 1; 8 x 32 and 80 CTAs at level 2;
//   chip_probe.py levels). Its layout (window pitch, staging rows) comes
//   with the arguments, from level_layout there.
// - The CTA copies its region plus a halo of 3 pairs on each side for DD
//   13/7 (1 for CDF 5/3, 0 for Haar) into shared memory with 16-byte
//   cp.async copies: at later levels straight into the window, which sits
//   a few samples into its row so that a sample lands at the same address
//   modulo 16 as in device memory (planes whose rows are a multiple of 16
//   bytes; others, and REPEAT's wrapped halo columns, are loaded one
//   sample at a time). Level 0 copies its u8 rows into two staging rows
//   per warp, one row in flight while the other is converted with the
//   colour transform, computed once per RGBA pixel. The halo is clipped
//   to the line: an edge CTA runs the EDGE steps with global pair indices
//   and the line's real length, so the wrap rules substitute exactly as
//   on the whole line (every substituted tap lies within an inner pair's
//   taps, hence in the window). REPEAT is exactly periodic in pair space:
//   its halo is filled from pair index mod n and every step is an inner
//   one. The fake odd sample of an odd side is loaded as its even sample,
//   also where it arrives as REPEAT's wrapped halo.
// - Forward: the rows of the window (halo rows too, so the column pass
//   has its taps) lift in place, predict then update, then the region's
//   columns; the predict runs on the pairs the update reads. LL goes to
//   the (T, C, th, tw) planes (or the stream's LP head), C, B, D gated and
//   divided by the level's and channel's q (multiply-high Divider)
//   straight to their wire offsets, beside the int16 q head; stores are
//   coalesced along rows. No global scratch between the passes.
// - Inverse: LL and C, B, D load through registers with the q > 1
//   int16-wrapping multiply applied as they load; the update then the
//   predict are undone along the window's columns, then along the
//   region's rows; the plane (or at level 0 the saturated interleaved u8
//   pixels after the inverse colour transform) is stored coalesced along
//   rows.
// Element offsets into the planes and streams are 64-bit.
//
// K7, the row-sharded lift level of ako_tpu/parallel/halo.py (the body of
// forward_tile_sharded, halo.py:349, and of inverse_tile_sharded, :436:
// XLA shard_map programs whose V pass takes its boundary rows from the
// neighbouring shards by lax.ppermute, ops/wavelets.py:57-176, with
// crafted pads and boundary fixes for ragged levels), is the same body
// launched on one shard's rows (lift_level_rows / unlift_level_rows, the
// ROWS instances):
// - The row axis keeps the whole level's global pair indices (len = the
//   level's height, n = its pairs), so the EDGE steps run at the line's
//   true ends and REPEAT's halo is taken modulo n, as on the whole plane;
//   the region grid covers only the shard's pairs [p0, p1).
// - The source is not the plane but the shard's window, a separate buffer
//   that ako_tpu_torch/parallel/halo.py copies out of whichever shards own
//   the rows: every channel's rows of pairs [win_lo, win_lo + win_n), two
//   rows a pair (the fake odd row of an odd height stored as its even
//   one), clipped to the line or taken modulo n as a CTA's window is. A
//   CTA's window slot j is the buffer's row 2 (lo - win_lo) + j. The halo
//   that lift_level already loads (3 / 1 / 0 pairs) covers every tap of
//   the shard's outputs, so the window's own ends are never read by them;
//   no pad and no boundary fix.
// - Forward: the input is int16 planes after colour (no u8 staging). LL
//   rows [p0, p1) go to the shard's (C, p1 - p0, tw) LL buffer, and the
//   q heads and gated, quantized C, B, D to a buffer in stream layout of
//   the shard's rows alone (per channel [q][C][B][D], p1 - p0 rows each;
//   halo.py's gather copies them to their wire offsets).
// - Inverse: the LL window (C, win_n, tw) and the chunk window in that
//   stream layout (C, 1 + 3 win_n tw, each channel's q head first) are
//   dequantized as they load; the output is the plane's rows
//   [2 p0, min(2 p1, h)), (C, rows, w) int16.
// Bound: bytes, as lift_level (a shard's window read once, its outputs
// written once); the launches run on each shard's own stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lift_common.cuh"

constexpr int kLevelChannels = 16;

// Mirrors kernels.LevelArgs (ctypes); all ints, so no padding. Outside
// the anonymous namespace, as lift_pyramid.cu's PyramidArgs.
struct LevelArgs {
    int channels;
    int height;     // the level's plane (current_h, current_w)
    int width;
    int rh;         // a CTA's region: quadrant rows x columns
    int rw;
    int wavelet;    // the level's effective wavelet
    int wrap;
    int color;      // colour transform, when u8
    int discard;    // discard non-visible, when u8
    int u8;         // forward: the input is u8 tiles; inverse: the output is
    int coeffs;     // elements of one tile's stream
    int off;        // the level's chunk offset in a tile's stream
    int ll_stride;  // elements per tile of the LL planes (forward output, inverse input)
    int q[kLevelChannels];
    int g[kLevelChannels];
    // the shared-memory layout, ops/lift_kernels.py level_layout: int16 per
    // window row (a multiple of 8) and per channel's window, bytes per
    // staging row of u8 pixels, and the CTA's bytes
    int pitch;
    int plane;
    int stage;
    int smem;
    // the row-window launches (K7) alone: the shard's pairs [p0, p1) of
    // the level's rows, and its window buffer's first pair and pairs per
    // channel; the whole-plane launches read none of them
    int p0;
    int p1;
    int win_lo;
    int win_n;
};

namespace {

using namespace ako;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

// Halo pairs on each side, and the pairs beyond a range [r0, r1) that a
// step must also compute for the next step's taps: the forward predict
// runs on [r0 - PL, r1 + PR) for the update on [r0, r1); the inverse
// undo-update on [r0 - UL, r1 + UR) for the undo-predict on [r0, r1).
__host__ __device__ constexpr int halo(int wav) { return wav == DD137 ? 3 : wav == CDF53 ? 1 : 0; }
__device__ constexpr int pl(int wav) { return wav == DD137 ? 2 : wav == CDF53 ? 1 : 0; }
__device__ constexpr int pr(int wav) { return wav == DD137 ? 1 : 0; }
__device__ constexpr int ul(int wav) { return wav == DD137 ? 1 : 0; }
__device__ constexpr int ur(int wav) { return wav == DD137 ? 2 : wav == CDF53 ? 1 : 0; }

// One step along the rows of a window: rows [0, per) of each channel's
// plane, pairs [k0, k1) of axis x. A warp takes a row and its lanes
// consecutive pairs (4 bytes apart: no bank conflict). Ends with
// __syncthreads.
template <int WAV, int KIND>
__device__ void step_rows(int16_t* p, int C, int plane, int pitch, int first, int per,
                          const Axis& x, int k0, int k1, int wrap) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int l = warp; l < C * per; l += kWarps) {
        const int ch = l / per;
        int16_t* line = p + ch * plane + (first + l - ch * per) * pitch;
        for (int k = k0 + lane; k < k1; k += 32) {
            if (x.edge(k)) lift_step<WAV, KIND, true>(line, 1, k, x.n, INT_MAX, wrap, x.lo);
            else lift_step<WAV, KIND, false>(line, 1, k, x.n, INT_MAX, wrap, x.lo);
        }
    }
    __syncthreads();
}

// One step along columns [first, first + ncols) of a window, pairs
// [k0, k1) of axis y. A warp takes a (channel, pair) and its lanes
// consecutive columns, so the edge test is uniform across the warp. Ends
// with __syncthreads.
template <int WAV, int KIND>
__device__ void step_cols(int16_t* p, int C, int plane, int pitch, int first, int ncols,
                          const Axis& y, int k0, int k1, int wrap) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, np = k1 - k0;
    for (int l = warp; l < C * np; l += kWarps) {
        const int ch = l / np, k = k0 + l - ch * np;
        int16_t* col = p + ch * plane + first;
        if (y.edge(k)) {
            for (int c = lane; c < ncols; c += 32)
                lift_step<WAV, KIND, true>(col + c, pitch, k, y.n, INT_MAX, wrap, y.lo);
        } else {
            for (int c = lane; c < ncols; c += 32)
                lift_step<WAV, KIND, false>(col + c, pitch, k, y.n, INT_MAX, wrap, y.lo);
        }
    }
    __syncthreads();
}

// The CTA's tile t, its region's index in the tile (row-major over the
// regions) and its two axes; the rows' regions cover pairs [p0, p1).
template <int WAV>
struct Region {
    int t, idx;
    Axis y, x;
    __device__ Region(const LevelArgs& a, int p0, int p1, int nx, int ny)
        : t(blockIdx.x / (nx * ny)),
          idx(blockIdx.x - t * nx * ny),
          y(a.height, a.rh, idx / nx, halo(WAV), a.wrap == REPEAT, p0, p1),
          x(a.width, a.rw, idx % nx, halo(WAV), a.wrap == REPEAT, 0, (a.width + 1) / 2) {}
    __device__ Region(const LevelArgs& a, int p0, int p1)
        : Region(a, p0, p1, ((a.width + 1) / 2 + a.rw - 1) / a.rw, (p1 - p0 + a.rh - 1) / a.rh) {}
};

// The pairs of the level's rows a launch makes: the whole plane's, or
// (ROWS) the shard's.
template <bool ROWS>
__device__ __forceinline__ int first_pair(const LevelArgs& a) { return ROWS ? a.p0 : 0; }
template <bool ROWS>
__device__ __forceinline__ int end_pair(const LevelArgs& a) { return ROWS ? a.p1 : (a.height + 1) / 2; }

template <int WAV, bool ROWS>
__device__ __forceinline__ void lift_body(const LevelArgs& a, const void* __restrict__ src,
                                          int16_t* stream, int16_t* ll) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Region<WAV> g(a, first_pair<ROWS>(a), end_pair<ROWS>(a));
    const Axis &y = g.y, &x = g.x;
    const int C = a.channels, h = a.height, w = a.width, pitch = a.pitch, plane = a.plane;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wr = 2 * (y.hi - y.lo), wc = 2 * (x.hi - x.lo);  // the window's rows and columns
    // the samples of a row that lie on the line, [s0, s1): REPEAT's
    // wrapped halo columns lie outside them
    const int s0 = 2 * max(x.lo, 0), s1 = min(w, 2 * min(x.hi, x.n));
    // the int16 planes' rows are 16-byte aligned: the window starts sh
    // samples into its row, so that sample s lands at column s - 2 lo + sh,
    // equal to s modulo 8 (pitch and plane are multiples of 8 samples)
    const bool vec16 = (ROWS || !a.u8) && (((uintptr_t)src & 15) | (w & 7)) == 0;
    int16_t* p = reinterpret_cast<int16_t*>(smem) + (vec16 ? (2 * x.lo) & 7 : 0);

    if (!ROWS && a.u8) {
        // the bytes [b0, b1) of each window row, its samples [s0, s1),
        // staged per warp (two rows, one in flight while the other is
        // converted) with 16-byte cp.async copies when the tiles' rows are
        // 16-byte aligned; REPEAT's wrapped halo columns are read from
        // device memory
        const int row_bytes = w * C;
        const uint8_t* tile = static_cast<const uint8_t*>(src) + (size_t)g.t * h * row_bytes;
        const bool vec = (((uintptr_t)src | row_bytes) & 15) == 0;
        const int b0 = vec ? (s0 * C) & ~15 : s0 * C;
        const int b1 = vec ? min((s1 * C + 15) & ~15, row_bytes) : s1 * C;
        unsigned char* const st0 = smem + 2 * C * plane + 2 * warp * a.stage;
        auto fetch = [&](int j) {
            const uint8_t* row = tile + (size_t)y.sample(j) * row_bytes + b0;
            unsigned char* st = st0 + ((j / kWarps) & 1) * a.stage;
            if (vec) {
                for (int v = lane; v < (b1 - b0) / 16; v += 32) cp_async16(st + 16 * v, row + 16 * v);
            } else {
                for (int v = lane; v < b1 - b0; v += 32) st[v] = __ldg(row + v);
            }
            cp_async_commit();
        };
        if (warp < wr) fetch(warp);
        for (int j = warp; j < wr; j += kWarps) {
            if (j + kWarps < wr) {
                fetch(j + kWarps);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncwarp();
            const unsigned char* st = st0 + ((j / kWarps) & 1) * a.stage;
            const uint8_t* row = tile + (size_t)y.sample(j) * row_bytes;
            for (int i = lane; i < wc; i += 32) {
                const int xs = x.sample(i);
                const uint8_t* px = xs >= s0 && xs < s1 ? st + xs * C - b0 : row + (size_t)xs * C;
                int16_t* d = p + j * pitch + i;
                if (C == 4) {
                    // one 4-byte load and one colour transform per pixel
                    const uint32_t v = *reinterpret_cast<const uint32_t*>(px);
                    int yuv[3] = {(int)(v & 255), (int)((v >> 8) & 255), (int)((v >> 16) & 255)};
                    if (a.discard && (v >> 24) == 0) yuv[0] = yuv[1] = yuv[2] = 0;
                    if (a.color != COLOR_NONE) colour_yuv(yuv[0], yuv[1], yuv[2], a.color, yuv);
                    d[0] = (int16_t)yuv[0];
                    d[plane] = (int16_t)yuv[1];
                    d[2 * plane] = (int16_t)yuv[2];
                    d[3 * plane] = (int16_t)(v >> 24);
                } else {
                    for (int ch = 0; ch < C; ++ch)
                        d[ch * plane] = (int16_t)colour_fwd(px, C, ch, a.color, a.discard);
                }
            }
            __syncwarp();
        }
    } else {
        // with aligned rows, the 8-sample chunks that cover [s0, s1) by
        // cp.async (w is a multiple of 8, so the chunks end inside the
        // row) and the window's columns outside them, [0, i0) and [i1, wc),
        // one sample at a time; else every column one sample at a time.
        // ROWS: window slot j is row 2 (lo - win_lo) + j of the shard's
        // window buffer, 2 win_n rows a channel
        const int src_rows = ROWS ? 2 * a.win_n : h;
        const int16_t* planes = static_cast<const int16_t*>(src) + (size_t)g.t * C * src_rows * w;
        const int a0 = s0 & ~7, nv = vec16 ? (s1 - a0 + 7) >> 3 : 0;
        const int i0 = vec16 ? s0 - 2 * x.lo : wc, i1 = vec16 ? s1 - 2 * x.lo : wc;
        for (int l = warp; l < C * wr; l += kWarps) {
            const int ch = l / wr, j = l - ch * wr;
            const int sr = ROWS ? 2 * (y.lo - a.win_lo) + j : y.sample(j);
            const int16_t* row = planes + ((size_t)ch * src_rows + sr) * w;
            int16_t* dst = p + ch * plane + j * pitch;
            for (int v = lane; v < nv; v += 32)
                cp_async16(dst + a0 - 2 * x.lo + 8 * v, row + a0 + 8 * v);
            for (int i = lane; i < i0; i += 32) dst[i] = row[x.sample(i)];
            for (int i = i1 + lane; i < wc; i += 32) dst[i] = row[x.sample(i)];
        }
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();

    // rows of the whole window, then the region's columns; each axis's
    // window starts at local pair 0 = pair lo
    step_rows<WAV, PREDICT>(p, C, plane, pitch, 0, wr, x, max(x.r0 - pl(WAV), x.lo),
                            min(x.r1 + pr(WAV), x.hi), a.wrap);
    step_rows<WAV, UPDATE>(p, C, plane, pitch, 0, wr, x, x.r0, x.r1, a.wrap);
    const int c0 = 2 * (x.r0 - x.lo), nc = 2 * (x.r1 - x.r0);
    step_cols<WAV, PREDICT>(p, C, plane, pitch, c0, nc, y, max(y.r0 - pl(WAV), y.lo),
                            min(y.r1 + pr(WAV), y.hi), a.wrap);
    step_cols<WAV, UPDATE>(p, C, plane, pitch, c0, nc, y, y.r0, y.r1, a.wrap);

    // LL at the even (row, column) slots, C at the odd rows, B at the odd
    // columns, D at both -> the LL planes and [q head][C][B][D] of the
    // launch's rows [o0, o0 + rows): the whole plane's, or the shard's
    const int o0 = first_pair<ROWS>(a), rows = end_pair<ROWS>(a) - o0;
    const int tw = x.n, n = rows * tw, nr = y.r1 - y.r0;
    int16_t* chunks = stream + (size_t)g.t * a.coeffs + a.off;
    if (g.idx == 0 && (int)threadIdx.x < C)
        chunks[threadIdx.x * (1 + 3 * n)] = (int16_t)a.q[threadIdx.x];
    Divider div(1);
    int cur = -1, gate = 0;
    for (int l = warp; l < C * nr; l += kWarps) {
        const int ch = l / nr, r = y.r0 + l - ch * nr;
        if (ch != cur) {  // a warp's lines are in channel order
            cur = ch;
            gate = a.g[ch];
            div = Divider(max(a.q[ch], 1));
        }
        auto quant = [&](int v) -> int16_t { return (int16_t)((v < -gate || v > gate) ? div(v) : 0); };
        int16_t* dst = chunks + ch * (1 + 3 * n) + 1 + (size_t)(r - o0) * tw;
        int16_t* out = ll + (size_t)g.t * a.ll_stride + ((size_t)ch * rows + r - o0) * tw;
        const int16_t* e = p + ch * plane + 2 * (r - y.lo) * pitch - 2 * x.lo;
        for (int c = x.r0 + lane; c < x.r1; c += 32) {
            const int16_t* s = e + 2 * c;
            out[c] = s[0];
            dst[c] = quant(s[pitch]);              // C
            dst[n + c] = quant(s[1]);              // B
            dst[2 * n + c] = quant(s[pitch + 1]);  // D
        }
    }
}

template <int WAV, bool ROWS>
__device__ __forceinline__ void unlift_body(const LevelArgs& a, const int16_t* ll,
                                            const int16_t* stream, void* __restrict__ dst) {
    extern __shared__ __align__(16) unsigned char smem[];
    int16_t* p = reinterpret_cast<int16_t*>(smem);
    const Region<WAV> g(a, first_pair<ROWS>(a), end_pair<ROWS>(a));
    const Axis &y = g.y, &x = g.x;
    const int C = a.channels, h = a.height, w = a.width, pitch = a.pitch, plane = a.plane;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // pairs a channel of the LL and chunk buffers holds: the plane's, or
    // (ROWS) the window's, whose first is pair win_lo
    const int src_pairs = ROWS ? a.win_n : y.n, tw = x.n, n = src_pairs * tw;
    const int npr = y.hi - y.lo, npc = x.hi - x.lo;

    // the window's pairs: LL at the even (row, column) slots, C, B, D
    // dequantized by the channel's q head at the odd ones. Loaded through
    // registers, coalesced along rows: each quadrant's row lands at every
    // other slot and C, B, D are multiplied, which a byte copy into shared
    // memory cannot do
    const int16_t* chunks = stream + (size_t)g.t * a.coeffs + a.off;
    for (int l = warp; l < C * npr; l += kWarps) {
        const int ch = l / npr, i = l - ch * npr, gr = ROWS ? y.lo + i - a.win_lo : y.pair(i);
        const int16_t* chunk = chunks + ch * (1 + 3 * n);
        const int q = chunk[0];
        auto dq = [&](int v) -> int16_t { return (int16_t)(q > 1 ? v * q : v); };
        const int16_t* lrow = ll + (size_t)g.t * a.ll_stride + ((size_t)ch * src_pairs + gr) * tw;
        const int16_t* crow = chunk + 1 + (size_t)gr * tw;
        int16_t* e = p + ch * plane + 2 * i * pitch;
        for (int j = lane; j < npc; j += 32) {
            const int gc = x.pair(j);
            e[2 * j] = lrow[gc];
            e[pitch + 2 * j] = dq(crow[gc]);              // C
            e[2 * j + 1] = dq(crow[n + gc]);              // B
            e[pitch + 2 * j + 1] = dq(crow[2 * n + gc]);  // D
        }
    }
    __syncthreads();

    // every column of the window, then the region's rows (not the fake
    // last row of an odd height: it is dropped)
    step_cols<WAV, UNDO_UPDATE>(p, C, plane, pitch, 0, 2 * npc, y, max(y.r0 - ul(WAV), y.lo),
                                min(y.r1 + ur(WAV), y.hi), a.wrap);
    step_cols<WAV, UNDO_PREDICT>(p, C, plane, pitch, 0, 2 * npc, y, y.r0, y.r1, a.wrap);
    const int row0 = 2 * y.r0, row1 = min(2 * y.r1, h), col0 = 2 * x.r0, col1 = min(2 * x.r1, w);
    const int first = 2 * (y.r0 - y.lo), nrows = row1 - row0;
    step_rows<WAV, UNDO_UPDATE>(p, C, plane, pitch, first, nrows, x, max(x.r0 - ul(WAV), x.lo),
                                min(x.r1 + ur(WAV), x.hi), a.wrap);
    step_rows<WAV, UNDO_PREDICT>(p, C, plane, pitch, first, nrows, x, x.r0, x.r1, a.wrap);

    const int16_t* win = p + (first - row0) * pitch - 2 * x.lo;  // sample (r, c) at win[r * pitch + c]
    if (ROWS || !a.u8) {
        // the plane's rows [o0, o0 + rows): all of them, or (ROWS) the
        // shard's [2 p0, min(2 p1, h))
        const int o0 = 2 * first_pair<ROWS>(a), rows = min(2 * end_pair<ROWS>(a), h) - o0;
        int16_t* out = static_cast<int16_t*>(dst) + (size_t)g.t * C * rows * w;
        for (int l = warp; l < C * nrows; l += kWarps) {
            const int ch = l / nrows, r = row0 + l - ch * nrows;
            int16_t* orow = out + ((size_t)ch * rows + r - o0) * w;
            const int16_t* srow = win + ch * plane + r * pitch;
            for (int c = col0 + lane; c < col1; c += 32) orow[c] = srow[c];
        }
        return;
    }
    uint8_t* out = static_cast<uint8_t*>(dst) + (size_t)g.t * h * w * C;
    for (int r = row0 + warp; r < row1; r += kWarps) {
        const int16_t* srow = win + r * pitch;
        for (int c = col0 + lane; c < col1; c += 32) {
            auto val = [&](int k) -> int { return srow[k * plane + c]; };
            uint8_t v[kLevelChannels];
            colour_inv(val, C, a.color, v);
            const size_t idx = (size_t)r * w + c;
            if (C == 4) {
                reinterpret_cast<uint32_t*>(out)[idx] =
                    v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
            } else {
                for (int k = 0; k < C; ++k) out[idx * C + k] = v[k];
            }
        }
    }
}

// The whole-plane kernels (lift_level / unlift_level) and K7's row-window
// ones (lift_level_rows / unlift_level_rows): one body each way, the
// window a compile-time choice, so the whole-plane kernels read none of
// its fields.
template <int WAV>
__global__ void __launch_bounds__(kThreads)
    lift_level(const LevelArgs a, const void* __restrict__ src, int16_t* stream, int16_t* ll) {
    lift_body<WAV, false>(a, src, stream, ll);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    lift_level_rows(const LevelArgs a, const void* __restrict__ src, int16_t* stream, int16_t* ll) {
    lift_body<WAV, true>(a, src, stream, ll);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    unlift_level(const LevelArgs a, const int16_t* ll, const int16_t* stream, void* __restrict__ dst) {
    unlift_body<WAV, false>(a, ll, stream, dst);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    unlift_level_rows(const LevelArgs a, const int16_t* ll, const int16_t* stream,
                      void* __restrict__ dst) {
    unlift_body<WAV, true>(a, ll, stream, dst);
}

// The grid (one CTA per tile and region), or -1 for arguments beyond the
// kernel's limits. The shared-memory layout is the caller's (level_layout);
// this checks only that its buffers lie in the bytes the launch asks for,
// aligned for the 16-byte copies, and that those fit a block. A row-window
// launch (`rows`) takes int16 planes, and its window must hold its pairs
// and their halo, clipped to the line or, for REPEAT, unclipped.
long long level_grid(const LevelArgs& a, int tiles, bool stage, bool rows) {
    if (a.channels < 1 || a.channels > kLevelChannels || a.height < 1 || a.width < 1 ||
        a.rh < 1 || a.rw < 1 || a.pitch < 1 || tiles < 1 || a.wavelet < DD137 || a.wavelet > HAAR)
        return -1;
    const long long used = 2LL * a.channels * a.plane + (stage ? 2LL * kWarps * a.stage : 0);
    if ((a.pitch | a.plane) % 8 || (stage && a.stage % 16) || used > a.smem || a.smem > kMaxSmem)
        return -1;
    const int n = (a.height + 1) / 2;
    int p0 = 0, p1 = n;
    if (rows) {
        const int hl = halo(a.wavelet), rep = a.wrap == REPEAT;
        const int lo = rep ? a.p0 - hl : (a.p0 - hl > 0 ? a.p0 - hl : 0);
        const int hi = rep ? a.p1 + hl : (a.p1 + hl < n ? a.p1 + hl : n);
        if (a.u8 || a.p0 < 0 || a.p1 > n || a.p0 >= a.p1 || a.win_lo > lo || a.win_lo + a.win_n < hi)
            return -1;
        p0 = a.p0;
        p1 = a.p1;
    }
    const long long grid = (long long)tiles * ((p1 - p0 + a.rh - 1) / a.rh) *
                           (((a.width + 1) / 2 + a.rw - 1) / a.rw);
    return grid > INT_MAX ? -1 : grid;
}

template <class... P, class... A>
int launch(void (*kernel)(P...), long long grid, int smem, cudaStream_t s, A... args) {
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)grid, kThreads, smem, s>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// Forward: src is the (tiles, height, width, channels) u8 tiles when
// args->u8, else the (tiles, channels, height, width) int16 planes; the
// launch writes the level's chunk of the (tiles, coeffs) int16 stream and
// the LL planes to ll (tile t's (channels, th, tw) at t * ll_stride).
// Inverse: the LL planes at ll (same layout) and the stream -> dst, the
// (tiles, height, width, channels) u8 tiles when args->u8, else the
// (tiles, channels, height, width) int16 planes. All four return
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments beyond the limits), run on `stream` and do not synchronise.
extern "C" int ako_lift_level(const LevelArgs* args, const void* src, int16_t* out, int16_t* ll,
                              int tiles, void* stream) {
    const LevelArgs& a = *args;
    const long long grid = level_grid(a, tiles, a.u8, false);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(lift_level<DD137>, grid, a.smem, s, a, src, out, ll);
        case CDF53: return launch(lift_level<CDF53>, grid, a.smem, s, a, src, out, ll);
        default: return launch(lift_level<HAAR>, grid, a.smem, s, a, src, out, ll);
    }
}

extern "C" int ako_unlift_level(const LevelArgs* args, const int16_t* ll, const int16_t* coeffs,
                                void* dst, int tiles, void* stream) {
    const LevelArgs& a = *args;
    const long long grid = level_grid(a, tiles, false, false);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(unlift_level<DD137>, grid, a.smem, s, a, ll, coeffs, dst);
        case CDF53: return launch(unlift_level<CDF53>, grid, a.smem, s, a, ll, coeffs, dst);
        default: return launch(unlift_level<HAAR>, grid, a.smem, s, a, ll, coeffs, dst);
    }
}

// K7, one shard's launch (one tile). Forward: win is the shard's (channels,
// 2 win_n, width) int16 window; the launch writes the q heads and C, B, D
// of its pairs [p0, p1) to out, (channels, 1 + 3 (p1 - p0) tw) int16 in
// stream layout, and their LL to ll, (channels, p1 - p0, tw). Inverse: the
// (channels, win_n, tw) LL window at ll and the (channels, 1 + 3 win_n tw)
// chunk window at coeffs -> dst, the plane's rows [2 p0, min(2 p1,
// height)), (channels, rows, width) int16.
extern "C" int ako_lift_level_rows(const LevelArgs* args, const int16_t* win, int16_t* out,
                                   int16_t* ll, void* stream) {
    const LevelArgs& a = *args;
    const long long grid = level_grid(a, 1, false, true);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(lift_level_rows<DD137>, grid, a.smem, s, a, win, out, ll);
        case CDF53: return launch(lift_level_rows<CDF53>, grid, a.smem, s, a, win, out, ll);
        default: return launch(lift_level_rows<HAAR>, grid, a.smem, s, a, win, out, ll);
    }
}

extern "C" int ako_unlift_level_rows(const LevelArgs* args, const int16_t* ll,
                                     const int16_t* coeffs, int16_t* dst, void* stream) {
    const LevelArgs& a = *args;
    const long long grid = level_grid(a, 1, false, true);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(unlift_level_rows<DD137>, grid, a.smem, s, a, ll, coeffs, dst);
        case CDF53: return launch(unlift_level_rows<CDF53>, grid, a.smem, s, a, ll, coeffs, dst);
        default: return launch(unlift_level_rows<HAAR>, grid, a.smem, s, a, ll, coeffs, dst);
    }
}
