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
// launched once per sharded level and device over all of that device's
// shards (lift_level_shards / unlift_level_shards, the SHARDS instances),
// with a ShardArgs table beside the LevelArgs:
// - The shard table: each shard's pairs [p0, p1) of the level's rows (up
//   to kMaxShards, in order) and the prefix count of its CTAs, which the
//   launcher fills. A CTA finds its shard by a short scan of the prefix
//   counts, then runs as a whole-plane CTA whose regions cover only the
//   shard's pairs, from its first: the row axis keeps the whole level's
//   global pair indices (len = the level's height, n = its pairs), so the
//   EDGE steps run at the line's true ends and REPEAT's halo is taken
//   modulo n, and ragged, one-pair or empty shards (an empty one is left
//   out of the table) need nothing. The region (rh x rw) is chosen for the
//   launch's total CTAs (ops/lift_kernels.py shards_region): on one card
//   the whole level's, 320 CTAs at the whole tile's level 0.
// - The segment table: runs of rows [r0, r1) of the source, each a base
//   pointer and its channel, quadrant and row strides. Rows are read in
//   place: a CTA computes each window slot's plane row as the whole-plane
//   path does (y.sample on the global pair, REPEAT's modulo and the fake
//   odd row of an odd height included) and loads it from the segment that
//   holds it (the first one, by a scan), with 16-byte cp.async copies
//   where the row is 16-byte aligned and the plane's rows a multiple of 8
//   samples, else one sample at a time. The host (parallel/halo.py) gives
//   a launch one segment a source, its device's buffer at the source's
//   full height, into which it first copies, at their own rows, only the
//   rows that the device's windows need from other devices.
// - Forward: the input is int16 planes after colour (no u8 staging): the
//   level's plane at level 0, then the previous level's LL. LL rows, and
//   the q heads and gated, quantized C, B, D at their wire offsets, go to
//   outputs that hold pairs [out_p0, out_p0 + out_len) in stream layout
//   (on the home device the output stream's level chunk itself, out_p0 =
//   0); the shard whose first pair is out_p0 stores the q heads.
// - Inverse: two tables in one, the LL rows by pair [0, lls) and the C, B,
//   D rows by pair [lls, segs) (the stream's chunk on the home device),
//   and the q heads by pointer and stride; dequantized as they load. The
//   output holds the plane's rows [2 out_p0, 2 out_p0 + out_len).
// Bound: bytes, as lift_level (on one card a level's plane read once and
// its outputs written once); one launch fills the SMs as lift_level's
// does, so a launch costs about lift_level's time on the level, and the
// small levels (3 and 4 of the whole tile) about a launch's floor.
// lift_level_rows / unlift_level_rows (ops/lift_kernels.py) are the
// one-shard case: a table of one shard whose segments are its window
// buffer's runs of rows.

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
};

constexpr int kMaxShards = 32;
constexpr int kMaxSegs = 64;

// A run of rows [r0, r1) of a K7 launch's source: forward, rows of the
// level's plane; inverse, pairs of the level (its LL rows, or its C, B, D
// rows). Row r of channel ch (quadrant q of C, B, D) at base + ch * chan +
// q * quad + (r - r0) * pitch, in int16 elements. Mirrors kernels.Seg.
struct Seg {
    const int16_t* base;
    long long chan;
    long long quad;
    int r0;
    int r1;
    int pitch;
};

// K7's tables (SHARDS instances alone; mirrors kernels.ShardArgs): the
// shards, in pair order, the first CTA of each (cta0[shards] the grid;
// set by the launcher), the segments (inverse: the LL ones [0, lls), the
// C, B, D ones [lls, segs)), the outputs' pairs (forward) or rows
// (inverse) [out_p0, out_p0 + out_len) (inverse: rows from 2 out_p0), and
// the inverse's q heads, channel ch's at heads[ch * head_stride].
struct ShardArgs {
    int shards;
    int p0[kMaxShards];
    int p1[kMaxShards];
    int cta0[kMaxShards + 1];
    int segs;
    int lls;
    int out_p0;
    int out_len;
    const int16_t* heads;
    long long head_stride;
    Seg seg[kMaxSegs];
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

// The CTA's tile t, its region's index (row-major over the regions of its
// tile, or of its shard) and its two axes; the rows' regions cover pairs
// [p0, p1).
template <int WAV>
struct Region {
    int t, idx;
    Axis y, x;
    __device__ Region(const LevelArgs& a, int t_, int idx_, int nx, int p0, int p1)
        : t(t_),
          idx(idx_),
          y(a.height, a.rh, idx_ / nx, halo(WAV), a.wrap == REPEAT, p0, p1),
          x(a.width, a.rw, idx_ % nx, halo(WAV), a.wrap == REPEAT, 0, (a.width + 1) / 2) {}
};

// The whole plane's CTAs, tile by tile; or (SHARDS) the shard's whose CTAs
// hold blockIdx.x, found by a scan of the prefix counts.
template <int WAV, bool SHARDS>
__device__ __forceinline__ Region<WAV> region(const LevelArgs& a, const ShardArgs* s) {
    const int nx = ((a.width + 1) / 2 + a.rw - 1) / a.rw, b = blockIdx.x;
    if constexpr (SHARDS) {
        int i = 0;
        while (i + 1 < s->shards && s->cta0[i + 1] <= b) ++i;
        return Region<WAV>(a, 0, b - s->cta0[i], nx, s->p0[i], s->p1[i]);
    } else {
        const int n = (a.height + 1) / 2, per = nx * ((n + a.rh - 1) / a.rh), t = b / per;
        return Region<WAV>(a, t, b - t * per, nx, 0, n);
    }
}

// The first of segments [first, end) that holds row r (the host's tables
// cover every row a CTA reads), and channel ch's row r in a segment.
__device__ __forceinline__ const Seg& seg_of(const ShardArgs* s, int first, int end, int r) {
    int i = first;
    while (i + 1 < end && (r < s->seg[i].r0 || r >= s->seg[i].r1)) ++i;
    return s->seg[i];
}
__device__ __forceinline__ const int16_t* seg_row(const Seg& g, int ch, int r) {
    return g.base + ch * g.chan + (long long)(r - g.r0) * g.pitch;
}

template <int WAV, bool SHARDS>
__device__ __forceinline__ void lift_body(const LevelArgs& a, const ShardArgs* s,
                                          const void* __restrict__ src, int16_t* stream,
                                          int16_t* ll) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Region<WAV> g = region<WAV, SHARDS>(a, s);
    const Axis &y = g.y, &x = g.x;
    const int C = a.channels, h = a.height, w = a.width, pitch = a.pitch, plane = a.plane;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wr = 2 * (y.hi - y.lo), wc = 2 * (x.hi - x.lo);  // the window's rows and columns
    // the samples of a row that lie on the line, [s0, s1): REPEAT's
    // wrapped halo columns lie outside them
    const int s0 = 2 * max(x.lo, 0), s1 = min(w, 2 * min(x.hi, x.n));
    // the int16 planes' rows are 16-byte aligned: the window starts sh
    // samples into its row, so that sample s lands at column s - 2 lo + sh,
    // equal to s modulo 8 (pitch and plane are multiples of 8 samples).
    // SHARDS: rows a multiple of 8 samples; each row's alignment is its
    // segment's, checked as it loads
    const bool vec16 = SHARDS ? (w & 7) == 0 : !a.u8 && (((uintptr_t)src & 15) | (w & 7)) == 0;
    int16_t* p = reinterpret_cast<int16_t*>(smem) + (vec16 ? (2 * x.lo) & 7 : 0);

    if (!SHARDS && a.u8) {
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
        // SHARDS: window slot j's plane row read in place from the segment
        // that holds it, one sample at a time where it is not 16-byte aligned
        const int16_t* planes =
            SHARDS ? nullptr : static_cast<const int16_t*>(src) + (size_t)g.t * C * h * w;
        const int a0 = s0 & ~7, nv = vec16 ? (s1 - a0 + 7) >> 3 : 0;
        const int i0 = vec16 ? s0 - 2 * x.lo : wc, i1 = vec16 ? s1 - 2 * x.lo : wc;
        for (int l = warp; l < C * wr; l += kWarps) {
            const int ch = l / wr, j = l - ch * wr;
            const int16_t* row;
            if constexpr (SHARDS) row = seg_row(seg_of(s, 0, s->segs, y.sample(j)), ch, y.sample(j));
            else row = planes + ((size_t)ch * h + y.sample(j)) * w;
            const bool rv = !SHARDS || ((uintptr_t)row & 15) == 0;
            const int rnv = rv ? nv : 0, ri0 = rv ? i0 : wc, ri1 = rv ? i1 : wc;
            int16_t* dst = p + ch * plane + j * pitch;
            for (int v = lane; v < rnv; v += 32)
                cp_async16(dst + a0 - 2 * x.lo + 8 * v, row + a0 + 8 * v);
            for (int i = lane; i < ri0; i += 32) dst[i] = row[x.sample(i)];
            for (int i = ri1 + lane; i < wc; i += 32) dst[i] = row[x.sample(i)];
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
    // columns, D at both -> the LL planes and [q head][C][B][D] of pairs
    // [o0, o0 + rows): the whole plane's, or (SHARDS) the outputs'; the q
    // heads by the region at pair o0's first column
    const int o0 = SHARDS ? s->out_p0 : 0, rows = SHARDS ? s->out_len : (h + 1) / 2;
    const int tw = x.n, n = rows * tw, nr = y.r1 - y.r0;
    int16_t* chunks = stream + (size_t)g.t * a.coeffs + a.off;
    if (g.idx == 0 && y.r0 == o0 && (int)threadIdx.x < C)
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

template <int WAV, bool SHARDS>
__device__ __forceinline__ void unlift_body(const LevelArgs& a, const ShardArgs* s,
                                            const int16_t* ll, const int16_t* stream,
                                            void* __restrict__ dst) {
    extern __shared__ __align__(16) unsigned char smem[];
    int16_t* p = reinterpret_cast<int16_t*>(smem);
    const Region<WAV> g = region<WAV, SHARDS>(a, s);
    const Axis &y = g.y, &x = g.x;
    const int C = a.channels, h = a.height, w = a.width, pitch = a.pitch, plane = a.plane;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tw = x.n, n = y.n * tw;
    const int npr = y.hi - y.lo, npc = x.hi - x.lo;

    // the window's pairs: LL at the even (row, column) slots, C, B, D
    // dequantized by the channel's q head at the odd ones. Loaded through
    // registers, coalesced along rows: each quadrant's row lands at every
    // other slot and C, B, D are multiplied, which a byte copy into shared
    // memory cannot do. SHARDS: pair gr's LL and C, B, D rows from the
    // segments that hold them, the q heads from their own pointer
    for (int l = warp; l < C * npr; l += kWarps) {
        const int ch = l / npr, i = l - ch * npr, gr = y.pair(i);
        const int16_t *lrow, *crow;
        long long qs;  // elements from a pair's C row to its B row, and B to D
        int q;
        if constexpr (SHARDS) {
            const Seg& c = seg_of(s, s->lls, s->segs, gr);
            lrow = seg_row(seg_of(s, 0, s->lls, gr), ch, gr);
            crow = seg_row(c, ch, gr);
            qs = c.quad;
            q = s->heads[ch * s->head_stride];
        } else {
            const int16_t* chunk = stream + (size_t)g.t * a.coeffs + a.off + ch * (1 + 3 * n);
            q = chunk[0];
            lrow = ll + (size_t)g.t * a.ll_stride + ((size_t)ch * y.n + gr) * tw;
            crow = chunk + 1 + (size_t)gr * tw;
            qs = n;
        }
        auto dq = [&](int v) -> int16_t { return (int16_t)(q > 1 ? v * q : v); };
        int16_t* e = p + ch * plane + 2 * i * pitch;
        for (int j = lane; j < npc; j += 32) {
            const int gc = x.pair(j);
            e[2 * j] = lrow[gc];
            e[pitch + 2 * j] = dq(crow[gc]);               // C
            e[2 * j + 1] = dq(crow[qs + gc]);              // B
            e[pitch + 2 * j + 1] = dq(crow[2 * qs + gc]);  // D
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
    if (SHARDS || !a.u8) {
        // the plane's rows [o0, o0 + rows): all of them, or (SHARDS) the
        // output's
        const int o0 = SHARDS ? 2 * s->out_p0 : 0, rows = SHARDS ? s->out_len : h;
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

// The whole-plane kernels (lift_level / unlift_level) and K7's shard-table
// ones (lift_level_shards / unlift_level_shards): one body each way, the
// tables a compile-time choice, so the whole-plane kernels read none of
// them.
template <int WAV>
__global__ void __launch_bounds__(kThreads)
    lift_level(const LevelArgs a, const void* __restrict__ src, int16_t* stream, int16_t* ll) {
    lift_body<WAV, false>(a, nullptr, src, stream, ll);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    lift_level_shards(const LevelArgs a, const __grid_constant__ ShardArgs s, int16_t* stream,
                      int16_t* ll) {
    lift_body<WAV, true>(a, &s, nullptr, stream, ll);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    unlift_level(const LevelArgs a, const int16_t* ll, const int16_t* stream, void* __restrict__ dst) {
    unlift_body<WAV, false>(a, nullptr, ll, stream, dst);
}

template <int WAV>
__global__ void __launch_bounds__(kThreads)
    unlift_level_shards(const LevelArgs a, const __grid_constant__ ShardArgs s,
                        void* __restrict__ dst) {
    unlift_body<WAV, true>(a, &s, nullptr, nullptr, dst);
}

// The grid (one CTA per tile and region), or -1 for arguments beyond the
// kernel's limits. The shared-memory layout is the caller's (level_layout);
// this checks only that its buffers lie in the bytes the launch asks for,
// aligned for the 16-byte copies, and that those fit a block.
long long level_grid(const LevelArgs& a, int tiles, bool stage) {
    if (a.channels < 1 || a.channels > kLevelChannels || a.height < 1 || a.width < 1 ||
        a.rh < 1 || a.rw < 1 || a.pitch < 1 || tiles < 1 || a.wavelet < DD137 || a.wavelet > HAAR)
        return -1;
    const long long used = 2LL * a.channels * a.plane + (stage ? 2LL * kWarps * a.stage : 0);
    if ((a.pitch | a.plane) % 8 || (stage && a.stage % 16) || used > a.smem || a.smem > kMaxSmem)
        return -1;
    const long long grid = (long long)tiles * (((a.height + 1) / 2 + a.rh - 1) / a.rh) *
                           (((a.width + 1) / 2 + a.rw - 1) / a.rw);
    return grid > INT_MAX ? -1 : grid;
}

// K7's grid, with s.cta0 filled, or -1: int16 planes of one tile, 1 to
// kMaxShards non-empty shards in pair order inside the outputs' pairs, 1
// to kMaxSegs segments (the inverse's LL ones and its C, B, D ones both
// present), the inverse's q heads. That the segments hold every row the
// windows read is the caller's to check (ops/lift_kernels.py).
long long shard_grid(const LevelArgs& a, ShardArgs& s, bool inverse) {
    if (a.u8 || level_grid(a, 1, false) < 0 || s.shards < 1 || s.shards > kMaxShards ||
        s.segs < 1 || s.segs > kMaxSegs || s.out_p0 < 0 || s.out_len < 1 ||
        (inverse ? s.lls < 1 || s.lls >= s.segs || !s.heads : s.lls != 0))
        return -1;
    const int n = (a.height + 1) / 2, nx = ((a.width + 1) / 2 + a.rw - 1) / a.rw;
    long long ctas = 0;
    for (int i = 0; i < s.shards; ++i) {
        const int p0 = s.p0[i], p1 = s.p1[i];
        const bool out = inverse ? 2 * p0 < 2 * s.out_p0 || min(2 * p1, a.height) > 2 * s.out_p0 + s.out_len
                                 : p0 < s.out_p0 || p1 > s.out_p0 + s.out_len;
        if (p0 < (i ? s.p1[i - 1] : 0) || p1 <= p0 || p1 > n || out) return -1;
        s.cta0[i] = (int)ctas;
        ctas += (long long)((p1 - p0 + a.rh - 1) / a.rh) * nx;
        if (ctas > INT_MAX) return -1;
    }
    s.cta0[s.shards] = (int)ctas;
    for (int i = 0; i < s.segs; ++i)
        if (!s.seg[i].base || s.seg[i].r0 >= s.seg[i].r1 || s.seg[i].pitch < 1) return -1;
    return ctas;
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
    const long long grid = level_grid(a, tiles, a.u8);
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
    const long long grid = level_grid(a, tiles, false);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(unlift_level<DD137>, grid, a.smem, s, a, ll, coeffs, dst);
        case CDF53: return launch(unlift_level<CDF53>, grid, a.smem, s, a, ll, coeffs, dst);
        default: return launch(unlift_level<HAAR>, grid, a.smem, s, a, ll, coeffs, dst);
    }
}

// K7, one launch over a device's shards of a level (one tile). Forward:
// rows from the segments of `shards` (the plane's rows); the launch writes
// the q heads and C, B, D of its shards' pairs to out, (channels, 1 + 3
// out_len tw) int16 in stream layout of pairs [out_p0, out_p0 + out_len),
// and their LL to ll, (channels, out_len, tw). Inverse: the LL and C, B, D
// rows of the pairs from the segments and the q heads -> dst, the plane's
// rows [2 out_p0, 2 out_p0 + out_len), (channels, out_len, width) int16.
// `shards` is copied: the launcher fills its CTA counts.
extern "C" int ako_lift_level_shards(const LevelArgs* args, const ShardArgs* shards, int16_t* out,
                                     int16_t* ll, void* stream) {
    const LevelArgs& a = *args;
    ShardArgs t = *shards;
    const long long grid = shard_grid(a, t, false);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(lift_level_shards<DD137>, grid, a.smem, s, a, t, out, ll);
        case CDF53: return launch(lift_level_shards<CDF53>, grid, a.smem, s, a, t, out, ll);
        default: return launch(lift_level_shards<HAAR>, grid, a.smem, s, a, t, out, ll);
    }
}

extern "C" int ako_unlift_level_shards(const LevelArgs* args, const ShardArgs* shards,
                                       int16_t* dst, void* stream) {
    const LevelArgs& a = *args;
    ShardArgs t = *shards;
    const long long grid = shard_grid(a, t, true);
    if (grid < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (a.wavelet) {
        case DD137: return launch(unlift_level_shards<DD137>, grid, a.smem, s, a, t, (void*)dst);
        case CDF53: return launch(unlift_level_shards<CDF53>, grid, a.smem, s, a, t, (void*)dst);
        default: return launch(unlift_level_shards<HAAR>, grid, a.smem, s, a, t, (void*)dst);
    }
}
