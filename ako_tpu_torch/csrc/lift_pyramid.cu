// A tile's whole lift pyramid in one launch, forward and inverse, for
// Hopper (sm_90a).
//
// Replaces, on the fused wiring, the TPU kernels of
// ako_tpu/ops/pallas_lift.py and the XLA ops around them:
//   lift_pyramid   <- _lift2d_kernel (pallas_lift.py:90) on every level
//                     from `start` on, with colorspace.to_planar_yuv at
//                     level 0 and lifting.forward_tile's quantize/gate
//                     and wire order (ako_tpu/ops/lifting.py:35-84)
//   unlift_pyramid <- _unlift2d_kernel (pallas_lift.py:184) on the same
//                     levels, with inverse_tile's dequantize
//                     (lifting.py:87-132) and, when the launch ends at
//                     level 0, colorspace.to_interleaved_u8
// The lifting steps are those of lift2d.cu (Haar, CDF 5/3, DD 13/7, the
// four wrap rules of tap(), the fake odd last row / column, an int16
// wrap at every store), computed in place as the reference does.
//
// What bounds it: latency, not bytes. The work is a few dozen integer
// operations per coefficient and the bytes are the u8 tile in and the
// int16 stream out once (5.2 MB + 10.5 MB per north-star image, about
// 5 us at 3.35 TB/s). The per-level kernels of lift2d.cu spend two
// launches and a device-memory round trip per level, with grids of a few
// hundred threads on the small levels. Here one block holds its channel's
// plane in dynamic shared memory for all levels, and what is left is
// each thread's serial chain of dependent shared-memory loads and integer
// operations between the level's barriers:
// - Level s of the launch sits at stride 2^s in the plane of level 0:
//   sample (r, c) at p[(r << s) * pitch + (c << s)]. A level lifts in
//   place, along the rows then along the columns, each as a predict step
//   (the odd slots become high-pass), __syncthreads, and an update step
//   (the even slots become low-pass), so every tap is read once from
//   shared memory and none is recomputed. Afterwards LL is at the even
//   (row, column) slots, which are the next level's samples, and C, B, D
//   at the odd ones. The fake odd row / column of an odd side lives in
//   the padding (rows x pitch covers every level's last odd slot).
// - One block of 512 threads per (tile, channel) plane both ways. Each
//   thread walks its items without an integer division (Walk, udiv); on
//   lines of 32 pairs or more the pairs inside read their taps directly
//   and only the two pairs at each end run the wrap rules, with
//   unconditional loads; the quantize divides by a multiply-high
//   (Divider). 32 KB of plane (plus 8 KB of u8 staging forward) at
//   128x128, so the north star's 320 planes are resident at once on the
//   132 SMs.
// - Forward: level 0 reads the u8 tile rows with 16-byte loads into a
//   per-warp staging row and computes the block's channel of the colour
//   transform; each level's C, B, D go straight from shared memory to
//   their wire offsets, gated and divided by the level's and channel's q,
//   beside the int16 q head; the LP plane is stored last.
// - Inverse: each level loads C, B, D with the q > 1 int16-wrapping
//   multiply applied as it loads, then unlifts in place (the update step
//   undone, then the predict step, columns then rows). The inverse colour
//   transform needs every channel of a pixel, so a tile's channel blocks
//   form a thread-block cluster (cudaLaunchKernelEx, cluster size =
//   channels, at most 8): after a cluster barrier each block reads its
//   share of the tile's rows from all the channels' planes through
//   distributed shared memory and stores them as saturated interleaved
//   u8. Chosen over one block per tile holding every channel, which at
//   128 KB a block kept 80 blocks on 80 SMs, each thread with four times
//   the serial work.
// The per-level q/g, wavelets and offsets are a struct passed by value
// (PyramidArgs, the kernel's parameter space): no device table per call.
// The lifting steps (lift_step), the colour transforms and the quantizer
// are lift_common.cuh's, shared with lift_level.cu. Planes too large for
// a block start at a later level (ops/lift_kernels.py pyramid_start); the
// levels before it run one lift_level / unlift_level launch each
// (lift_level.cu).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lift_common.cuh"

constexpr int kMaxLevels = 16;
constexpr int kMaxChannels = 16;

// Mirrors kernels.PyramidArgs (ctypes); all ints, so no padding. Outside
// the anonymous namespace: the exported functions take it, and a type
// with internal linkage would make them local symbols.
struct PyramidArgs {
    int levels;    // lift levels in this launch
    int channels;
    int height;    // the launch's plane (the tile at level 0)
    int width;
    int rows;      // shared-memory plane: rows x pitch int16
    int pitch;
    int coeffs;    // elements of one tile's stream
    int wrap;
    int color;     // colour transform, when u8
    int discard;   // discard non-visible, when u8
    int u8;        // forward: the input is u8 tiles; inverse: the output is
    int wavelet[kMaxLevels];  // effective wavelet per level of the launch
    int off[kMaxLevels];      // level chunk offset in a tile's stream
    int q[kMaxLevels][kMaxChannels];
    int g[kMaxLevels][kMaxChannels];
};

namespace {

using namespace ako;
namespace cg = cooperative_groups;

constexpr int kFwdThreads = 512;
constexpr int kInvThreads = 512;
constexpr int kMaxCluster = 8;  // portable thread-block cluster size
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

// floor(a / b) for 0 <= a < 2^20 and 1 <= b < 2^20: the reciprocal and
// the product rounded toward zero fall short of a / b by less than one,
// so one step up corrects it; cheaper than the integer division.
__device__ __forceinline__ int udiv(int a, int b) {
    int q = __float2int_rz(__fmul_rz((float)a, __frcp_rz((float)b)));
    if ((q + 1) * b <= a) ++q;
    return q;
}

// This thread's items threadIdx.x, + blockDim.x, ... of a row-major
// (planes, rows, cols) range as (p, r, c), advanced without a division
// per item (one at the start, one when a plane is crossed). rows and
// cols must be at least 1: udiv divides by them, and an empty range
// would walk on forever. Every range here is non-empty by construction
// but the inverse's colour store, which checks first. (A branch-free
// guard in here cost 3-5% of both kernels: it runs twice per step.)
struct Walk {
    int p, r, c;
    const int rows, cols, dr, dc;
    __device__ __forceinline__ Walk(int rows_, int cols_)
        : rows(rows_), cols(cols_), dr(udiv(blockDim.x, cols_)), dc(blockDim.x - dr * cols_) {
        const int row = udiv(threadIdx.x, cols);
        c = threadIdx.x - row * cols;
        p = udiv(row, rows);
        r = row - p * rows;
    }
    __device__ __forceinline__ void next() {
        r += dr;
        c += dc;
        if (c >= cols) {
            c -= cols;
            ++r;
        }
        if (r >= rows) {
            const int q = udiv(r, rows);
            p += q;
            r -= q * rows;
        }
    }
};

// One step on every line of `planes` planes (plane_size apart): `lines`
// lines line_stride apart. ROWS: consecutive threads take consecutive
// pairs of a row; else consecutive columns at one pair, so a warp reads
// neighbouring addresses either way. Ends with __syncthreads.
template <int WAV, int KIND, bool ROWS>
__device__ void step_all(int16_t* p, int planes, int plane_size, int lines, int line_stride,
                         int step, int n, int n_real, int wrap) {
    // on lines of 32 pairs or more, pairs 2 .. n-3 take every tap from
    // the line and pairs 0, 1, n-2, n-1 apply the edge rules; on shorter
    // lines every pair does (one walk per step costs less there)
    const int inner = n >= 32 ? n - 4 : 0, edges = n - inner;
    if (inner > 0) {
        for (Walk it(ROWS ? lines : inner, ROWS ? inner : lines); it.p < planes; it.next()) {
            const int line = ROWS ? it.r : it.c, k = 2 + (ROWS ? it.c : it.r);
            lift_step<WAV, KIND, false>(p + it.p * plane_size + line * line_stride, step, k, n,
                                        n_real, wrap);
        }
    }
    for (Walk it(ROWS ? lines : edges, ROWS ? edges : lines); it.p < planes; it.next()) {
        const int line = ROWS ? it.r : it.c, j = ROWS ? it.c : it.r;
        const int k = j < 2 ? j : j + inner;
        lift_step<WAV, KIND, true>(p + it.p * plane_size + line * line_stride, step, k, n, n_real,
                                   wrap);
    }
    __syncthreads();
}

// Forward level s of an (h, w) plane: rows, then the 2*tw columns.
template <int WAV>
__device__ void fwd_level(int16_t* p, int pitch, int wrap, int s, int h, int w) {
    const int th = (h + 1) / 2, tw = (w + 1) / 2, rs = pitch << s;
    step_all<WAV, PREDICT, true>(p, 1, 0, h, rs, 1 << s, tw, w / 2, wrap);
    step_all<WAV, UPDATE, true>(p, 1, 0, h, rs, 1 << s, tw, w / 2, wrap);
    step_all<WAV, PREDICT, false>(p, 1, 0, 2 * tw, 1 << s, rs, th, h / 2, wrap);
    step_all<WAV, UPDATE, false>(p, 1, 0, 2 * tw, 1 << s, rs, th, h / 2, wrap);
}

// Inverse level s of all planes: the columns, then the rows of the (h, w)
// plane (the fake last row is not unlifted: it is dropped).
template <int WAV>
__device__ void inv_level(int16_t* p, int planes, int plane_size, int pitch, int wrap, int s,
                          int h, int w) {
    const int th = (h + 1) / 2, tw = (w + 1) / 2, rs = pitch << s;
    step_all<WAV, UNDO_UPDATE, false>(p, planes, plane_size, 2 * tw, 1 << s, rs, th, h / 2, wrap);
    step_all<WAV, UNDO_PREDICT, false>(p, planes, plane_size, 2 * tw, 1 << s, rs, th, h / 2, wrap);
    step_all<WAV, UNDO_UPDATE, true>(p, planes, plane_size, h, rs, 1 << s, tw, w / 2, wrap);
    step_all<WAV, UNDO_PREDICT, true>(p, planes, plane_size, h, rs, 1 << s, tw, w / 2, wrap);
}

__device__ __forceinline__ int level_dim(int d, int s) { return (d + (1 << s) - 1) >> s; }

__global__ void __launch_bounds__(kFwdThreads)
    lift_pyramid(const PyramidArgs a, const void* __restrict__ src, int16_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    int16_t* p = reinterpret_cast<int16_t*>(smem);
    const int C = a.channels, h = a.height, w = a.width;
    const int t = blockIdx.x / C, ch = blockIdx.x - t * C;

    if (a.u8) {
        // per-warp staging row of the u8 tile, 16-byte aligned
        const int row_bytes = w * C, stage = (row_bytes + 15) & ~15;
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
        unsigned char* st = smem + ((a.rows * a.pitch * 2 + 15) & ~15) + warp * stage;
        const uint8_t* tile = static_cast<const uint8_t*>(src) + (size_t)t * h * row_bytes;
        for (int r = warp; r < h; r += warps) {
            const uint8_t* row = tile + (size_t)r * row_bytes;
            if ((((uintptr_t)row | row_bytes) & 15) == 0) {
                for (int v = lane; v < row_bytes / 16; v += 32)
                    reinterpret_cast<uint4*>(st)[v] = __ldg(reinterpret_cast<const uint4*>(row) + v);
            } else {
                for (int v = lane; v < row_bytes; v += 32) st[v] = __ldg(row + v);
            }
            __syncwarp();
            for (int c = lane; c < w; c += 32)
                p[r * a.pitch + c] = (int16_t)colour_fwd(st + c * C, C, ch, a.color, a.discard);
            __syncwarp();
        }
    } else {
        const int16_t* x = static_cast<const int16_t*>(src) + ((size_t)t * C + ch) * h * w;
        for (Walk it(h, w); it.p < 1; it.next()) p[it.r * a.pitch + it.c] = x[it.r * w + it.c];
    }
    __syncthreads();

    int16_t* stream = out + (size_t)t * a.coeffs;
    for (int s = 0; s < a.levels; ++s) {
        const int cur_h = level_dim(h, s), cur_w = level_dim(w, s);
        switch (a.wavelet[s]) {
            case DD137: fwd_level<DD137>(p, a.pitch, a.wrap, s, cur_h, cur_w); break;
            case CDF53: fwd_level<CDF53>(p, a.pitch, a.wrap, s, cur_h, cur_w); break;
            default: fwd_level<HAAR>(p, a.pitch, a.wrap, s, cur_h, cur_w); break;
        }
        // C, B, D at the odd slots -> [q head][C][B][D] of this channel.
        // The next level writes only even slots, so no barrier follows.
        const int th = (cur_h + 1) / 2, tw = (cur_w + 1) / 2, n = th * tw;
        const int q = a.q[s][ch], g = a.g[s][ch], rs = a.pitch << s;
        const Divider div(max(q, 1));
        auto quant = [&](int x) -> int16_t { return (int16_t)((x < -g || x > g) ? div(x) : 0); };
        int16_t* dst = stream + a.off[s] + ch * (1 + 3 * n);
        if (threadIdx.x == 0) dst[0] = (int16_t)q;
        for (Walk it(th, tw); it.p < 1; it.next()) {
            int16_t* o = dst + 1 + it.r * tw + it.c;
            const int16_t* e = p + 2 * it.r * rs + ((2 * it.c) << s);
            o[0] = quant(e[rs]);              // C
            o[n] = quant(e[1 << s]);          // B
            o[2 * n] = quant(e[rs + (1 << s)]);  // D
        }
    }

    const int L = a.levels, lp_h = level_dim(h, L), lp_w = level_dim(w, L);
    int16_t* lp = stream + ch * lp_h * lp_w;
    for (Walk it(lp_h, lp_w); it.p < 1; it.next())
        lp[it.r * lp_w + it.c] = p[it.r * (a.pitch << L) + (it.c << L)];
}

__global__ void __launch_bounds__(kInvThreads)
    unlift_pyramid(const PyramidArgs a, const int16_t* __restrict__ coeffs, void* __restrict__ dst) {
    extern __shared__ __align__(16) unsigned char smem[];
    int16_t* p = reinterpret_cast<int16_t*>(smem);
    const int C = a.channels, h = a.height, w = a.width, L = a.levels;
    const int t = blockIdx.x / C, ch = blockIdx.x - t * C;  // ch is the block's rank in its cluster
    const int16_t* stream = coeffs + (size_t)t * a.coeffs;

    // the channel's LP plane (channel-major at the head of the stream), at stride 2^L
    const int lp_h = level_dim(h, L), lp_w = level_dim(w, L);
    for (Walk it(lp_h, lp_w); it.p < 1; it.next())
        p[it.r * (a.pitch << L) + (it.c << L)] = stream[(ch * lp_h + it.r) * lp_w + it.c];

    for (int s = L - 1; s >= 0; --s) {
        const int cur_h = level_dim(h, s), cur_w = level_dim(w, s);
        const int th = (cur_h + 1) / 2, tw = (cur_w + 1) / 2, n = th * tw, rs = a.pitch << s;
        const int16_t* src = stream + a.off[s] + ch * (1 + 3 * n);
        const int q = src[0];
        for (Walk it(th, tw); it.p < 1; it.next()) {
            const int k = it.r * tw + it.c;
            int16_t* e = p + 2 * it.r * rs + ((2 * it.c) << s);
            int16_t* slot[3] = {e + rs, e + (1 << s), e + rs + (1 << s)};  // C, B, D
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                const int x = src[1 + m * n + k];
                *slot[m] = (int16_t)(q > 1 ? x * q : x);
            }
        }
        __syncthreads();
        switch (a.wavelet[s]) {
            case DD137: inv_level<DD137>(p, 1, 0, a.pitch, a.wrap, s, cur_h, cur_w); break;
            case CDF53: inv_level<CDF53>(p, 1, 0, a.pitch, a.wrap, s, cur_h, cur_w); break;
            default: inv_level<HAAR>(p, 1, 0, a.pitch, a.wrap, s, cur_h, cur_w); break;
        }
    }
    __syncthreads();  // a launch with no level stores what it loaded

    if (!a.u8) {
        int16_t* out = static_cast<int16_t*>(dst) + ((size_t)t * C + ch) * h * w;
        for (Walk it(h, w); it.p < 1; it.next()) out[it.r * w + it.c] = p[it.r * a.pitch + it.c];
        return;
    }
    // inverse colour + saturation (ops/colorspace.py to_interleaved_u8):
    // the block stores rows [r0, r1) of the tile, reading every channel's
    // plane from its block's shared memory in the cluster. A tile with
    // fewer rows than channels (an image's edge row of tiles) leaves some
    // blocks no row: they skip the walk, which takes no empty range, but
    // still take part in both cluster barriers.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every channel's plane is final
    const int r0 = ch * h / C, r1 = (ch + 1) * h / C;
    uint8_t* out = static_cast<uint8_t*>(dst) + (size_t)t * h * w * C;
    for (Walk it(max(r1 - r0, 1), w); r1 > r0 && it.p < 1; it.next()) {
        const int r = r0 + it.r, off = r * a.pitch + it.c, idx = r * w + it.c;
        auto val = [&](int k) -> int { return cluster.map_shared_rank(p, k)[off]; };
        uint8_t v[kMaxCluster];
        colour_inv(val, C, a.color, v);
        if (C == 4) {
            reinterpret_cast<uint32_t*>(out)[idx] =
                v[0] | (v[1] << 8) | (v[2] << 16) | ((uint32_t)v[3] << 24);
        } else {
            uint8_t* o = out + (size_t)idx * C;
            for (int k = 0; k < C; ++k) o[k] = v[k];
        }
    }
    cluster.sync();  // the other blocks may still read this block's plane
}

int plane_bytes(const PyramidArgs& a) { return (a.rows * a.pitch * 2 + 15) & ~15; }

int launch_checks(const PyramidArgs& a, int smem, const void* fn) {
    if (a.levels < 0 || a.levels > kMaxLevels || a.channels < 1 || a.channels > kMaxChannels ||
        smem > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return 0;
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// Forward: src is (tiles, height, width, channels) u8 when args->u8,
// else (tiles, channels, height, width) int16 planes; out is the
// (tiles, coeffs) int16 stream, of which the launch writes the LP planes
// and the levels' chunks. Inverse: coeffs (tiles, coeffs) int16 -> dst
// (tiles, height, width, channels) u8 when args->u8, else (tiles,
// channels, height, width) int16. Both return cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a table or plane beyond the
// limits), run on `stream` and do not synchronise. The shared-memory
// sizes are the ones ops/lift_kernels.py pyramid_smem computes.
extern "C" int ako_lift_pyramid(const PyramidArgs* args, const void* src, int16_t* out, int tiles,
                                void* stream) {
    const PyramidArgs& a = *args;
    const int smem = plane_bytes(a) + (a.u8 ? (kFwdThreads / 32) * ((a.width * a.channels + 15) & ~15) : 0);
    const int rc = launch_checks(a, smem, (const void*)lift_pyramid);
    if (rc != 0) return rc;
    lift_pyramid<<<tiles * a.channels, kFwdThreads, smem, (cudaStream_t)stream>>>(a, src, out);
    return (int)cudaGetLastError();
}

extern "C" int ako_unlift_pyramid(const PyramidArgs* args, const int16_t* coeffs, void* dst,
                                  int tiles, void* stream) {
    const PyramidArgs& a = *args;
    const int smem = plane_bytes(a);
    if (a.channels > kMaxCluster) return (int)cudaErrorInvalidValue;
    const int rc = launch_checks(a, smem, (const void*)unlift_pyramid);
    if (rc != 0) return rc;
    // one cluster per tile: its channels' blocks, rank = channel
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.channels;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * a.channels);
    cfg.blockDim = dim3(kInvThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, unlift_pyramid, a, coeffs, dst);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
