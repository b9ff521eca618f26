// Block-parallel Kagari decode for Hopper (sm_90a): kernel K4.
//
// Replaces ako_tpu/ops/kagari_device.py:kagari_decode_device (:569,
// an XLA program: a DECODE_BLOCK-step lax.scan over all blocks, vmapped
// over tiles) and computes what the plain version in
// ako_tpu_torch/ops/kagari_device.py computes. A host scan
// (akort_kagari_sync) gives every block of kBlock outputs (a lane) its
// bit offset and carry state (prev value, consec counter or the
// SYNC_FIRST sentinel, remaining run), so each (tile, lane) decodes on
// its own, step for step as kagari_device.py:626-647 (and the reference
// decoder, library/kagari.c:301-366): per output, either one repeat of
// the pending run, or a literal gamma code, followed by a run-length
// code when the literal is the third equal value in a row.
//
// What bounds it: latency. Each lane is a chain of kBlock dependent
// steps (a gamma decode needs the cursor the previous one left); the
// bytes are small (the compressed stream read about once, 2 B written
// per output). The design keeps that chain off device memory:
//   - a CTA takes kLanes consecutive lanes of one tile, one thread each,
//     and first copies the pool words they read, [bit_off[first] >> 5,
//     (bit_off[last + 1] >> 5) + 2), into shared memory with cp.async
//     (coalesced), while its threads load their sync records (coalesced);
//   - each thread then decodes its lane from a register window (two
//     words and a cursor, read with a funnel shift) refilled from shared
//     memory, gamma lengths from __clz, one path for every lane at each
//     step (a run's repeat consumes nothing), into a shared-memory
//     output tile: lane l's output i at
//     word l * kBlock / 2 + ((i >> 1) ^ (l & 31)), so that the 32 lanes
//     of a warp write 32 banks at each step;
//   - the CTA stores its outputs, consecutive in the output row, with
//     16-byte coalesced stores (2-byte ones at unaligned ends).
// A span over kSpanWords (high-entropy lossless streams reach it) is
// not staged: that CTA's windows read the pool (the route of the first
// K4 port); ops/kagari_device.py decode_cta_spans mirrors the choice.
// The two routes are two instantiations of one lane decoder, so the
// staged route's refills never wait on device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTrigger = 2;          // RLE_TRIGGER
constexpr int kSyncFirst = 0xFFFF;   // SYNC_FIRST
constexpr int kBlock = 128;          // DECODE_BLOCK: outputs per lane
constexpr int kLanes = 64;           // K4_LANES: lanes (threads) per CTA
constexpr int kSpanWords = 4096;     // K4_SPAN_WORDS: staged words per CTA (16 KB)
constexpr int kSlackWords = 2;       // DECODE_SLACK_WORDS after the pool's last payload
constexpr int kOutWords = kLanes * kBlock / 2;

// Where a window refills from, by word index relative to the CTA's span
// start s0: the span staged in shared memory (an index past it, which
// exact sync records never give, reads its last word), or the pool.
struct StagedWords {
    const uint32_t* words;
    unsigned last;  // index of the span's last word
    __device__ __forceinline__ uint32_t operator()(int r) const {
        return words[min((unsigned)r, last)];
    }
};

struct PoolWords {
    const uint32_t* pool;
    long long s0;
    long long last;  // index of the pool's last word
    __device__ __forceinline__ uint32_t operator()(int r) const {
        const long long i = s0 + r;
        return __ldg(pool + (i < last ? i : last));
    }
};

template <typename Words>
struct Window {
    Words words;
    int ptr;  // index of hi, relative to s0
    uint32_t hi, lo;
    int cur;  // bit cursor in hi, 0..31

    __device__ __forceinline__ void start(int p, int c) {
        ptr = p;
        cur = c;
        hi = words(p);
        lo = words(p + 1);
    }

    // Elias-gamma code at the cursor: returns the value, sets *len.
    // Codes are <= 31 bits (longer ones stay on the host).
    __device__ __forceinline__ uint32_t peek(int* len) const {
        const uint32_t top = __funnelshift_l(lo, hi, cur);  // hi:lo << cur, high word
        const int z = min(__clz(top), 15);
        *len = 2 * z + 1;
        return top >> (32 - *len);
    }

    __device__ __forceinline__ void consume(int n) {
        cur += n;
        if (cur >= 32) {
            cur -= 32;
            ++ptr;
            hi = lo;
            lo = words(ptr + 1);
        }
    }
};

// Gamma value -> int16: (u - 1) & 0xFFFF, then zigzag decode.
__device__ __forceinline__ int unzigzag(uint32_t u) {
    const uint32_t q = (u - 1u) & 0xFFFFu;
    return (int)(int16_t)(uint16_t)((q >> 1) ^ ((q & 1u) * 0xFFFFu));
}

// The shared-memory output tile's int16 slot of lane l's output i.
__device__ __forceinline__ int out_slot(int l, int i) {
    return ((l * (kBlock / 2) + ((i >> 1) ^ (l & 31))) << 1) | (i & 1);
}

// One lane's `count` outputs from its sync record (window at word p,
// bit c, relative to s0) into the output tile's row `lane`. Every step
// peeks a literal; a lane with a pending run consumes nothing and
// repeats its value, so the warp's lanes take one path at each step.
template <typename Words>
__device__ __forceinline__ void decode_lane(Words words, int p, int c, int prev, int consec,
                                            int runrem, int count, uint16_t* out16, int lane) {
    Window<Words> win{words};
    win.start(p, c);
    for (int i = 0; i < count; ++i) {
        int len;
        const uint32_t u = win.peek(&len);
        const bool lit = runrem == 0;
        const int v = lit ? unzigzag(u) : prev;
        win.consume(lit ? len : 0);
        const bool eq = consec != kSyncFirst && v == prev;
        consec = lit ? (eq ? consec + 1 : 0) : consec;
        runrem = lit ? 0 : runrem - 1;
        prev = v;
        out16[out_slot(lane, i)] = (uint16_t)v;
        if (lit && consec == kTrigger) {  // run-length code after the third equal literal
            const uint32_t u2 = win.peek(&len);
            win.consume(len);
            runrem = (int)((u2 - 1u) & 0xFFFFu);
            consec = 0;
        }
    }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__global__ void __launch_bounds__(kLanes)
kagari_decode(const uint32_t* __restrict__ pool, long long pool_words,
              const int* __restrict__ base, const uint32_t* __restrict__ bit_off,
              const int* __restrict__ prev0, const int* __restrict__ consec0,
              const int* __restrict__ run0, int16_t* __restrict__ out, int tiles, int blocks,
              int n_outputs) {
    __shared__ uint32_t staged[kSpanWords];
    __shared__ uint32_t outw[kOutWords];
    uint16_t* out16 = reinterpret_cast<uint16_t*>(outw);

    const int per_tile = (blocks + kLanes - 1) / kLanes;
    const int t = blockIdx.x / per_tile;
    const int first = (blockIdx.x % per_tile) * kLanes;
    const int lanes = min(kLanes, blocks - first);
    const long long rec0 = (long long)t * blocks + first;

    // the CTA's word span (decode_cta_spans in ops/kagari_device.py)
    const long long tile0 = base[t];
    const long long s0 = tile0 + (bit_off[rec0] >> 5);
    long long s1;
    if (first + lanes < blocks) {
        s1 = tile0 + (bit_off[rec0 + lanes] >> 5) + 2;
    } else {
        const long long next = t + 1 < tiles ? (long long)base[t + 1] : pool_words - kSlackWords;
        s1 = next + 2;
    }
    s1 = min(s1, pool_words);
    const long long span = s1 - s0;
    const int n_staged = (span > 0 && span <= kSpanWords) ? (int)span : 0;
    for (int k = threadIdx.x; k < n_staged; k += kLanes) cp_async4(staged + k, pool + s0 + k);
    asm volatile("cp.async.commit_group;\n" ::);

    // the sync records, coalesced, while the copy is in flight
    const int tid = threadIdx.x;
    const bool active = tid < lanes;
    const long long rec = rec0 + tid;
    const uint32_t boff = active ? bit_off[rec] : 0u;
    const int prev = active ? prev0[rec] : 0;
    const int consec = active ? consec0[rec] & 0xFFFF : 0;
    const int runrem = active ? run0[rec] & 0xFFFF : 0;

    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    if (active) {
        const int p = (int)(tile0 + (boff >> 5) - s0), c = (int)(boff & 31u);
        const int count = min(kBlock, n_outputs - (first + tid) * kBlock);
        if (n_staged)
            decode_lane(StagedWords{staged, (unsigned)(n_staged - 1)}, p, c, prev, consec, runrem,
                        count, out16, tid);
        else
            decode_lane(PoolWords{pool, s0, pool_words - 1}, p, c, prev, consec, runrem, count,
                        out16, tid);
    }
    __syncthreads();

    // the CTA's outputs are out[g0, g0 + count) of the flat (tiles,
    // n_outputs) tensor: 16-byte stores on 8-element boundaries
    const long long g0 = (long long)t * n_outputs + (long long)first * kBlock;
    const long long count = min((long long)lanes * kBlock, (long long)n_outputs - (long long)first * kBlock);
    const long long g1 = g0 + count;
    for (long long v = (g0 & ~7LL) + 8LL * tid; v < g1; v += 8LL * kLanes) {
        uint16_t e[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const long long r = v + q - g0;
            e[q] = (r >= 0 && r < count) ? out16[out_slot((int)(r >> 7), (int)(r & 127))] : 0;
        }
        if (v >= g0 && v + 8 <= g1) {
            uint4 w;
            w.x = e[0] | ((uint32_t)e[1] << 16);
            w.y = e[2] | ((uint32_t)e[3] << 16);
            w.z = e[4] | ((uint32_t)e[5] << 16);
            w.w = e[6] | ((uint32_t)e[7] << 16);
            *reinterpret_cast<uint4*>(out + v) = w;
        } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
                if (v + q >= g0 && v + q < g1) out[v + q] = (int16_t)e[q];
        }
    }
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// pool: (pool_words,) big-endian-bit 32-bit words of every tile's
// payload, tile t starting at word base[t], DECODE_SLACK_WORDS zero
// words after the last; bit_off, prev, consec, run: (tiles, blocks) sync
// records of `block` outputs each (block must be DECODE_BLOCK); out:
// (tiles, n_outputs) int16, 16-byte aligned. Returns cudaGetLastError()
// after the launch. Runs on `stream` and does not synchronise.
extern "C" int ako_kagari_decode(const uint32_t* pool, long long pool_words, const int* base,
                                 const uint32_t* bit_off, const int* prev, const int* consec,
                                 const int* run, int16_t* out, int tiles, int blocks,
                                 int n_outputs, int block, void* stream) {
    if (block != kBlock || pool_words < 1) return (int)cudaErrorInvalidValue;
    if (tiles == 0 || blocks == 0) return 0;
    const long long grid = (long long)tiles * ((blocks + kLanes - 1) / kLanes);
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kagari_decode<<<(unsigned)grid, kLanes, 0, (cudaStream_t)stream>>>(
        pool, pool_words, base, bit_off, prev, consec, run, out, tiles, blocks, n_outputs);
    return (int)cudaGetLastError();
}
