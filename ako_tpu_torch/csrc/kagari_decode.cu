// Block-parallel Kagari decode for Hopper (sm_90a): kernel K4.
//
// Replaces ako_tpu/ops/kagari_device.py:kagari_decode_device (:569,
// an XLA program: a DECODE_BLOCK-step lax.scan over all blocks, vmapped
// over tiles) and computes what the plain version in
// ako_tpu_torch/ops/kagari_device.py computes. A host scan
// (akort_kagari_sync) gives every block of `block` outputs its bit
// offset and carry state (prev value, consec counter or the SYNC_FIRST
// sentinel, remaining run), so each (tile, block) lane decodes on its
// own, step for step as kagari_device.py:626-647 (and the reference
// decoder, library/kagari.c:301-366): per output, either one repeat of
// the pending run, or a literal gamma code, followed by a run-length
// code when the literal is the third equal value in a row.
//
// What bounds it: latency. Each lane is a chain of `block` dependent
// steps (a gamma decode needs the cursor the previous one left), and
// the bytes are small (the compressed stream is read about once, 2 B
// written per output). So one thread owns one lane and keeps its bit
// window in registers: two 32-bit words (hi, lo) and a cursor, refilled
// one word at a time from the tile's word pool in device memory, which
// the lanes of a tile read in about the same places and so mostly from
// L2. Gamma lengths come from __clz. Neighbouring threads take
// neighbouring blocks of one tile. Staging the outputs through shared
// memory for coalesced stores is a later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTrigger = 2;          // RLE_TRIGGER
constexpr int kSyncFirst = 0xFFFF;   // SYNC_FIRST
constexpr int kThreads = 128;

struct Window {
    const uint32_t* pool;
    long long last;  // index of the pool's last word
    long long ptr;   // pool index of hi
    uint32_t hi, lo;
    int cur;  // bit cursor in hi, 0..31

    __device__ __forceinline__ uint32_t word(long long i) const {
        return __ldg(pool + (i < last ? i : last));
    }

    __device__ __forceinline__ void start(long long p, int c) {
        ptr = p;
        cur = c;
        hi = word(p);
        lo = word(p + 1);
    }

    // Elias-gamma code at the cursor: returns the value, sets *len.
    // Codes are <= 31 bits (longer ones stay on the host).
    __device__ __forceinline__ uint32_t peek(int* len) const {
        const uint32_t top = cur == 0 ? hi : (hi << cur) | (lo >> (32 - cur));
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
            lo = word(ptr + 1);
        }
    }
};

// Gamma value -> int16: (u - 1) & 0xFFFF, then zigzag decode.
__device__ __forceinline__ int unzigzag(uint32_t u) {
    const uint32_t q = (u - 1u) & 0xFFFFu;
    return (int)(int16_t)(uint16_t)((q >> 1) ^ ((q & 1u) * 0xFFFFu));
}

__global__ void kagari_decode(const uint32_t* __restrict__ pool, long long pool_words,
                              const int* __restrict__ base, const uint32_t* __restrict__ bit_off,
                              const int* __restrict__ prev0, const int* __restrict__ consec0,
                              const int* __restrict__ run0, int16_t* __restrict__ out, int tiles,
                              int blocks, int n_outputs, int block) {
    const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (lane >= (long long)tiles * blocks) return;
    const int t = (int)(lane / blocks);
    const int b = (int)(lane % blocks);
    const int begin = b * block;
    const int end = min(begin + block, n_outputs);

    const uint32_t boff = bit_off[lane];
    Window win{pool, pool_words - 1};
    win.start((long long)base[t] + (boff >> 5), (int)(boff & 31u));
    int prev = prev0[lane];
    int consec = consec0[lane] & 0xFFFF;
    int runrem = run0[lane] & 0xFFFF;

    int16_t* dst = out + (long long)t * n_outputs;
    for (int i = begin; i < end; ++i) {
        if (runrem > 0) {  // one repeat of the pending run
            --runrem;
            dst[i] = (int16_t)prev;
            continue;
        }
        int len;
        const int v = unzigzag(win.peek(&len));
        win.consume(len);
        const bool eq = consec != kSyncFirst && v == prev;
        consec = eq ? consec + 1 : 0;
        prev = v;
        dst[i] = (int16_t)v;
        if (consec == kTrigger) {  // run-length code after the third equal literal
            const uint32_t u2 = win.peek(&len);
            win.consume(len);
            runrem = (int)((u2 - 1u) & 0xFFFFu);
            consec = 0;
        }
    }
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// pool: (pool_words,) big-endian-bit 32-bit words of every tile's
// payload, tile t starting at word base[t]; bit_off, prev, consec, run:
// (tiles, blocks) sync records; out: (tiles, n_outputs) int16. Returns
// cudaGetLastError() after the launch. Runs on `stream` and does not
// synchronise.
extern "C" int ako_kagari_decode(const uint32_t* pool, long long pool_words, const int* base,
                                 const uint32_t* bit_off, const int* prev, const int* consec,
                                 const int* run, int16_t* out, int tiles, int blocks,
                                 int n_outputs, int block, void* stream) {
    const long long lanes = (long long)tiles * blocks;
    if (lanes == 0) return 0;
    const unsigned grid = (unsigned)((lanes + kThreads - 1) / kThreads);
    kagari_decode<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pool, pool_words, base, bit_off, prev, consec, run, out, tiles, blocks, n_outputs, block);
    return (int)cudaGetLastError();
}
