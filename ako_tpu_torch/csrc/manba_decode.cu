// Block-parallel Manbavaran (rANS) decode for Hopper (sm_90a): kernel K6d.
//
// Replaces ako_tpu/ops/manba_device.py:manba_decode_device (:96, an XLA
// program: a DECODE_BLOCK-step lax.scan over all blocks with two gathered
// word windows a lane, vmapped over tiles) and computes what the plain
// version in ako_tpu_torch/ops/manba_device.py computes, bit for bit with
// csrc/akort.c akort_manba_decode. A host scan (akort_manba_sync) gives
// every block of kBlock outputs (a lane) its rANS state x, the payload
// byte of its next rANS byte and the bit of its next extras bit, so each
// (tile, lane) decodes on its own, per output:
//   slot = x & 4095, the symbol s whose [cum, cum + f) holds it;
//   x = f * (x >> 12) + slot - cum, then at most two bytes refilled while
//   x < 2^23 and rANS bytes remain;
//   extra = the next s extras bits, code = (1 << s) + extra,
//   q = (code - 1) & 0xFFFF, value = unzigzag(q).
//
// What bounds it: latency. Each lane is a chain of kBlock dependent steps
// (the slot comes from the state the previous step left); the bytes are
// small (the payload read about once, 2 B written per output). So:
//   - a CTA takes kLanes consecutive lanes of one tile, one thread each,
//     and first builds the tile's slot table in shared memory: per
//     12-bit slot, s | f << 5 | (slot - cum) << 18, so the symbol, f and
//     the state's addend are one shared load on the chain (no 17-way
//     compare);
//   - each lane keeps two windows in registers, the rANS bytes and the
//     extras bits, each three pool words and a cursor (a funnel shift
//     reads 32 bits at the cursor); a word is loaded one word ahead of
//     its use, so the loads stay off the chain. A rANS window never
//     loads past the word of the payload's last rANS byte, and no window
//     loads past the pool's last word (its DECODE_SLACK_WORDS included);
//   - outputs go through a shared-memory tile (a lane's row padded by one
//     word, so a warp's 32 lanes write 32 banks at each step) to
//     coalesced stores, consecutive in the output row.
// A call is one launch and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 17;
constexpr int kBlock = 128;          // DECODE_BLOCK: outputs per lane
constexpr int kLanes = 64;           // K6D_LANES: lanes (threads) per CTA
constexpr int kProbBits = 12;
constexpr int kSlots = 1 << kProbBits;
constexpr uint32_t kStateLo = 1u << 23;
constexpr int kRowPad = kBlock + 2;  // int16 a lane's output row: 65 words

// Three words of a bit stream in registers and a cursor in the first.
struct Window {
    const uint32_t* pool;
    long long next;  // pool index of the next word to load
    long long last;  // the last pool index it may load
    uint32_t w0, w1, w2;
    uint32_t cur;    // bit cursor in w0, 0..31

    __device__ __forceinline__ uint32_t load() {
        const uint32_t v = __ldg(pool + (next < last ? next : last));
        ++next;
        return v;
    }
    __device__ __forceinline__ void start(const uint32_t* p, unsigned long long bit,
                                          long long lim) {
        pool = p;
        last = lim;
        next = (long long)(bit >> 5);
        cur = (uint32_t)(bit & 31);
        w0 = load();
        w1 = load();
        w2 = load();
    }
    // the 32 bits at the cursor
    __device__ __forceinline__ uint32_t top() const { return __funnelshift_l(w1, w0, cur); }
    // bits <= 32 consumed
    __device__ __forceinline__ void advance(uint32_t bits) {
        cur += bits;
        if (cur >= 32) {
            cur -= 32;
            w0 = w1;
            w1 = w2;
            w2 = load();
        }
    }
};

__global__ void __launch_bounds__(kLanes)
manba_decode(const uint32_t* __restrict__ pool, long long pool_words, const int* __restrict__ base,
             const uint32_t* __restrict__ rans_end, const uint32_t* __restrict__ extras_off,
             const uint32_t* __restrict__ x0, const uint32_t* __restrict__ rbyte,
             const uint32_t* __restrict__ ebit, const int* __restrict__ freq,
             int16_t* __restrict__ out, int blocks, int n) {
    __shared__ uint32_t table[kSlots];
    __shared__ uint32_t cum[kSyms + 1];
    __shared__ int16_t tile_out[kLanes * kRowPad];
    const int per = (blocks + kLanes - 1) / kLanes;
    const int tile = blockIdx.x / per, first = (blockIdx.x % per) * kLanes;
    const int tid = threadIdx.x;

    if (tid == 0) {
        uint32_t c = 0;
        for (int s = 0; s < kSyms; ++s) {
            cum[s] = c;
            c += (uint32_t)freq[tile * kSyms + s];
        }
        cum[kSyms] = c;
    }
    __syncthreads();
    for (int slot = tid; slot < kSlots; slot += kLanes) {
        int s = 0;
#pragma unroll
        for (int k = 1; k < kSyms; ++k) s += cum[k] <= (uint32_t)slot;
        table[slot] = (uint32_t)s | ((cum[s + 1] - cum[s]) << 5) | (((uint32_t)slot - cum[s]) << 18);
    }
    __syncthreads();

    const int lane = first + tid;
    const int lanes = min(kLanes, blocks - first);
    if (lane < blocks) {
        const long long b = base[tile];
        const size_t rec = (size_t)tile * blocks + lane;
        const uint32_t rb = rbyte[rec], rend = rans_end[tile];
        const unsigned long long bits0 = (unsigned long long)b * 32;
        Window r, e;
        // the rANS window stops at the word of the last rANS byte
        const long long rlast = rend > 0 ? b + (rend - 1) / 4 : b;
        r.start(pool, bits0 + (unsigned long long)rb * 8,
                rlast < pool_words - 1 ? rlast : pool_words - 1);
        e.start(pool, bits0 + (unsigned long long)extras_off[tile] * 8 + ebit[rec], pool_words - 1);
        int rrem = (int)(rend - rb);
        uint32_t x = x0[rec];
        const int count = min(kBlock, n - lane * kBlock);
        int16_t* o = tile_out + tid * kRowPad;
        for (int i = 0; i < count; ++i) {
            const uint32_t t = table[x & (kSlots - 1)];
            const uint32_t s = t & 31;
            x = ((t >> 5) & 0x1FFF) * (x >> kProbBits) + (t >> 18);
            const uint32_t top = r.top();
            const uint32_t n0 = (x < kStateLo) & (rrem > 0);
            x = n0 ? (x << 8) | (top >> 24) : x;
            const uint32_t n1 = (x < kStateLo) & (rrem - (int)n0 > 0);
            x = n1 ? (x << 8) | ((top >> 16) & 0xFF) : x;
            rrem -= (int)(n0 + n1);
            r.advance(8 * (n0 + n1));
            const uint32_t extra = s ? e.top() >> (32 - s) : 0u;
            e.advance(s);
            const uint32_t q = ((1u << s) + extra - 1u) & 0xFFFFu;
            o[i] = (int16_t)(uint16_t)((q >> 1) ^ (0u - (q & 1u)));
        }
    }
    __syncthreads();
    // the CTA's outputs are consecutive in the tile's output row
    const long long row0 = (long long)tile * n + (long long)first * kBlock;
    const int total = min(lanes * kBlock, n - first * kBlock);
    for (int j = tid; j < total; j += kLanes)
        out[row0 + j] = tile_out[(j / kBlock) * kRowPad + (j % kBlock)];
}

}  // namespace

extern "C" int ako_manba_decode(const uint32_t* pool, long long pool_words, const int* base,
                                const uint32_t* rans_end, const uint32_t* extras_off,
                                const uint32_t* x, const uint32_t* rbyte, const uint32_t* ebit,
                                const int* freq, int16_t* out, int tiles, int blocks,
                                int n_outputs, void* stream) {
    if (pool_words < 1 || blocks != (n_outputs + kBlock - 1) / kBlock)
        return (int)cudaErrorInvalidValue;
    if (tiles == 0 || blocks == 0) return 0;
    const long long grid = (long long)tiles * ((blocks + kLanes - 1) / kLanes);
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    manba_decode<<<(unsigned)grid, kLanes, 0, (cudaStream_t)stream>>>(
        pool, pool_words, base, rans_end, extras_off, x, rbyte, ebit, freq, out, blocks, n_outputs);
    return (int)cudaGetLastError();
}
