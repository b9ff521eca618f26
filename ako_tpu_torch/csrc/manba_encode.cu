// Manbavaran (static-model rANS) encode for Hopper (sm_90a): kernel K6e.
//
// Replaces ako_tpu/ops/manba_device.py:manba_encode_device (:250, an XLA
// program: _sym_extra :189, manba_model_device :227 with _udiv_shift12
// :205, a lax.scan over the reversed stream, pack_bits twice; vmapped
// over tiles) and computes what the plain version in
// ako_tpu_torch/ops/manba_device.py computes, bit for bit (the wire
// format is csrc/akort.c akort_manba_encode's):
//   code  = (u16)(zigzag(v) + 1), 0 standing for 65536 (so -32768 gets
//           sym 16 and 16 extra bits); sym = bit length - 1; extra = the
//           code's low sym bits;
//   model = floor(hist * 4096 / n) in 64 bits, a present symbol with 0
//           bumped to 1, the drift settled on the first maximum;
//   chain = back to front from x = 2^23: x_max = f << 19, emit at most
//           two low bytes (b0 before b1) while x >= x_max, then
//           x = (x / f << 12) + x % f + cum;
//   extras = sym bits of extra per value, MSB first, big-endian.
//
// What bounds it: latency. The wire format fixes one rANS state per
// tile stream, coded back to front, so each stream's encode is one
// serial chain of n dependent steps that no kernel can split (65,560
// steps per 128-px RGBA tile, 5,242,932 on a whole 1024x1280 tile); the
// bytes (the int16 stream read, the payload written) take microseconds.
// The design keeps everything else off that chain:
//   launch 1 (manba_stats, a CTA per (tile, chunk of kChunk values)):
//     symbols and the chunk's 17-bin histogram (warp ballots) and its
//     extras bit count into a scratch;
//   launch 2 (manba_model, a warp per tile): the tile's histogram, the
//     model (64-bit floor division), ok, the extras' chunk bit offsets
//     (an exclusive warp scan), and zeros in the extras words at each
//     chunk's two ends, which launch 3 ORs into;
//   launch 3 (manba_chain_pack), two kinds of CTA in one grid, the chains
//     first so that they start at once:
//     - a chain CTA per tile: lane 0 of warp 0 runs the chain over a
//       chunk of symbols staged in shared memory while warps 1-3 stage
//       the next chunk (loads and the symbol math off the chain) and
//       store the previous chunk's emitted bytes; the symbol's table
//       entry (the two renorm thresholds, cum, 4096 - f and a
//       multiply-high divider exact for every x below 2^31:
//       x / f = umulhi(2x, ceil(2^(31+l) / f)) >> l, l = ceil(log2 f)) is
//       read eight steps ahead, so a step is about seven dependent
//       integer operations on x; the emitted bytes go
//       downward from the end of a shared buffer, so each chunk's bytes
//       are in stream order and land downward from the end of the tile's
//       rANS row with no reversal pass (past the budget they are dropped
//       and still counted);
//     - a pack CTA per (tile, chunk): the extras of its chunk at the
//       offset launch 2 gave, ORed into shared words, then stored
//       byte-swapped; the words shared with a neighbouring chunk by
//       atomicOr. The pack never waits on a chain.
// A call is three launches and allocates nothing; the wrapper passes the
// record, a scratch of K6_SCRATCH words a chunk and the two rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 17;
constexpr int kChunk = 4096;                 // K6_CHUNK: values per chunk
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = kChunk / kThreads;    // values per thread of a chunk
constexpr int kScratch = kSyms + 2;          // K6_SCRATCH: bins, extras bits, extras offset
constexpr int kRecord = kSyms + 4;           // RECORD_WORDS: freq, x, rans bytes, extras bits, ok
constexpr int kProbBits = 12;
constexpr uint32_t kStateLo = 1u << 23;
constexpr int kAhead = 8;                    // chain steps whose table entries are read together
constexpr int kOutBytes = 2 * kChunk + 8;    // a chunk emits at most 2 bytes a value
constexpr int kPackWords = (31 + 16 * kChunk + 31) / 32 + 1;

// the code of one value, 1..65536
__device__ __forceinline__ uint32_t code_of(int16_t v) {
    const int32_t vi = v;
    const uint32_t z = (((uint32_t)vi << 1) ^ (uint32_t)(vi >> 15)) & 0xFFFFu;
    const uint32_t m = (z + 1u) & 0xFFFFu;
    return m ? m : 65536u;
}

__device__ __forceinline__ int sym_of(uint32_t code) { return 31 - __clz(code); }

// A symbol's table entry, everything a chain step needs beside x:
// x = the divider's multiplier, y = the first renorm threshold
// (f << 19), z = the second (f << 27, saturated: x < 2^31 never reaches
// it then), w = 4096 - f | cum << 13 | l << 26.
__device__ __forceinline__ uint4 table_entry(uint32_t f, uint32_t cum) {
    const uint32_t l = f > 1 ? 32 - __clz(f - 1) : 0;
    const uint32_t m = (uint32_t)(((1ull << (31 + l)) + f - 1) / f);
    const uint32_t z = f < 32 ? f << 27 : 0xFFFFFFFFu;
    return make_uint4(m, f << 19, z, ((1u << kProbBits) - f) | (cum << 13) | (l << 26));
}

// One step of the chain. Both renorm tests read x at once and two
// selects shift it (x >= f << 27 is (x >> 8) >= f << 19); the quotient
// x / f of the renormed x (below 2^31) is umulhi(2x, m) >> l; then
// (x / f << 12) + x % f + cum == x + cum + (x / f) * (4096 - f). The
// two candidate bytes are stored whether or not they are emitted (a
// store that is not kept lies below the buffer's used range and is
// overwritten later), so the step has no branch.
__device__ __forceinline__ uint32_t chain_step(uint32_t x, uint4 t, uint8_t* __restrict__ ob,
                                               int& e) {
    const uint32_t gain = t.w & 0x1FFFu, cum = (t.w >> 13) & 0x1FFFu, l = t.w >> 26;
    const bool e0 = x >= t.y, e1 = x >= t.z;
    ob[e - 1] = (uint8_t)x;
    ob[e - 2] = (uint8_t)(x >> 8);
    e -= (int)e0 + (int)e1;
    x = e1 ? x >> 16 : (e0 ? x >> 8 : x);
    const uint32_t q = __umulhi(x + x, t.x) >> l;
    return x + cum + q * gain;
}

struct ChainSmem {
    uint8_t sym[2][kChunk];
    uint8_t out[2][kOutBytes];
    uint4 tab[kSyms];
    int count[2];
};

struct PackSmem {
    int16_t vals[kChunk];
    uint32_t words[kPackWords];
    uint32_t warp_bits[kWarps];
};

union Smem {
    ChainSmem chain;
    PackSmem pack;
};

__global__ void __launch_bounds__(kThreads)
manba_stats(const int16_t* __restrict__ values, int n, int chunks, int32_t* __restrict__ scratch) {
    const int row = blockIdx.x / chunks, c = blockIdx.x % chunks;
    const int16_t* v = values + (size_t)row * n;
    const int lo = c * kChunk, hi = min(n, lo + kChunk);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __shared__ uint32_t part[kWarps][kSyms + 1];
    uint32_t count = 0, bits = 0;  // lane b < 17 counts bin b of its warp
    for (int k = 0; k < kItems; ++k) {
        const int i = lo + k * kThreads + threadIdx.x;
        const int s = i < hi ? sym_of(code_of(__ldg(v + i))) : -1;
        bits += s > 0 ? s : 0;
#pragma unroll
        for (int b = 0; b < kSyms; ++b) {
            const unsigned ball = __ballot_sync(0xffffffffu, s == b);
            if (lane == b) count += __popc(ball);
        }
    }
    for (int o = 16; o; o >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, o);
    if (lane < kSyms) part[warp][lane] = count;
    if (lane == 0) part[warp][kSyms] = bits;
    __syncthreads();
    if (threadIdx.x <= kSyms) {
        uint32_t sum = 0;
        for (int w = 0; w < kWarps; ++w) sum += part[w][threadIdx.x];
        scratch[(size_t)blockIdx.x * kScratch + threadIdx.x] = (int32_t)sum;
    }
}

__global__ void __launch_bounds__(kThreads)
manba_model(int32_t* __restrict__ scratch, int rows, int n, int chunks, int32_t* __restrict__ record,
            uint32_t* __restrict__ extras, int row_words) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    int32_t* st = scratch + (size_t)row * chunks * kScratch;
    uint32_t tot[kSyms + 1];
#pragma unroll
    for (int b = 0; b <= kSyms; ++b) tot[b] = 0;
    for (int c = lane; c < chunks; c += 32) {
#pragma unroll
        for (int b = 0; b <= kSyms; ++b) tot[b] += (uint32_t)st[(size_t)c * kScratch + b];
    }
#pragma unroll
    for (int b = 0; b <= kSyms; ++b)
        for (int o = 16; o; o >>= 1) tot[b] += __shfl_xor_sync(0xffffffffu, tot[b], o);
    uint32_t h = 0;
#pragma unroll
    for (int b = 0; b < kSyms; ++b)
        if (lane == b) h = tot[b];
    uint32_t f = 0;
    if (lane < kSyms) {
        f = (uint32_t)(((uint64_t)h << kProbBits) / (uint64_t)n);
        if (h > 0 && f == 0) f = 1;
    }
    uint32_t sum = f;
    // the first maximum: the largest f, then the lowest index
    uint32_t key = lane < kSyms ? (f << 5) | (31u - lane) : 0u;
    for (int o = 16; o; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
    }
    const int maxi = 31 - (int)(key & 31u);
    const int fixed = (int)(key >> 5) + (1 << kProbBits) - (int)sum;
    if (lane == maxi) f = (uint32_t)max(fixed, 1);
    int32_t* rec = record + (size_t)row * kRecord;
    if (lane < kSyms) rec[lane] = (int32_t)f;
    if (lane == 0) {
        rec[kSyms + 2] = (int32_t)tot[kSyms];
        rec[kSyms + 3] = fixed >= 1;
    }
    // the extras' chunk offsets, and zeros where two chunks share a word
    uint32_t carry = 0;
    uint32_t* ew = extras + (size_t)row * row_words;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
        const int c = c0 + lane;
        const uint32_t b = c < chunks ? (uint32_t)st[(size_t)c * kScratch + kSyms] : 0u;
        uint32_t inc = b;
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t t = __shfl_up_sync(0xffffffffu, inc, o);
            if (lane >= o) inc += t;
        }
        const uint32_t off = carry + inc - b;
        if (c < chunks) {
            st[(size_t)c * kScratch + kSyms + 1] = (int32_t)off;
            if (b) {
                const uint32_t fw = off >> 5, lw = (off + b - 1) >> 5;
                if (fw < (uint32_t)row_words) ew[fw] = 0;
                if (lw < (uint32_t)row_words) ew[lw] = 0;
            }
        }
        carry += __shfl_sync(0xffffffffu, inc, 31);
    }
}

// symbols of chunk c into sb, by threads t of nt
__device__ __forceinline__ void stage(const int16_t* __restrict__ v, int c, int n,
                                      uint8_t* __restrict__ sb, int t, int nt) {
    const int lo = c * kChunk, len = min(kChunk, n - lo);
    for (int i = t; i < len; i += nt) sb[i] = (uint8_t)sym_of(code_of(__ldg(v + lo + i)));
}

// a chunk's cnt emitted bytes (the last cnt of ob) to row[end - cnt, end),
// the positions below 0 (past the budget) dropped
__device__ __forceinline__ void flush(const uint8_t* __restrict__ ob, int cnt,
                                      uint8_t* __restrict__ row, long long end, int t, int nt) {
    const long long start = end - cnt;
    for (int j = t; j < cnt; j += nt)
        if (start + j >= 0) row[start + j] = ob[kOutBytes - cnt + j];
}

__device__ void chain_cta(const int16_t* __restrict__ v, int n, int chunks, int budget,
                          int32_t* __restrict__ rec, uint8_t* __restrict__ row, ChainSmem& sm) {
    const int tid = threadIdx.x, warp = tid >> 5;
    if (tid < kSyms) {
        uint32_t cum = 0;
        for (int s = 0; s < tid; ++s) cum += (uint32_t)rec[s];
        // an absent symbol (f = 0) never reaches the chain
        sm.tab[tid] = table_entry(max((uint32_t)rec[tid], 1u), cum);
    }
    stage(v, chunks - 1, n, sm.sym[0], tid, kThreads);
    __syncthreads();
    uint32_t x = kStateLo, total = 0;
    long long end = budget;
    for (int k = 0, c = chunks - 1; c >= 0; ++k, --c) {
        const int p = k & 1;
        if (k > 0) {
            const int prev = sm.count[p ^ 1];
            if (warp != 0) flush(sm.out[p ^ 1], prev, row, end, tid - 32, kThreads - 32);
            end -= prev;
        }
        if (warp == 0) {
            if (tid == 0) {
                const uint8_t* __restrict__ sb = sm.sym[p];
                uint8_t* __restrict__ ob = sm.out[p];
                int e = kOutBytes;
                int i = min(kChunk, n - c * kChunk) - 1;
                for (; i >= kAhead - 1; i -= kAhead) {
                    uint4 t[kAhead];
#pragma unroll
                    for (int j = 0; j < kAhead; ++j) t[j] = sm.tab[sb[i - j]];
#pragma unroll
                    for (int j = 0; j < kAhead; ++j) x = chain_step(x, t[j], ob, e);
                }
                for (; i >= 0; --i) x = chain_step(x, sm.tab[sb[i]], ob, e);
                sm.count[p] = kOutBytes - e;
                total += kOutBytes - e;
            }
        } else if (c > 0) {
            stage(v, c - 1, n, sm.sym[p ^ 1], tid - 32, kThreads - 32);
        }
        __syncthreads();
    }
    const int last = (chunks - 1) & 1;
    flush(sm.out[last], sm.count[last], row, end, tid, kThreads);
    if (tid == 0) {
        rec[kSyms] = (int32_t)x;
        rec[kSyms + 1] = (int32_t)total;
    }
}

__device__ void pack_cta(const int16_t* __restrict__ v, int n, int c,
                         const int32_t* __restrict__ st, uint32_t* __restrict__ ew,
                         int row_words, PackSmem& sm) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lo = c * kChunk, len = min(kChunk, n - lo);
    for (int i = tid; i < len; i += kThreads) sm.vals[i] = __ldg(v + lo + i);
    const uint32_t off = (uint32_t)st[kSyms + 1], bits = (uint32_t)st[kSyms];
    const uint32_t nwords = ((off & 31) + bits + 31) >> 5;
    for (uint32_t w = tid; w < nwords; w += kThreads) sm.words[w] = 0;
    __syncthreads();
    const int i0 = tid * kItems;
    uint32_t mine = 0;
    for (int j = 0; j < kItems && i0 + j < len; ++j) mine += sym_of(code_of(sm.vals[i0 + j]));
    uint32_t inc = mine;
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
    }
    if (lane == 31) sm.warp_bits[warp] = inc;
    __syncthreads();
    uint32_t pos = (off & 31) + inc - mine;  // bit 0 = the MSB of word off >> 5
    for (int w = 0; w < warp; ++w) pos += sm.warp_bits[w];
    for (int j = 0; j < kItems && i0 + j < len; ++j) {
        const uint32_t code = code_of(sm.vals[i0 + j]);
        const int s = sym_of(code);
        if (s == 0) continue;
        const uint32_t extra = code - (1u << s);
        const uint32_t w = pos >> 5, b = pos & 31;
        const int k1 = min(32 - (int)b, s), k2 = s - k1;
        atomicOr(&sm.words[w], (extra >> k2) << (32 - b - k1));
        if (k2) atomicOr(&sm.words[w + 1], (extra & ((1u << k2) - 1)) << (32 - k2));
        pos += s;
    }
    __syncthreads();
    const uint32_t fw = off >> 5;
    for (uint32_t w = tid; w < nwords && fw + w < (uint32_t)row_words; w += kThreads) {
        const uint32_t val = __byte_perm(sm.words[w], 0, 0x0123);  // big-endian bytes
        if (w == 0 || w == nwords - 1)
            atomicOr(ew + fw + w, val);
        else
            ew[fw + w] = val;
    }
}

__global__ void __launch_bounds__(kThreads)
manba_chain_pack(const int16_t* __restrict__ values, int n, int chunks, int rows, int budget,
                 int row_words, const int32_t* __restrict__ scratch, int32_t* __restrict__ record,
                 uint8_t* __restrict__ rans, uint32_t* __restrict__ extras) {
    __shared__ Smem sm;
    if ((int)blockIdx.x < rows) {
        const int row = blockIdx.x;
        chain_cta(values + (size_t)row * n, n, chunks, budget, record + (size_t)row * kRecord,
                  rans + (size_t)row * budget, sm.chain);
        return;
    }
    const int j = blockIdx.x - rows, row = j / chunks, c = j % chunks;
    pack_cta(values + (size_t)row * n, n, c, scratch + ((size_t)row * chunks + c) * kScratch,
             extras + (size_t)row * row_words, row_words, sm.pack);
}

// The chain alone: one thread, `steps` steps of one symbol whose entry
// is held in registers, chunk by chunk as chain_cta runs them, with no
// load on the chain.
__global__ void manba_chain_probe(uint32_t* out, long long steps, uint32_t f) {
    __shared__ uint8_t ob[kOutBytes];
    const uint4 t = table_entry(f, 0);
    uint32_t x = kStateLo, total = 0;
    for (long long done = 0; done < steps; done += kChunk) {
        int e = kOutBytes;
        const int len = (int)min((long long)kChunk, steps - done);
        for (int i = 0; i < len; ++i) x = chain_step(x, t, ob, e);
        total += kOutBytes - e;
    }
    out[0] = x;
    out[1] = total;
}

}  // namespace

extern "C" int ako_manba_encode(const int16_t* values, int32_t* record, int32_t* scratch,
                                uint8_t* rans, uint8_t* extras, int rows, int n, int budget,
                                int row_words, void* stream) {
    if (rows < 1 || n < 1 || budget < 1 || row_words < (budget + 3) / 4)
        return (int)cudaErrorInvalidValue;
    const int chunks = (n + kChunk - 1) / kChunk;
    const long long grid = (long long)rows * chunks;
    if (grid + rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    manba_stats<<<(unsigned)grid, kThreads, 0, s>>>(values, n, chunks, scratch);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    manba_model<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        scratch, rows, n, chunks, record, (uint32_t*)extras, row_words);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    manba_chain_pack<<<(unsigned)(grid + rows), kThreads, 0, s>>>(
        values, n, chunks, rows, budget, row_words, scratch, record, rans, (uint32_t*)extras);
    return (int)cudaGetLastError();
}

extern "C" int ako_manba_chain_probe(uint32_t* out, long long steps, int freq, void* stream) {
    if (steps < 1 || freq < 1 || freq > (1 << kProbBits)) return (int)cudaErrorInvalidValue;
    manba_chain_probe<<<1, 1, 0, (cudaStream_t)stream>>>(out, steps, (uint32_t)freq);
    return (int)cudaGetLastError();
}
