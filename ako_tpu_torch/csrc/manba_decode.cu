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
// The frequencies are those of a payload the sync scan accepted: they sum
// to 4096, so each f fits the table's 13 bits.
//
// What bounds it: each lane is a chain of kBlock dependent steps (the slot
// comes from the state the previous step left), so the least time is the
// step's dependent path times kBlock plus the set-up's two dependent
// round trips; the bytes are few (the payload read about once, 2 B
// written per output). With about 41 k lanes on 132 SMs (both north-star
// settings) a scheduler holds two or three warps, too few to hide a
// warp's waits: each warp's step time is what counts (PERF.md). So:
//   - the slot table is built by each CTA in a few hundred cycles: each
//     warp scans the 17 frequencies with shuffles, and every thread fills
//     the slots of each symbol in turn, one 32-bit store each, entry(j) =
//     A[s] + (j << 20) with A[s] = f | s << 13 | -cum << 20 (the step
//     reads f, s and slot - cum from one shared load);
//   - a tile's warps are cut evenly over `parts` CTAs, `parts` chosen by
//     the launcher so that the SM with the most work, in CTAs' tables and
//     warps' chains, has the least (one wave on the north star: 3 CTAs of
//     5-6 warps a tile; on the whole tile 129 CTAs of 9-10 warps);
//   - each lane keeps two windows in registers, the rANS bytes and the
//     extras bits: the two words at a bit position (a funnel shift reads
//     32 bits at it) and the two after them; a step reads at most 16 bits,
//     so a window moves at most one word in a pair of steps, by selects at
//     the pair's end, and a word it loads then is first read two steps
//     later; the words are 32-bit indices into the pool, each window's
//     clamped to its last word (the rANS window's to the word of the
//     payload's last rANS byte, the extras window's to the pool's last);
//   - a step is branch-free: the refill candidates are the state shifted
//     by 8 and 16 bits with the window's top bytes funnelled in, and the
//     two renorm compares pick one; the code (1 << s) + extra is one
//     funnel shift of the extras window's top bits under a 1;
//   - a lane's 128 outputs are consecutive in its tile's row: every
//     kGroup steps each lane puts its sixteen in its warp's 1.5 KB buffer
//     and the warp stores them in 16-byte stores, sixteen lanes' 32 bytes
//     a store (two-byte stores from registers where the row is not
//     16-byte aligned), so the writes spread over the chains, each in
//     whole 32-byte segments, and the CTA has no barrier after its table.
// A call is one launch and allocates nothing.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 17;
constexpr int kBlock = 128;          // DECODE_BLOCK: outputs per lane
constexpr int kGroup = 16;           // steps between a warp's stores of its outputs
constexpr int kMaxWarps = 16;        // warps a CTA at most
constexpr int kProbBits = 12;
constexpr int kSlots = 1 << kProbBits;
constexpr uint32_t kStateLo = 1u << 23;
constexpr int kSymShift = 13;        // entry: f | s << kSymShift | (slot - cum) << kBiasShift
constexpr int kBiasShift = 20;
constexpr int kRowBytes = kGroup * 2 + 16;  // a lane's outputs of a group in its warp's
                                            // buffer, padded: a quarter warp's 16-byte
                                            // stores hit distinct banks
// the launcher's estimates of the warp instructions a CTA issues to build
// its table and a warp issues for its lane's chain
constexpr long long kTableCost = 1000;
constexpr long long kWarpCost = 6000;

// A bit stream's window: the two words at the read position and the two
// after them. A step reads at most 16 bits, so the window moves at most one
// word in a pair of steps, at the pair's end, and a word it loads is first
// read two steps later.
struct Window {
    uint32_t w0, w1;  // words i and i + 1 from the first (each index clamped to last)
    uint32_t n1, n2;  // words i + 2 and i + 3
    uint32_t pos;     // bit position from the first word's first bit
    uint32_t i;       // pos / 32 at the pair's start
    uint32_t first3;  // the first word's pool index, plus 3
    uint32_t last;    // the last pool index it may load

    __device__ __forceinline__ void start(const uint32_t* pool, uint32_t word, uint32_t bit,
                                          uint32_t lim) {
        pos = bit;
        i = 0;
        first3 = word + 3;
        last = lim;
        w0 = __ldg(pool + min(word, lim));
        w1 = __ldg(pool + min(word + 1, lim));
        n1 = __ldg(pool + min(word + 2, lim));
        n2 = __ldg(pool + min(word + 3, lim));
    }
    // the 32 bits at pos (the funnel shift takes pos mod 32): in a pair's
    // first step pos lies in w0, in its second in w0 or w1
    template <bool kSecond>
    __device__ __forceinline__ uint32_t top() const {
        if (!kSecond) return __funnelshift_l(w1, w0, pos);
        const bool m = (pos >> 5) != i;
        return __funnelshift_l(m ? n1 : w1, m ? w1 : w0, pos);
    }
    // the pair's end: one word on if pos left w0, and only then a load
    __device__ __forceinline__ void move(const uint32_t* pool) {
        const uint32_t j = pos >> 5;
        const bool m = j != i;
        w0 = m ? w1 : w0;
        w1 = m ? n1 : w1;
        n1 = m ? n2 : n1;
        if (m) n2 = __ldg(pool + min(j + first3, last));
        i = j;
    }
};

// One output: the state's step, the refill, the extras and the value's
// bit pattern in the low 16 bits; kSecond: the pair's second step.
template <bool kSecond>
__device__ __forceinline__ uint32_t step(uint32_t& x, int& rbits, Window& r, Window& e,
                                         const uint32_t* table) {
    const uint32_t t = table[x & (kSlots - 1)];
    x = (t & ((1u << kSymShift) - 1)) * (x >> kProbBits) + (t >> kBiasShift);
    // both refill candidates off the renorm decision; rbits: the rANS
    // bits left in the payload
    const uint32_t top = r.top<kSecond>();
    const bool n0 = x < kStateLo && rbits >= 8;
    const bool n1 = x < (kStateLo >> 8) && rbits >= 16;
    const uint32_t x1 = __funnelshift_l(top, x, 8), x2 = __funnelshift_l(top, x, 16);
    x = n1 ? x2 : (n0 ? x1 : x);
    const uint32_t k = n1 ? 16u : (n0 ? 8u : 0u);
    rbits -= (int)k;
    r.pos += k;
    // code = (1 << s) + the next s extras bits, one funnel shift by the
    // entry's s field (the shift takes its low 5 bits)
    const uint32_t sh = t >> kSymShift;
    const uint32_t code = __funnelshift_l(e.top<kSecond>(), 1u, sh);
    e.pos += sh & 31;
    const uint32_t q = code - 1u;
    return ((q >> 1) & 0x7FFFu) ^ (uint32_t)((int32_t)(q << 31) >> 31);
}

// One CTA: lanes [32 * wa, 32 * wb) of one tile (wb - wa <= blockDim.x /
// 32), the tile's warps cut evenly over `parts` CTAs. Shared memory: the
// slot table, and a buffer of kRowBytes rows a lane for each warp.
__global__ void __launch_bounds__(kMaxWarps * 32)
manba_decode(const uint32_t* __restrict__ pool, uint32_t pool_words, const int* __restrict__ base,
             const uint32_t* __restrict__ rans_end, const uint32_t* __restrict__ extras_off,
             const uint32_t* __restrict__ x0, const uint32_t* __restrict__ rbyte,
             const uint32_t* __restrict__ ebit, const int* __restrict__ freq,
             int16_t* __restrict__ out, int blocks, int n, int parts) {
    __shared__ uint32_t table[kSlots];
    extern __shared__ uint4 buffers[];  // a buffer a warp
    const int tile = blockIdx.x / parts, part = blockIdx.x - tile * parts;
    const int warps = (blocks + 31) / 32;
    const int wa = (int)((long long)part * warps / parts);
    const int wb = (int)((long long)(part + 1) * warps / parts);
    const int tid = threadIdx.x, lane_id = tid & 31;
    const int lane = wa * 32 + tid;
    char* buf = reinterpret_cast<char*>(buffers) + (tid >> 5) * 32 * kRowBytes;

    // the set-up's first round trip: the lane's records, the tile's offsets
    // and its frequencies (one a lane of each warp)
    const size_t rec = (size_t)tile * blocks + min(lane, blocks - 1);
    uint32_t x = x0[rec];
    const uint32_t rb = rbyte[rec], eb = ebit[rec];
    const uint32_t b = (uint32_t)base[tile], rend = rans_end[tile];
    const uint32_t eoff = extras_off[tile];
    const uint32_t f = lane_id < kSyms ? (uint32_t)freq[tile * kSyms + lane_id] : 0u;

    // the second: each window's first four words
    Window r, e;
    const uint32_t rlast = rend > 0 ? b + (rend - 1) / 4 : b;
    r.start(pool, b + rb / 4, (rb & 3) * 8, min(rlast, pool_words - 1));
    const unsigned long long ebits = (unsigned long long)eoff * 8 + eb;
    e.start(pool, b + (uint32_t)(ebits >> 5), (uint32_t)(ebits & 31), pool_words - 1);
    const long long rleft = (long long)rend - rb;
    int rbits = 8 * (int)max(min(rleft, 1LL << 24), -1LL);

    // the table, while those words come: cum by a shuffle scan, then each
    // symbol's slots [cum, cum + f) (clamped to the table, the last
    // symbol's to its end) filled by all threads
    uint32_t cum = f;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
        const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, cum, d);
        if (lane_id >= d) cum += v;
    }
    cum -= f;
#pragma unroll
    for (int s = 0; s < kSyms; ++s) {
        const uint32_t lo = __shfl_sync(0xFFFFFFFFu, cum, s);
        const uint32_t fs = __shfl_sync(0xFFFFFFFFu, f, s);
        const uint32_t hi = s == kSyms - 1 ? (uint32_t)kSlots : min(lo + fs, (uint32_t)kSlots);
        const uint32_t a = fs | (uint32_t)s << kSymShift | (0u - lo) << kBiasShift;
        for (uint32_t j = min(lo, (uint32_t)kSlots) + tid; j < hi; j += blockDim.x)
            table[j] = a + (j << kBiasShift);
    }
    __syncthreads();

    // the warp's outputs, consecutive in its tile's row: a group's sixteen
    // of each lane go through the warp's buffer, so that each 16-byte store
    // writes sixteen lanes' 32 bytes (two-byte stores from registers where
    // the row is not 16-byte aligned)
    const int lane0 = lane - lane_id;
    const int len = min(32 * kBlock, n - lane0 * kBlock);
    int16_t* dst = out + (size_t)tile * n + (size_t)lane0 * kBlock;
    const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    if (lane0 < wb * 32 && lane0 < blocks) {
#pragma unroll 1
        for (int g = 0; g < kBlock / kGroup; ++g) {
            // (lanes past the tile's last decode its last lane again; no
            // output of theirs is stored)
            uint32_t v[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; j += 2) {
                v[j] = step<false>(x, rbits, r, e, table);
                v[j + 1] = step<true>(x, rbits, r, e, table);
                r.move(pool);
                e.move(pool);
            }
            const int at = lane_id * kBlock + g * kGroup;  // the lane's first output of the group
            if (vec) {
                uint4* row = reinterpret_cast<uint4*>(buf + lane_id * kRowBytes);
                row[0] = make_uint4(__byte_perm(v[0], v[1], 0x5410),
                                    __byte_perm(v[2], v[3], 0x5410),
                                    __byte_perm(v[4], v[5], 0x5410),
                                    __byte_perm(v[6], v[7], 0x5410));
                row[1] = make_uint4(__byte_perm(v[8], v[9], 0x5410),
                                    __byte_perm(v[10], v[11], 0x5410),
                                    __byte_perm(v[12], v[13], 0x5410),
                                    __byte_perm(v[14], v[15], 0x5410));
                __syncwarp();
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int src = p * 16 + (lane_id >> 1), h = lane_id & 1;
                    const int o = src * kBlock + g * kGroup + h * 8;  // its first output
                    const char* piece = buf + src * kRowBytes + h * 16;
                    if (o + 8 <= len) {
                        *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(piece);
                    } else {
                        for (int j = 0; j < len - o; ++j)
                            dst[o + j] = reinterpret_cast<const int16_t*>(piece)[j];
                    }
                }
                __syncwarp();
            } else {
#pragma unroll
                for (int j = 0; j < kGroup; ++j)
                    if (at + j < len) dst[at + j] = (int16_t)(uint16_t)v[j];
            }
        }
    }
}

// CTAs a tile: of the cuts of a tile's warps into equal CTAs (up to
// kMaxWarps warps each), the one whose busiest SM, holding
// ceil(CTAs / SMs) of them, issues the fewest warp instructions at the
// cost estimates; the fewest CTAs of equal cost.
int cta_parts(int tiles, int blocks, int sms) {
    const int warps = (blocks + 31) / 32;
    int best = warps;
    long long best_cost = LLONG_MAX;
    for (int parts = (warps + kMaxWarps - 1) / kMaxWarps; parts <= warps; ++parts) {
        const long long per_sm = ((long long)tiles * parts + sms - 1) / sms;
        const long long cost = per_sm * (kTableCost + kWarpCost * ((warps + parts - 1) / parts));
        if (cost < best_cost) {
            best_cost = cost;
            best = parts;
        }
    }
    return best;
}

}  // namespace

extern "C" int ako_manba_decode(const uint32_t* pool, long long pool_words, const int* base,
                                const uint32_t* rans_end, const uint32_t* extras_off,
                                const uint32_t* x, const uint32_t* rbyte, const uint32_t* ebit,
                                const int* freq, int16_t* out, int tiles, int blocks,
                                int n_outputs, void* stream) {
    // word indices and their limits are 32-bit, three words past a cursor
    if (pool_words < 1 || pool_words > INT_MAX - 4 || blocks != (n_outputs + kBlock - 1) / kBlock)
        return (int)cudaErrorInvalidValue;
    if (tiles == 0 || blocks == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    const int parts = cta_parts(tiles, blocks, sms);
    const int warps = ((blocks + 31) / 32 + parts - 1) / parts;
    const long long grid = (long long)tiles * parts;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    manba_decode<<<(unsigned)grid, warps * 32, warps * 32 * kRowBytes, (cudaStream_t)stream>>>(
        pool, (uint32_t)pool_words, base, rans_end, extras_off, x, rbyte, ebit, freq, out, blocks,
        n_outputs, parts);
    return (int)cudaGetLastError();
}

