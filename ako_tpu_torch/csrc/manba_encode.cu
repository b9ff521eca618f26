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
// Its least time is the steps times the step's dependent path on x (the
// operations' latencies) or the instructions the chain thread issues a
// step, whichever is longer. The design keeps everything else off that
// chain:
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
//       write the previous chunk's emitted bytes. The staged symbols are
//       byte offsets of their table entries, and each entry holds its
//       fields unpacked, so the chain thread extracts no bit field; the
//       entries of the next group of kGroup steps are loaded while the
//       current group runs (their offsets one group earlier still), so
//       no load waits on the chain. A step (chain_step) is one
//       multiply-high on the state as it comes in, beside the two renorm
//       compares, then the three candidate next states (one shift and
//       one multiply-add each), of which the compares pick one. The
//       chain thread neither stores bytes nor counts them: it stores
//       the state entering each step, four to a 16-byte store, and
//       warps 1-3 find from those states and the symbols' thresholds
//       which bytes each step emitted, place them by a suffix scan of
//       their counts and write them downward from the end of the tile's
//       rANS row, so each chunk's bytes are in stream order with no
//       reversal pass (past the budget they are dropped and still
//       counted);
//     - a pack CTA per (tile, chunk): the extras of its chunk at the
//       offset launch 2 gave, ORed into shared words, then stored
//       byte-swapped; the words shared with a neighbouring chunk by
//       atomicOr. The pack never waits on a chain.
// A call is three launches and allocates nothing; the wrapper passes the
// record, a scratch of K6_SCRATCH words a chunk and the two rows.
//
// Beside the codec's entry point: ako_manba_encode_chains (the same
// launches without the pack CTAs), ako_manba_chain_alone (one thread
// stepping a whole stream staged at once, with no barrier and no other
// warp working, timed on the card's clocks) and ako_manba_op_latency
// (dependent chains of the step's operations, and of the loads of K6d's
// step and set-up): measurements of the chains, which the codec never
// calls.

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
constexpr int kGroup = 8;                    // steps whose table entries are loaded together
constexpr int kFlushWarps = kWarps - 1;      // the chain CTA's warps beside the chain's
constexpr int kPackWords = (31 + 16 * kChunk + 31) / 32 + 1;

// the code of one value, 1..65536
__device__ __forceinline__ uint32_t code_of(int16_t v) {
    const int32_t vi = v;
    const uint32_t z = (((uint32_t)vi << 1) ^ (uint32_t)(vi >> 15)) & 0xFFFFu;
    const uint32_t m = (z + 1u) & 0xFFFFu;
    return m ? m : 65536u;
}

__device__ __forceinline__ int sym_of(uint32_t code) { return 31 - __clz(code); }

// A symbol's table entry, unpacked, everything a chain step needs
// beside x. The divider m = ceil(2^(31+l) / f), l = ceil(log2 f), gives
// floor(x / (f 2^8k)) = umulhi(x, m) >> (l - 1 + 8k) for every x below
// 2^31 and k = 0, 1, 2: with d = f 2^8k and p = 31 + l + 8k, m d - 2^p =
// 2^8k (m f - 2^(31+l)) < d, so x m / 2^p - x / d < x / 2^p < 1 / d, and
// the quotient of the renormed state x >> 8k comes from the state as it
// comes in, the renorm picking only the shift. For f = 1 (l = 0) k is
// never 0: x >= 2^23 >= f << 19.
struct Entry {
    uint4 a;  // m, f << 19 (first renorm), f << 27 (second; saturated for f >= 32), 4096 - f
    uint4 b;  // cum, l - 1, l + 7, l + 15: the shift for k = 0, 1, 2 (0 for k = 0 when f = 1)
};

__device__ __forceinline__ Entry table_entry(uint32_t f, uint32_t cum) {
    const uint32_t l = f > 1 ? 32 - __clz(f - 1) : 0;
    const uint32_t m = (uint32_t)(((1ull << (31 + l)) + f - 1) / f);
    const uint32_t z = f < 32 ? f << 27 : 0xFFFFFFFFu;
    return {make_uint4(m, f << 19, z, (1u << kProbBits) - f),
            make_uint4(cum, l - (l > 0), l + 7, l + 15)};
}

// One step of the chain: x' = (x >> 8k) / f * (4096 - f) + (x >> 8k) + cum,
// which is ((x >> 8k) / f << 12) + (x >> 8k) % f + cum, k the bytes the
// renorm emits. The multiply-high reads x as it comes in, beside both
// renorm compares; the three candidate next states, one for each k, are
// each one shift and one multiply-add of it, and the compares, long
// done by then, pick one: ptxas makes that two predicated multiply-adds
// over the first, so the dependent path is the multiply-high, a shift
// and three multiply-adds, and no compare or select waits on a
// predicate. The multiply-adds are written in PTX: in C, the compiler
// moves the selects before the multiply (three selects, then one
// multiply-add), which puts the compares back on the path. No branch
// and no store.
__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

__device__ __forceinline__ uint32_t chain_step(uint32_t x, const Entry& t) {
    const uint32_t hi = __umulhi(x, t.a.x);
    const bool e0 = x >= t.a.y, e1 = x >= t.a.z;
    const uint32_t x0 = mad(hi >> t.b.y, t.a.w, x + t.b.x);
    const uint32_t x1 = mad(hi >> t.b.z, t.a.w, (x >> 8) + t.b.x);
    const uint32_t x2 = mad(hi >> t.b.w, t.a.w, (x >> 16) + t.b.x);
    return e1 ? x2 : (e0 ? x1 : x0);
}

__device__ __forceinline__ Entry entry_at(const Entry* __restrict__ tab, uint32_t off) {
    return *reinterpret_cast<const Entry*>(reinterpret_cast<const char*>(tab) + off);
}

// the bytes (0, 1 or 2) that the step at a state x emits for the symbol
// whose entry is at byte offset off
__device__ __forceinline__ int emitted(uint32_t x, const Entry* __restrict__ tab, uint32_t off) {
    const uint32_t* e = reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(tab) + off);
    return (int)(x >= e[1]) + (int)(x >= e[2]);
}

// the staged entry offsets of group g (positions kGroup g .. kGroup g +
// kGroup - 1), two to a word
struct GroupOffsets {
    uint32_t w[kGroup / 2];
};
static_assert(kGroup == 4 || kGroup == 8, "a group is 4 or 8 steps");

__device__ __forceinline__ GroupOffsets group_offsets(const uint16_t* __restrict__ so, int g) {
    GroupOffsets o;
    if constexpr (kGroup == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(so + kGroup * g);
        o.w[0] = v.x;
        o.w[1] = v.y;
    } else {
        const uint4 v = *reinterpret_cast<const uint4*>(so + kGroup * g);
        o.w[0] = v.x;
        o.w[1] = v.y;
        o.w[2] = v.z;
        o.w[3] = v.w;
    }
    return o;
}

__device__ __forceinline__ void load_group(Entry (&t)[kGroup], const Entry* __restrict__ tab,
                                           const GroupOffsets& o) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) t[j] = entry_at(tab, (o.w[j / 2] >> (16 * (j & 1))) & 0xFFFFu);
}

// the group's steps, back to front; xs[j] = the state entering position
// j of the group, in 16-byte stores
__device__ __forceinline__ uint32_t run_group(uint32_t x, const Entry (&t)[kGroup],
                                              uint32_t* __restrict__ xs) {
    uint32_t in[kGroup];
#pragma unroll
    for (int j = kGroup - 1; j >= 0; --j) {
        in[j] = x;
        x = chain_step(x, t[j]);
    }
#pragma unroll
    for (int j = 0; j < kGroup; j += 4)
        *reinterpret_cast<uint4*>(xs + j) = make_uint4(in[j], in[j + 1], in[j + 2], in[j + 3]);
    return x;
}

// The chain over one chunk's len staged offsets, back to front, from
// state x; xs[i] = the state entering position i. The positions above
// the last whole group go one at a time; then the groups, each one's
// entries loaded while the group before it runs (two register sets, the
// loop unrolled twice so that they swap without moves), and its offsets
// one group earlier still. The loads past group 0 read group 0 again and
// go unused.
__device__ __forceinline__ uint32_t run_chunk(uint32_t x, const uint16_t* __restrict__ so, int len,
                                              const Entry* __restrict__ tab,
                                              uint32_t* __restrict__ xs) {
    int g = len / kGroup - 1;
    for (int i = len - 1; i >= (g + 1) * kGroup; --i) {
        xs[i] = x;
        x = chain_step(x, entry_at(tab, so[i]));
    }
    if (g < 0) return x;
    Entry ta[kGroup], tb[kGroup];
    load_group(ta, tab, group_offsets(so, g));
    GroupOffsets oa, ob_next = group_offsets(so, max(g - 1, 0));
    for (;;) {
        load_group(tb, tab, ob_next);
        oa = group_offsets(so, max(g - 2, 0));
        x = run_group(x, ta, xs + kGroup * g);
        if (--g < 0) break;
        load_group(ta, tab, oa);
        ob_next = group_offsets(so, max(g - 2, 0));
        x = run_group(x, tb, xs + kGroup * g);
        if (--g < 0) break;
    }
    return x;
}

// tab[s] for s < kSyms from the record's frequencies, by threads t < kSyms
__device__ __forceinline__ void fill_table(Entry* __restrict__ tab, const int32_t* __restrict__ rec,
                                           int t) {
    if (t < kSyms) {
        uint32_t cum = 0;
        for (int s = 0; s < t; ++s) cum += (uint32_t)rec[s];
        // an absent symbol (f = 0) never reaches the chain
        tab[t] = table_entry(max((uint32_t)rec[t], 1u), cum);
    }
}

struct ChainSmem {
    Entry tab[kSyms];
    uint16_t off[2][kChunk];  // the staged symbols' entry offsets in tab, in bytes
    uint32_t xs[2][kChunk];   // the states entering the steps
    int wsum[kFlushWarps];
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

// the entry offsets of chunk c's symbols into so, by threads t of nt
__device__ __forceinline__ void stage(const int16_t* __restrict__ v, int c, int n,
                                      uint16_t* __restrict__ so, int t, int nt) {
    const int lo = c * kChunk, len = min(kChunk, n - lo);
    for (int i = t; i < len; i += nt)
        so[i] = (uint16_t)(sym_of(code_of(__ldg(v + lo + i))) * sizeof(Entry));
}

__device__ __forceinline__ void flush_barrier() {
    asm volatile("bar.sync 1, %0;" ::"n"(kFlushWarps * 32) : "memory");
}

// The bytes of a chunk's len steps, from the states xs that entered them
// and their staged entry offsets so, written downward from row[end] (the
// positions below 0, past the budget, dropped) by thread t of warps 1-3;
// returns the chunk's byte count. Step i emits k_i bytes, x & 0xFF then
// x >> 8 & 0xFF, and the steps run from position len - 1 down: each
// thread takes a run of positions and finds where its bytes go by a
// suffix scan of the runs' counts. Ends on a barrier of warps 1-3, after
// which so may be overwritten.
__device__ int flush_chunk(const uint32_t* __restrict__ xs, const uint16_t* __restrict__ so,
                           int len, const Entry* __restrict__ tab, uint8_t* __restrict__ row,
                           long long end, int t, int* __restrict__ wsum) {
    constexpr int nt = kFlushWarps * 32;
    const int run = (len + nt - 1) / nt;
    const int lo = min(len, t * run), hi = min(len, lo + run);
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += emitted(xs[i], tab, so[i]);
    const int lane = t & 31, w = t >> 5;
    int inc = mine;  // this thread's count and those of the lanes above it
    for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_down_sync(0xffffffffu, inc, o);
        if (lane + o < 32) inc += up;
    }
    if (lane == 0) wsum[w] = inc;
    flush_barrier();
    int above = inc - mine, total = 0;
    for (int j = 0; j < kFlushWarps; ++j) {
        total += wsum[j];
        above += j > w ? wsum[j] : 0;
    }
    long long pos = end - 1 - above;
    for (int i = hi - 1; i >= lo; --i) {
        const uint32_t x = xs[i];
        const int k = emitted(x, tab, so[i]);
        if (k >= 1 && pos >= 0) row[pos] = (uint8_t)x;
        if (k == 2 && pos >= 1) row[pos - 1] = (uint8_t)(x >> 8);
        pos -= k;
    }
    flush_barrier();
    return total;
}

__device__ void chain_cta(const int16_t* __restrict__ v, int n, int chunks, int budget,
                          int32_t* __restrict__ rec, uint8_t* __restrict__ row, ChainSmem& sm) {
    const int tid = threadIdx.x, warp = tid >> 5, ft = tid - 32;
    fill_table(sm.tab, rec, tid);
    stage(v, chunks - 1, n, sm.off[0], tid, kThreads);
    __syncthreads();
    uint32_t x = kStateLo, total = 0;
    long long end = budget;
    for (int k = 0, c = chunks - 1; c >= 0; ++k, --c) {
        const int p = k & 1;
        if (tid == 0) {
            x = run_chunk(x, sm.off[p], min(kChunk, n - c * kChunk), sm.tab, sm.xs[p]);
        } else if (warp != 0) {
            if (k > 0) {  // chunk c + 1's bytes, then its offsets' buffer takes chunk c - 1's
                const int cnt = flush_chunk(sm.xs[p ^ 1], sm.off[p ^ 1],
                                            min(kChunk, n - (c + 1) * kChunk), sm.tab, row, end,
                                            ft, sm.wsum);
                end -= cnt;
                total += cnt;
            }
            if (c > 0) stage(v, c - 1, n, sm.off[p ^ 1], ft, kThreads - 32);
        }
        __syncthreads();
    }
    if (warp != 0) {
        const int last = (chunks - 1) & 1;
        total += flush_chunk(sm.xs[last], sm.off[last], min(kChunk, n), sm.tab, row, end, ft,
                             sm.wsum);
        if (ft == 0) rec[kSyms + 1] = (int32_t)total;
    }
    if (tid == 0) rec[kSyms] = (int32_t)x;
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
    extern __shared__ uint4 dyn_smem[];  // sizeof(Smem) bytes
    Smem& sm = *reinterpret_cast<Smem*>(dyn_smem);
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

// The chain alone: a stream's entry offsets all staged in shared memory
// first (n * 2 bytes, dynamic, beside the table and one chunk's states),
// then one thread runs the chain over it chunk by chunk as chain_cta
// does, with no barrier and no other warp working. out: the final state,
// and the chain's SM cycles (clock64) and nanoseconds (globaltimer).
__global__ void __launch_bounds__(kThreads)
manba_chain_alone(const int16_t* __restrict__ v, int n, const int32_t* __restrict__ rec,
                  unsigned long long* __restrict__ out) {
    extern __shared__ uint4 dyn_smem[];
    Entry* tab = reinterpret_cast<Entry*>(dyn_smem);
    uint32_t* xs = reinterpret_cast<uint32_t*>(tab + kSyms);
    uint16_t* so = reinterpret_cast<uint16_t*>(xs + kChunk);
    const int tid = threadIdx.x;
    fill_table(tab, rec, tid);
    for (int i = tid; i < n; i += kThreads)
        so[i] = (uint16_t)(sym_of(code_of(__ldg(v + i))) * sizeof(Entry));
    __syncthreads();
    if (tid != 0) return;
    uint32_t x = kStateLo;
    unsigned long long g0, g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    const long long c0 = clock64();
    for (int c = (n - 1) / kChunk; c >= 0; --c)
        x = run_chunk(x, so + c * kChunk, min(kChunk, n - c * kChunk), tab, xs);
    const long long c1 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    out[0] = x;
    out[1] = (unsigned long long)(c1 - c0);
    out[2] = g1 - g0;
}

constexpr int kOpChain = 16;  // dependent operations per iteration of an op_chain loop

// operation K of the latency chains: 0 the multiply-high, 1 a shift by a
// register, 2 a compare feeding a select, 3 a select alone (in PTX, its
// predicate off the chain, so the compiler cannot fold the chain), 4 a
// multiply-add, 5 an add and a logic operation in turns
template <int K>
__device__ __forceinline__ uint32_t chain_op(uint32_t x, uint32_t a, uint32_t b, int j) {
    if (K == 0) return __umulhi(x, a);
    if (K == 1) return x >> b;
    if (K == 2) return x >= a ? b : a;
    if (K == 3) {
        uint32_t r;
        asm volatile("{\n\t.reg .pred q;\n\tsetp.eq.u32 q, %2, 0;\n\tselp.b32 %0, %1, %3, q;\n\t}"
                     : "=r"(r) : "r"(x), "r"(b), "r"(a));
        return r;
    }
    if (K == 4) return x * a + b;
    return (j & 1) ? x ^ a : x + a;
}

// one thread, iters x kOpChain dependent operations K; out[2K] = the
// last value, out[2K + 1] = the SM cycles they took
template <int K>
__global__ void manba_op_chain(unsigned long long* __restrict__ out, uint32_t a, uint32_t b,
                               int iters) {
    uint32_t x = a ^ threadIdx.x;
    const long long c0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < kOpChain; ++j) x = chain_op<K>(x, a, b, j);
    }
    const long long c1 = clock64();
    out[2 * K] = x;
    out[2 * K + 1] = (unsigned long long)(c1 - c0);
}

// the load chains of K6d (csrc/manba_decode.cu), one thread, iters x
// kOpChain dependent loads each: a shared-memory table whose entries hold
// the next entry's address (ld.shared, as the step's table lookup), then
// a ring in device memory that the block wrote first (ld.global.cg, read
// from L2, as the set-up's loads of a buffer just uploaded); out[12, 16)
// as manba_op_chain's, chains 6 and 7
__global__ void __launch_bounds__(256)
manba_load_chains(unsigned long long* __restrict__ out, uint32_t* __restrict__ ring,
                  int ring_words, int iters) {
    constexpr int kTable = 4096;
    __shared__ uint32_t chase[kTable];
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(chase);
    for (int j = threadIdx.x; j < kTable; j += blockDim.x)
        chase[j] = base + 4u * ((uint32_t)(j * 1021 + 7) & (kTable - 1));
    for (int j = threadIdx.x; j < ring_words; j += blockDim.x)
        ring[j] = (uint32_t)((j + 97) % ring_words);
    __syncthreads();
    if (threadIdx.x != 0) return;
    uint32_t a = base;
    const long long c0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < kOpChain; ++k)
            asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a));
    }
    const long long c1 = clock64();
    uint32_t w = 0;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < kOpChain; ++k)
            asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(w) : "l"(ring + w));
    }
    const long long c2 = clock64();
    out[12] = a;
    out[13] = (unsigned long long)(c1 - c0);
    out[14] = w;
    out[15] = (unsigned long long)(c2 - c1);
}

int launch_encode(const int16_t* values, int32_t* record, int32_t* scratch, uint8_t* rans,
                  uint8_t* extras, int rows, int n, int budget, int row_words, bool pack,
                  cudaStream_t s) {
    if (rows < 1 || n < 1 || budget < 1 || row_words < (budget + 3) / 4)
        return (int)cudaErrorInvalidValue;
    const int chunks = (n + kChunk - 1) / kChunk;
    const long long grid = (long long)rows * chunks;
    if (grid + rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    manba_stats<<<(unsigned)grid, kThreads, 0, s>>>(values, n, chunks, scratch);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    manba_model<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        scratch, rows, n, chunks, record, (uint32_t*)extras, row_words);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaFuncSetAttribute(manba_chain_pack, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
    if (rc != cudaSuccess) return (int)rc;
    manba_chain_pack<<<(unsigned)(pack ? grid + rows : rows), kThreads, sizeof(Smem), s>>>(
        values, n, chunks, rows, budget, row_words, scratch, record, rans, (uint32_t*)extras);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ako_manba_encode(const int16_t* values, int32_t* record, int32_t* scratch,
                                uint8_t* rans, uint8_t* extras, int rows, int n, int budget,
                                int row_words, void* stream) {
    return launch_encode(values, record, scratch, rans, extras, rows, n, budget, row_words, true,
                         (cudaStream_t)stream);
}

// ako_manba_encode without the pack CTAs: the record and the rANS row
// as it writes them, the extras row not written
extern "C" int ako_manba_encode_chains(const int16_t* values, int32_t* record, int32_t* scratch,
                                       uint8_t* rans, uint8_t* extras, int rows, int n, int budget,
                                       int row_words, void* stream) {
    return launch_encode(values, record, scratch, rans, extras, rows, n, budget, row_words, false,
                         (cudaStream_t)stream);
}

// manba_chain_alone on one stream of n values, its frequencies rec[0, 17)
// (a record ako_manba_encode wrote); out: three u64
extern "C" int ako_manba_chain_alone(const int16_t* values, int n, const int32_t* rec,
                                     unsigned long long* out, void* stream) {
    const size_t smem = sizeof(Entry) * kSyms + sizeof(uint32_t) * kChunk +
                        sizeof(uint16_t) * (size_t)n;
    if (n < 1 || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(manba_chain_alone,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    manba_chain_alone<<<1, kThreads, smem, (cudaStream_t)stream>>>(values, n, rec, out);
    return (int)cudaGetLastError();
}

// the six latency chains of manba_op_chain, then the two of
// manba_load_chains on a device ring of ring_words words (at least 1024),
// iters x 16 operations each, one after another; out: sixteen u64
extern "C" int ako_manba_op_latency(unsigned long long* out, uint32_t* ring, int ring_words,
                                    int iters, void* stream) {
    if (iters < 1 || ring_words < 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t a = 0x9E3779B9u, b = 0;
    manba_op_chain<0><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_op_chain<1><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_op_chain<2><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_op_chain<3><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_op_chain<4><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_op_chain<5><<<1, 1, 0, s>>>(out, a, b, iters);
    manba_load_chains<<<1, 256, 0, s>>>(out, ring, ring_words, iters);
    return (int)cudaGetLastError();
}
