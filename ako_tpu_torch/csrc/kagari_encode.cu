// Kagari tokenize + pack for Hopper (sm_90a): kernel K3.
//
// Replaces ako_tpu/ops/kagari_device.py:kagari_encode_device (:665, an
// XLA program: tokenize :124, then pack_bits :428 with the TPU's
// rank/placement packer) and computes what the plain version in
// ako_tpu_torch/ops/kagari_device.py (tokenize + pack_bits) computes:
// for each row of a (rows, n) int16 tensor, the Kagari bytes of the
// reference encoder (library/kagari.c:59-366) cut at `budget` bytes, and
// the exact compressed size ceil(total_bits / 8).
//
// Per position p of a row (same: v[p] == v[p-1], never at p = 0; last:
// the latest position <= p that is not `same`; d = p - last):
//   rc = d ? (d - 1) % 65534 + 1 : 0       the reference's run counter
//   literal iff d == 0 or rc <= 2          gamma(zigzag(v) + 1 mod 2^16)
//   flush   iff rc == 65534                token 65533
//   end     iff same, rc >= 2, no flush,
//           and v[p+1] differs or p is last   token rc - 1
// Elias-gamma codes (at most 31 bits; one bit for the u == 0 wrap of
// -32768) go MSB-first into big-endian 32-bit words at the exclusive
// prefix sum of the code lengths. Codes past the row's words are
// dropped; the caller's rows hold ceil(budget / 4) words.
//
// Design: one launch a call, each value read once. A row is cut into
// chunks of kChunk positions, one CTA each. A chunk needs two carries
// from its row's earlier chunks: the last mismatch before it (a max),
// and its first bit offset (a sum, which needs the first). Both come by
// decoupled look-back over per-chunk descriptors:
//   - A CTA takes its chunk from a global ticket counter, so every chunk
//     it waits for belongs to a CTA that already runs or has finished
//     (no spin can deadlock); the CTA with the last ticket resets it.
//   - Descriptors are one 64-bit word each, (epoch << 1 | inclusive) in
//     the high half and the value in the low half, stored and loaded with
//     relaxed device-scope accesses: a descriptor carries its value, and
//     publishes nothing else. The scratch is the wrapper's, made once and
//     reused: the epoch of each call makes an earlier call's descriptors
//     read as not ready, so nothing is cleared per call.
//   - Carry 1: a chunk with a mismatch publishes it as its inclusive
//     value at once (positions grow); one with none publishes an
//     aggregate and looks back, 32 * kLookBack predecessors at a time
//     (each lane loads kLookBack at once), to the nearest inclusive one.
//     Only a chunk whose first position repeats the one before needs it;
//     a row's first chunk always starts with a mismatch.
//   - Carry 2: with carry 1 known the chunk counts its code bits and
//     publishes them as an aggregate; warp 0 sums its predecessors'
//     aggregates back to the nearest inclusive prefix while the other
//     warps pack their codes.
//   - Codes are packed chunk-relative (from bit 0 of a shared-memory word
//     buffer), in registers: a thread assembles its words with shifts
//     and stores them plainly, with at most two shared atomicOr (its
//     first and last word, which neighbour threads share). The store
//     shifts the buffer to the chunk's bit offset (funnel shifts), swaps
//     to big-endian and writes each interior word once, coalesced.
//   - The chunk's first and last partial words, which neighbour chunks
//     share, go with their word index to a per-chunk side array. The
//     CTA that finishes its row last (a per-row counter, reset by that
//     CTA) puts them together: a chunk's last partial holds its word's
//     first bit, so each shared word has one; it is stored, then the
//     first partials of the chunks that start inside that word are ORed
//     into it (merge_edges).
//   - The words past a row's last bit must read zero, as the plain
//     version's do. kZeroWords-word slabs of them are cleared by CTAs
//     whose tickets follow all chunks', each waiting only for its row's
//     last chunk's inclusive bit count. So nothing is zeroed first, and
//     every word but the shared ones is written once.
//
// What bounds it: bytes in principle (the int16 streams read once, the
// rows written once: 4.7 us at the north star's 80 x 65560 values). On an
// H100 (700 W) it takes about 0.031 ms there: each CTA is a chain of
// phases (the load, two CTA scans, the look-back's L2 round trips, the
// pack, the stores) that five 256-thread CTAs a SM only partly overlap;
// the pack is about a sixth of it. A one-row stream (the whole-image
// tile, 0.035 ms) adds a tail after its last chunk: the edge merge and
// the zero tail, most of its 5.2 MB of output.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // positions a CTA; K3_CHUNK in ops/kagari_device.py
constexpr int kTrigger = 2;                 // RLE_TRIGGER
constexpr int kFlush = 65534;               // FLUSH_COUNTER
// a position codes at most 32 bits (a literal and a 1-bit end token at
// rc == 2), so a chunk spans at most kChunk words, and the shifted store
// reads one more
constexpr int kWordsCap = kChunk + 2;
constexpr int kPad = 8;                     // staged values start 16 bytes in
constexpr int kMinBlocks = 5;               // CTAs a SM: at most 51 registers a thread
constexpr int kLookBack = 1;                // descriptors a lane reads a look-back step
constexpr int kStash = kWordsCap / 2;       // chunks' first partials merge_edges keeps in smem
constexpr int kZeroWords = 16384;           // words a zero-tail CTA clears
// 32 bits a position at most: a row's bit count fits in 32 bits
constexpr long long kMaxN = 1LL << 27;
constexpr unsigned kNone = 0xFFFFFFFFu;     // an empty side-array entry

typedef unsigned long long u64;

struct Args {
    const int16_t* values;  // (rows, n)
    uint32_t* out;          // (rows, row_words)
    long long* totals;      // (rows,) compressed bytes
    u64* mm;                // per chunk: last-mismatch descriptor (value: position + 1)
    u64* bits;              // per chunk: bit-count descriptor
    uint2* edges;           // per chunk: first and last partial word (index, bits)
    unsigned* ticket;
    unsigned* done;         // per row: chunks finished
    int rows, n, chunks, row_words, zero_slabs;
    unsigned epoch;
};

struct Max {
    template <typename T>
    __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Add {
    template <typename T>
    __device__ T operator()(T a, T b) const { return a + b; }
};

// Exclusive scan of x over the CTA's threads in thread order: a
// warp-shuffle scan, then one pass over the warps' totals in shared
// memory. *total gets the whole CTA's. Every thread must call it.
template <typename T, typename Op>
__device__ T cta_exclusive_scan(T x, T identity, Op op, T* total) {
    __shared__ T warp_total[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = op(incl, y);
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        T w = lane < kWarps ? warp_total[lane] : identity;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, w, off);
            if (lane >= off) w = op(w, y);
        }
        if (lane < kWarps) warp_total[lane] = w;
    }
    __syncthreads();
    T excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = identity;
    if (warp > 0) excl = op(warp_total[warp - 1], excl);
    *total = warp_total[kWarps - 1];
    __syncthreads();  // warp_total is free for the next scan
    return excl;
}

// ---------------------------------------------------------- descriptors

__device__ __forceinline__ u64 descriptor(unsigned epoch, bool inclusive, unsigned value) {
    return ((u64)((epoch << 1) | (inclusive ? 1u : 0u)) << 32) | value;
}
__device__ __forceinline__ bool is_inclusive(u64 d) { return (d >> 32) & 1u; }
__device__ __forceinline__ unsigned value_of(u64 d) { return (unsigned)d; }

// A descriptor carries its value itself (nothing else is published
// through it), so relaxed 64-bit accesses at device scope suffice: a
// window's loads then overlap instead of each waiting for the last.
__device__ __forceinline__ void publish(u64* p, u64 d) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(d) : "memory");
}

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
    u64 d;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(d) : "l"(p) : "memory");
    return d;
}

__device__ __forceinline__ bool is_ready(u64 d, unsigned epoch) { return (unsigned)(d >> 33) == epoch; }

// Spin until this call's descriptor is at p. Its writer holds an earlier
// ticket, so it runs or has finished.
__device__ __forceinline__ u64 wait_ready(const u64* p, unsigned epoch) {
    u64 d = load_relaxed(p);
    while (!is_ready(d, epoch)) {
        __nanosleep(32);
        d = load_relaxed(p);
    }
    return d;
}

// A look-back window, read by warp 0: the 32 * kLookBack chunks before
// chunk base + 1, nearest first (x[i] of lane l is chunk base - l - 32 i;
// 0 before the row's first chunk), all loaded at once, then each reloaded
// until it is this call's.
__device__ __forceinline__ void load_window(const u64* d, int base, unsigned epoch,
                                            u64 (&x)[kLookBack]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kLookBack; ++i) {
        const int j = base - lane - 32 * i;
        x[i] = j >= 0 ? load_relaxed(d + j) : 0ull;
    }
#pragma unroll
    for (int i = 0; i < kLookBack; ++i) {
        const int j = base - lane - 32 * i;
        while (j >= 0 && !is_ready(x[i], epoch)) {
            __nanosleep(32);
            x[i] = load_relaxed(d + j);
        }
    }
}

// Carry 1, by warp 0: the last mismatch before chunk idx (> 0) of the
// row whose descriptors start at d. A chunk that holds a mismatch is
// inclusive from the start, and chunk 0 always holds one.
__device__ int look_back_mismatch(const u64* d, int idx, unsigned epoch) {
    for (int base = idx - 1;; base -= 32 * kLookBack) {
        u64 x[kLookBack];
        load_window(d, base, epoch, x);
#pragma unroll
        for (int i = 0; i < kLookBack; ++i) {
            const unsigned hit = __ballot_sync(0xffffffffu, is_inclusive(x[i]));
            if (hit) return (int)__shfl_sync(0xffffffffu, value_of(x[i]), __ffs(hit) - 1) - 1;
        }
    }
}

// Carry 2, by warp 0: the bits of the row's chunks before idx (> 0): the
// aggregates back to the nearest inclusive prefix, and that prefix.
__device__ unsigned look_back_bits(const u64* d, int idx, unsigned epoch) {
    const int lane = threadIdx.x & 31;
    unsigned sum = 0;
    for (int base = idx - 1;; base -= 32 * kLookBack) {
        u64 x[kLookBack];
        load_window(d, base, epoch, x);
#pragma unroll
        for (int i = 0; i < kLookBack; ++i) {
            const unsigned hit = __ballot_sync(0xffffffffu, is_inclusive(x[i]));
            const int stop = hit ? __ffs(hit) - 1 : 31;
            sum += __reduce_add_sync(0xffffffffu, lane <= stop ? value_of(x[i]) : 0u);
            if (hit) return sum;
        }
    }
}

// ---------------------------------------------------------------- codes

__device__ __forceinline__ int gamma_bits(uint32_t u) {  // u < 2^16
    return u ? 2 * (31 - __clz(u)) + 1 : 1;
}

// This thread's positions: v[j + 1] is position first + j, v[0] the one
// before and v[kItems + 1] the one after. At a row's ends those two are
// made to differ from their neighbour (stage), so that position 0 is a
// mismatch and the last position ends its run.
struct Items {
    int v[kItems + 2];
    int first;  // row position of the thread's first item
    int count;  // items of the thread inside the chunk (0..kItems)
};

__device__ __forceinline__ Items items_of(const int16_t* sv, int start, int len) {
    static_assert(kItems % 4 == 0, "a thread's values are read 8 bytes at a time or more");
    Items it;
    const int k0 = threadIdx.x * kItems;
    uint32_t w[kItems / 2];
#pragma unroll
    for (int i = 0; i < kItems / 2; i += 4) {
        if constexpr (kItems % 8 == 0) {
            const uint4 q = *reinterpret_cast<const uint4*>(sv + kPad + k0 + 2 * i);
            w[i] = q.x, w[i + 1] = q.y, w[i + 2] = q.z, w[i + 3] = q.w;
        } else {
            const uint2 q = *reinterpret_cast<const uint2*>(sv + kPad + k0);
            w[0] = q.x, w[1] = q.y;
        }
    }
    it.v[0] = sv[kPad + k0 - 1];
#pragma unroll
    for (int i = 0; i < kItems / 2; ++i) {
        it.v[1 + 2 * i] = (int16_t)(w[i] & 0xFFFFu);
        it.v[2 + 2 * i] = (int16_t)(w[i] >> 16);
    }
    it.v[kItems + 1] = sv[kPad + k0 + kItems];
    it.first = start + k0;
    it.count = max(0, min(kItems, len - k0));
    return it;
}

// The last mismatch at or before the thread's last item, or -1.
__device__ __forceinline__ int own_last_mismatch(const Items& it) {
    int m = -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
        if (j < it.count && it.v[j + 1] != it.v[j]) m = it.first + j;
    return m;
}

// Tokenize the thread's positions, once: c[j] holds position first + j's
// codes as one, its bits above bit 17 and its value below (0 for none).
// A position codes a literal, a run token, or both; both only at run
// counter 2, where the token is gamma(1), the single bit 1, so the two
// make at most 32 bits and a 17-bit value. `last` is the last mismatch
// before the thread's first item. Returns the thread's bits.
__device__ __forceinline__ int tokenize(const Items& it, int last, uint32_t (&c)[kItems]) {
    int bits = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int p = it.first + j, v = it.v[j + 1];
        last = v == it.v[j] ? last : p;
        int rc = p - last;  // 0 at a mismatch; the counter restarts after a flush
        if (rc > kFlush) rc = (rc - 1) % kFlush + 1;
        const bool flush = rc == kFlush;
        const bool lit = rc <= kTrigger;
        const bool tok = flush || (rc >= kTrigger && it.v[j + 2] != v);
        const uint32_t u = ((((uint32_t)v << 1) ^ (uint32_t)(v >> 15)) + 1u) & 0xFFFFu;
        const uint32_t t = flush ? (uint32_t)(kFlush - kTrigger + 1) : (uint32_t)(rc - kTrigger + 1);
        const uint32_t x = lit ? (tok ? u << 1 | 1u : u) : (tok ? t : 0u);
        const int nb = lit ? gamma_bits(u) + tok : (tok ? gamma_bits(t) : 0);
        c[j] = j < it.count ? (uint32_t)nb << 17 | x : 0u;
        bits += (int)(c[j] >> 17);
    }
    return bits;
}

// The thread's codes into the chunk's word buffer from chunk-relative
// bit `o`, assembled in a 64-bit register: each completed word is stored
// plainly, but the first when the thread starts inside it, and the last
// partial one, which neighbour threads share, are ORed.
__device__ __forceinline__ void pack(const uint32_t (&c)[kItems], int o, uint32_t* buf) {
    u64 acc = 0;
    int have = o & 31, w = o >> 5;  // bits in acc (the others' leading bits as zeros), its word
    bool shared_first = have != 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int nb = (int)(c[j] >> 17);  // at most 32: have stays below 64
        acc = acc << nb | (c[j] & 0x1FFFFu);
        have += nb;
        if (have >= 32) {
            have -= 32;
            const uint32_t word = (uint32_t)(acc >> have);
            if (shared_first)
                atomicOr(buf + w, word);
            else
                buf[w] = word;
            shared_first = false;
            ++w;
        }
    }
    if (have) atomicOr(buf + w, (uint32_t)(acc << (32 - have)));
}

// Word k of the chunk's output: the buffer shifted right by `skip` bits.
__device__ __forceinline__ uint32_t out_word(const uint32_t* buf, int k, unsigned skip) {
    return __funnelshift_r(buf[k], k ? buf[k - 1] : 0u, skip);
}

__device__ __forceinline__ uint32_t big_endian(uint32_t x) { return __byte_perm(x, 0u, 0x0123); }

// ---------------------------------------------------------------- CTAs

// Stage the chunk's values, with the one before at sv[kPad - 1] and the
// one after at sv[kPad + len] (at the row's ends, values that differ
// from their neighbour): 16-byte loads when the chunk is whole and
// aligned, else one value a thread.
__device__ __forceinline__ void stage(const Args& a, int row, int start, int len, int16_t* sv) {
    const int16_t* src = a.values + (long long)row * a.n + start;
    if (len == kChunk && ((uintptr_t)src & 15) == 0) {
        for (int k = threadIdx.x; k < kChunk / 8; k += kThreads)
            reinterpret_cast<uint4*>(sv + kPad)[k] = __ldcs(reinterpret_cast<const uint4*>(src) + k);
    } else {
        for (int k = threadIdx.x; k < len; k += kThreads) sv[kPad + k] = src[k];
    }
    if (threadIdx.x == 0) sv[kPad - 1] = start > 0 ? src[-1] : (int16_t)(src[0] ^ 1);
    if (threadIdx.x == 32) sv[kPad + len] = start + len < a.n ? src[len] : (int16_t)(src[len - 1] ^ 1);
}

// The row's shared words. A chunk's last partial holds the first bit of
// its word, so each shared word has exactly one; it is stored first,
// then the first partials of the chunks that start inside it are ORed
// in. One thread a chunk (both entries in one 16-byte load; the first
// partials wait in shared memory, `stash`, for the ORs); a serial walk
// from each last partial to the next would cross every chunk of a run
// that codes no bits (about 20 us on the whole-image tile).
__device__ void merge_edges(const Args& a, int row, uint2* stash) {
    const uint4* e = reinterpret_cast<const uint4*>(a.edges + 2LL * row * a.chunks);
    uint32_t* dst = a.out + (long long)row * a.row_words;
    for (int c = threadIdx.x; c < a.chunks; c += kThreads) {
        const uint4 x = __ldcg(e + c);  // (first index, bits, last index, bits)
        if (x.z < (unsigned)a.row_words) dst[x.z] = big_endian(x.w);  // kNone never is
        if (c < kStash) stash[c] = make_uint2(x.x, x.y);
    }
    __syncthreads();  // the block's stores are visible to its atomics
    for (int c = threadIdx.x; c < a.chunks; c += kThreads) {
        uint2 x;
        if (c < kStash) {
            x = stash[c];
        } else {
            const uint4 y = __ldcg(e + c);
            x = make_uint2(y.x, y.y);
        }
        if (x.x < (unsigned)a.row_words) atomicOr(dst + x.x, big_endian(x.y));
    }
}

__device__ void encode_chunk(const Args& a, int g) {
    // the staged values, then (once every thread holds its items) the
    // chunk's word buffer
    __shared__ __align__(16) union {
        int16_t sv[kChunk + 2 * kPad];
        uint32_t buf[kWordsCap];
    } smem;
    int16_t* sv = smem.sv;
    uint32_t* buf = smem.buf;
    __shared__ int s_carry;
    __shared__ unsigned s_bit0;
    __shared__ bool s_last;
    const int row = g / a.chunks, idx = g % a.chunks;
    const int start = idx * kChunk, len = min(kChunk, a.n - start);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const u64* row_mm = a.mm + (long long)row * a.chunks;
    const u64* row_bits = a.bits + (long long)row * a.chunks;

    stage(a, row, start, len, sv);
    __syncthreads();
    const Items it = items_of(sv, start, len);
    const bool need_carry = sv[kPad] == sv[kPad - 1];

    // carry 1 (the scan's barriers end the reads of sv)
    int chunk_mm;
    const int mm_before = cta_exclusive_scan(own_last_mismatch(it), -1, Max(), &chunk_mm);
    for (int k = threadIdx.x; k < kWordsCap; k += kThreads) buf[k] = 0u;
    if (threadIdx.x == 0)
        publish(a.mm + g, descriptor(a.epoch, chunk_mm >= 0, (unsigned)(chunk_mm + 1)));
    if (need_carry && warp == 0) {
        const int carry = look_back_mismatch(row_mm, idx, a.epoch);
        if (lane == 0) {
            s_carry = carry;
            if (chunk_mm < 0) publish(a.mm + g, descriptor(a.epoch, true, (unsigned)(carry + 1)));
        }
    }
    __syncthreads();

    // carry 2: the aggregate, then warp 0's look-back while the warps pack
    uint32_t codes[kItems];
    const int own = tokenize(it, max(need_carry ? s_carry : -1, mm_before), codes);
    int chunk_bits;
    const int off = cta_exclusive_scan(own, 0, Add(), &chunk_bits);
    if (threadIdx.x == 0)
        publish(a.bits + g, descriptor(a.epoch, idx == 0, (unsigned)chunk_bits));
    if (warp == 0) {  // first, so that the inclusive prefix is out soonest
        const unsigned before = idx ? look_back_bits(row_bits, idx, a.epoch) : 0u;
        if (lane == 0) {
            if (idx) publish(a.bits + g, descriptor(a.epoch, true, before + (unsigned)chunk_bits));
            if (idx == a.chunks - 1) a.totals[row] = ((long long)before + chunk_bits + 7) >> 3;
            s_bit0 = before;
        }
    }
    pack(codes, off, buf);
    __syncthreads();

    // interior words once, coalesced; the partial edges to the side array
    const unsigned bit0 = s_bit0, skip = bit0 & 31, w0 = bit0 >> 5;
    const unsigned end = bit0 + (unsigned)chunk_bits;
    const int nw = chunk_bits ? (int)(((end - 1) >> 5) - w0 + 1) : 0;
    uint32_t* dst = a.out + (long long)row * a.row_words;
    for (int k = threadIdx.x; k < nw; k += kThreads) {
        const bool edge = (k == 0 && skip) || (k == nw - 1 && (end & 31));
        if (!edge && w0 + k < (unsigned)a.row_words) dst[w0 + k] = big_endian(out_word(buf, k, skip));
    }
    if (threadIdx.x == 0) {
        uint2 first = make_uint2(kNone, 0u), tail = make_uint2(kNone, 0u);
        if (nw && skip) first = make_uint2(w0, out_word(buf, 0, skip));
        if (nw && (end & 31) && (nw > 1 || !skip))
            tail = make_uint2(w0 + nw - 1, out_word(buf, nw - 1, skip));
        a.edges[2LL * g] = first;
        a.edges[2LL * g + 1] = tail;
        __threadfence();
        const bool last_done = atomicAdd(a.done + row, 1u) == (unsigned)a.chunks - 1;
        if (last_done) a.done[row] = 0u;  // for the next call
        s_last = last_done;
    }
    __syncthreads();
    if (s_last) {
        __threadfence();
        merge_edges(a, row, reinterpret_cast<uint2*>(buf));
    }
}

// Zero slab z of the rows' tails: the words of a row past its last bit,
// 16 bytes a store where the row's alignment allows.
__device__ void zero_tail(const Args& a, int z) {
    __shared__ unsigned s_end;
    const int row = z / a.zero_slabs, slab = z % a.zero_slabs;
    if (threadIdx.x == 0) {
        const u64* last = a.bits + (long long)row * a.chunks + a.chunks - 1;
        u64 d = wait_ready(last, a.epoch);
        while (!is_inclusive(d)) d = wait_ready(last, a.epoch);
        s_end = value_of(d);
    }
    __syncthreads();
    const long long from = max((long long)slab * kZeroWords, ((long long)s_end + 31) >> 5);
    const long long to = min((long long)(slab + 1) * kZeroWords, (long long)a.row_words);
    if (from >= to) return;
    uint32_t* dst = a.out + (long long)row * a.row_words;
    // words before the first 16-byte boundary, then whole 16 bytes, then the rest
    const long long head = min(to, from + (long long)((-(((uintptr_t)(dst + from)) >> 2)) & 3));
    const long long body = head + ((to - head) & ~3LL);
    if (threadIdx.x < head - from) dst[from + threadIdx.x] = 0u;
    for (long long w = head + 4LL * threadIdx.x; w < body; w += 4LL * kThreads)
        *reinterpret_cast<uint4*>(dst + w) = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < to - body) dst[body + threadIdx.x] = 0u;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) kagari_encode(Args a) {
    __shared__ int s_ticket;
    if (threadIdx.x == 0) {
        const unsigned t = atomicAdd(a.ticket, 1u);
        if (t == gridDim.x - 1) *a.ticket = 0u;  // every CTA has its ticket: reset for the next call
        s_ticket = (int)t;
    }
    __syncthreads();
    const int chunk_ctas = a.rows * a.chunks;
    if (s_ticket < chunk_ctas)
        encode_chunk(a, s_ticket);
    else
        zero_tail(a, s_ticket - chunk_ctas);
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// values: (rows, n) int16; out: (rows, row_words) 32-bit words, the rows'
// bytes (row_words >= ceil(budget / 4)); totals: (rows,) int64 bytes.
// scratch: the caller's, zeroed once and reused, scratch_words 64-bit
// words laid out for up to rows_cap rows and chunks_cap chunks in all:
// 4 * chunks_cap descriptor and side-array words, then one 32-bit ticket
// and rows_cap 32-bit row counters. epoch: 1 .. 2^31 - 1, a new one each
// call on this scratch. One launch on `stream`, no synchronisation.
// Returns the first cudaError_t.
extern "C" int ako_kagari_encode(const int16_t* values, uint32_t* out, long long* totals,
                                 unsigned long long* scratch, long long scratch_words,
                                 int rows_cap, int chunks_cap, unsigned epoch, int rows, int n,
                                 int row_words, void* stream) {
    if (rows == 0) return 0;
    if (rows < 0 || n <= 0 || n > kMaxN || row_words <= 0 || epoch == 0 || epoch >= (1u << 31))
        return (int)cudaErrorInvalidValue;
    const int chunks = (int)((n + kChunk - 1) / kChunk);
    const int zero_slabs = (int)((row_words + (long long)kZeroWords - 1) / kZeroWords);
    const long long chunk_ctas = (long long)rows * chunks;
    const long long grid = chunk_ctas + (long long)rows * zero_slabs;
    if (grid > INT_MAX || rows > rows_cap || chunk_ctas > chunks_cap ||
        4LL * chunks_cap + (rows_cap + 2) / 2 > scratch_words)
        return (int)cudaErrorInvalidValue;
    unsigned* counters = reinterpret_cast<unsigned*>(scratch + 4LL * chunks_cap);
    const Args a{values,
                 out,
                 totals,
                 scratch,
                 scratch + chunks_cap,
                 reinterpret_cast<uint2*>(scratch + 2LL * chunks_cap),
                 counters,
                 counters + 1,
                 rows,
                 n,
                 chunks,
                 row_words,
                 zero_slabs,
                 epoch};
    kagari_encode<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
