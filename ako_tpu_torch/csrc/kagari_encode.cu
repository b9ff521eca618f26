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
// Design. A row is cut into chunks of kChunk positions, one CTA each;
// no chunk straddles two rows. A chunk needs two carries from the
// chunks before it: the last mismatch before it (a max) and its first
// bit offset (a sum, which needs the first). Three short launches per
// call give them, with no other device work between:
//   1. kagari_encode_runs: each chunk's last mismatch; its grid also
//      zeroes the output words;
//   2. kagari_encode_bits: a chunk reduces the last mismatches of its
//      row's earlier chunks to its carry and counts its code bits;
//   3. kagari_encode_pack: both carries as in 2, then every code ORed
//      into a shared-memory word buffer (at most two words a code), the
//      words stored coalesced and byte-swapped (__byte_perm); only the
//      chunk's edge words, which its neighbours share, are merged into
//      the zeroed output with a global atomicOr.
// Inside a CTA each thread takes kItems consecutive positions, and a
// warp-shuffle scan plus one shared-memory pass over the warps give it
// its carries. The chunk's values, with one on each side, are staged
// in shared memory by coalesced loads (a skewed layout, so that the
// threads' strided reads do not collide in a bank).
//
// What bounds it: bytes in principle (the int16 streams read once, the
// rows written once: 4.7 us at the north star's 80 x 65560 values), but
// launches 2 and 3 read the values again (mostly from L2) and every
// chunk reduces the carries of all its row's earlier chunks: O(chunks^2)
// words a row, 0.8 M on the whole-image tile's 1280 chunks.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // positions a CTA; K3_CHUNK in ops/kagari_device.py
constexpr int kTrigger = 2;                 // RLE_TRIGGER
constexpr int kFlush = 65534;               // FLUSH_COUNTER
constexpr int kOutside = 0x10000;           // equal to no int16 value: past the row's ends
// a position codes at most 32 bits (a literal and a 1-bit end token at
// rc == 2), so a chunk spans at most kChunk + 1 words
constexpr int kWordsCap = kChunk + 2;
constexpr int kStaged = (kChunk + 2) + ((kChunk + 2) >> 5) + 1;

struct Args {
    const int16_t* values;  // (rows, n)
    uint32_t* out;          // (rows, row_words), zeroed by launch 1
    long long* totals;      // (rows,) compressed bytes
    int* last_mm;           // (rows * chunks,) launch 1's: each chunk's last mismatch or -1
    int* bits;              // (rows * chunks,) launch 2's: each chunk's code bits
    int rows, n, chunks, row_words;
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

// The fold of src[0, count) over the CTA, for every thread.
template <typename T, typename S, typename Op>
__device__ T cta_fold(const S* src, int count, T identity, Op op) {
    T x = identity;
    for (int j = threadIdx.x; j < count; j += kThreads) x = op(x, (T)src[j]);
    T total;
    cta_exclusive_scan(x, identity, op, &total);
    return total;
}

__device__ __forceinline__ int skew(int k) { return k + (k >> 5); }

__device__ __forceinline__ int gamma_bits(uint32_t u) {  // u < 2^16
    return u ? 2 * (31 - __clz(u)) + 1 : 1;
}

struct Chunk {
    int row, index, start, len;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a) {
    Chunk c;
    c.row = blockIdx.x / a.chunks;
    c.index = blockIdx.x % a.chunks;
    c.start = c.index * kChunk;
    c.len = min(kChunk, a.n - c.start);
    return c;
}

// This thread's positions: v[j + 1] is position first + j, v[0] the one
// before (kOutside before the row), v[kItems + 1] the one after.
struct Items {
    int v[kItems + 2];
    int first;  // row position of the thread's first item
    int count;  // items of the thread inside the chunk (0..kItems)
};

// Stage the chunk's values (and one on each side) in shared memory with
// coalesced loads, then give the thread its items.
__device__ __forceinline__ Items load_items(const Args& a, const Chunk& c, int* sv) {
    const int16_t* src = a.values + (long long)c.row * a.n;
    for (int k = threadIdx.x; k < c.len + 2; k += kThreads) {
        const int p = c.start - 1 + k;
        sv[skew(k)] = (p >= 0 && p < a.n) ? (int)src[p] : kOutside;
    }
    __syncthreads();
    Items it;
    const int k0 = threadIdx.x * kItems;
#pragma unroll
    for (int i = 0; i < kItems + 2; ++i) it.v[i] = sv[skew(k0 + i)];
    it.first = c.start + k0;
    it.count = max(0, min(kItems, c.len - k0));
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

// The codes of the thread's positions in stream order, as f(value,
// bits); `last` is the last mismatch before the thread's first item.
template <typename F>
__device__ __forceinline__ void for_each_code(const Items& it, int last, F f) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (j >= it.count) break;
        const int p = it.first + j, v = it.v[j + 1];
        const bool same = v == it.v[j];
        if (!same) last = p;
        const int rc = same ? (p - last - 1) % kFlush + 1 : 0;
        if (!same || rc <= kTrigger) {
            const uint32_t z = (((uint32_t)v << 1) ^ (uint32_t)(v >> 15)) & 0xFFFFu;
            const uint32_t u = (z + 1u) & 0xFFFFu;
            f(u, gamma_bits(u));
        }
        const bool flush = rc == kFlush;
        if (flush || (same && it.v[j + 2] != v && rc >= kTrigger)) {
            const uint32_t t = flush ? (uint32_t)(kFlush - kTrigger + 1) : (uint32_t)(rc - kTrigger + 1);
            f(t, gamma_bits(t));
        }
    }
}

// The last mismatch before the thread's first item: the carry of the
// row's earlier chunks and the scan over the earlier threads.
__device__ __forceinline__ int last_before(const Args& a, const Chunk& c, const Items& it) {
    const int carry = cta_fold(a.last_mm + (long long)c.row * a.chunks, c.index, -1, Max());
    int unused;
    return max(carry, cta_exclusive_scan(own_last_mismatch(it), -1, Max(), &unused));
}

__device__ __forceinline__ int own_bits(const Items& it, int last) {
    int nb = 0;
    for_each_code(it, last, [&](uint32_t, int bits) { nb += bits; });
    return nb;
}

__global__ void __launch_bounds__(kThreads) kagari_encode_runs(Args a) {
    __shared__ int sv[kStaged];
    const long long words = (long long)a.rows * a.row_words;
    for (long long w = blockIdx.x * (long long)kThreads + threadIdx.x; w < words;
         w += (long long)gridDim.x * kThreads)
        a.out[w] = 0u;
    const Chunk c = chunk_of(a);
    const Items it = load_items(a, c, sv);
    int last;
    cta_exclusive_scan(own_last_mismatch(it), -1, Max(), &last);
    if (threadIdx.x == 0) a.last_mm[blockIdx.x] = last;
}

__global__ void __launch_bounds__(kThreads) kagari_encode_bits(Args a) {
    __shared__ int sv[kStaged];
    const Chunk c = chunk_of(a);
    const Items it = load_items(a, c, sv);
    const int last = last_before(a, c, it);
    int total;
    cta_exclusive_scan(own_bits(it, last), 0, Add(), &total);
    if (threadIdx.x == 0) a.bits[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) kagari_encode_pack(Args a) {
    __shared__ int sv[kStaged];
    __shared__ uint32_t words[kWordsCap];
    const Chunk c = chunk_of(a);
    for (int k = threadIdx.x; k < kWordsCap; k += kThreads) words[k] = 0u;
    const long long bit0 = cta_fold(a.bits + (long long)c.row * a.chunks, c.index, 0LL, Add());
    const Items it = load_items(a, c, sv);
    const int last = last_before(a, c, it);
    int chunk_bits;
    const int off = cta_exclusive_scan(own_bits(it, last), 0, Add(), &chunk_bits);

    // words[0] is the output word that holds the chunk's first bit
    const int skip = (int)(bit0 & 31);
    int o = skip + off;
    for_each_code(it, last, [&](uint32_t code, int nb) {
        const int w = o >> 5, s = o & 31;
        const int k1 = min(32 - s, nb), k2 = nb - k1;
        atomicOr(words + w, (code >> k2) << (32 - s - k1));
        if (k2) atomicOr(words + w + 1, code << (32 - k2));
        o += nb;
    });
    __syncthreads();

    const long long end = bit0 + chunk_bits;
    const long long w0 = bit0 >> 5;
    const int nw = chunk_bits ? (int)(((end - 1) >> 5) - w0 + 1) : 0;
    uint32_t* dst = a.out + (long long)c.row * a.row_words;
    for (int k = threadIdx.x; k < nw && w0 + k < a.row_words; k += kThreads) {
        const uint32_t be = __byte_perm(words[k], 0u, 0x0123);
        // the first and last words are shared with the neighbour chunks
        // unless the chunk starts or ends on a word boundary
        if ((k == 0 && skip) || (k == nw - 1 && (end & 31)))
            atomicOr(dst + w0 + k, be);
        else
            dst[w0 + k] = be;
    }
    if (c.index == a.chunks - 1 && threadIdx.x == 0) a.totals[c.row] = (end + 7) >> 3;
}

}  // namespace

// Plain C interface, bound with ctypes (ako_tpu_torch/runtime/kernels.py).
// values: (rows, n) int16; out: (rows, row_words) 32-bit words, the rows'
// bytes (row_words >= ceil(budget / 4)); totals: (rows,) int64 bytes;
// scratch: at least 2 * rows * ceil(n / kChunk) int32. Three launches on
// `stream`, no synchronisation. Returns the first cudaError_t.
extern "C" int ako_kagari_encode(const int16_t* values, uint32_t* out, long long* totals,
                                 int* scratch, long long scratch_ints, int rows, int n,
                                 int row_words, void* stream) {
    if (rows == 0) return 0;
    if (rows < 0 || n <= 0 || row_words <= 0) return (int)cudaErrorInvalidValue;
    const int chunks = (n + kChunk - 1) / kChunk;
    const long long blocks = (long long)rows * chunks;
    if (blocks > INT_MAX || 2 * blocks > scratch_ints) return (int)cudaErrorInvalidValue;
    const Args a{values, out, totals, scratch, scratch + blocks, rows, n, chunks, row_words};
    cudaStream_t s = (cudaStream_t)stream;
    kagari_encode_runs<<<(unsigned)blocks, kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kagari_encode_bits<<<(unsigned)blocks, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kagari_encode_pack<<<(unsigned)blocks, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
}
