// C integer semantics, the edge rules, the lifting steps, the windows in
// shared memory, the colour transforms and the quantizer shared by the
// lift kernels (lift2d.cu, lift_pyramid.cu, lift_level.cu, vlift.cu): one
// copy of the truncating power-of-two divisions of ops/intmath.py, the
// int16 store wrap, the wrap-mode tap substitutions of ops/wavelets.py,
// the pairs and samples a window holds (REPEAT's modulo, the fake odd
// sample) and its 16-byte copies, and the transforms of
// ops/colorspace.py.

#pragma once

#include <stdint.h>

namespace ako {

enum { DD137 = 0, CDF53 = 1, HAAR = 2 };
enum { CLAMP = 0, MIRROR = 1, REPEAT = 2, ZERO = 3 };
enum { YCOCG = 0, SUBTRACT_G = 1, COLOR_NONE = 2, YCOCG_Q = 3 };
enum { PREDICT = 0, UPDATE = 1, UNDO_UPDATE = 2, UNDO_PREDICT = 3 };

__device__ __forceinline__ int div2(int x) { return (x + ((x >> 31) & 1)) >> 1; }
__device__ __forceinline__ int div4(int x) { return (x + ((x >> 31) & 3)) >> 2; }
__device__ __forceinline__ int div16(int x) { return (x + ((x >> 31) & 15)) >> 4; }
__device__ __forceinline__ int div32(int x) { return (x + ((x >> 31) & 31)) >> 5; }
__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }

// Index of the tap at i + d (d in -2..2) in a stream of n samples, or
// -1 where the tap is zero. Out-of-range taps follow the reference's
// substitutions (ops/wavelets.py _shift_prev/_shift_next/_shift_prev2/
// _shift_next2): on +-1, CLAMP and MIRROR repeat the edge sample; on
// +-2, MIRROR takes x[1], x[2] at the head and x[n-3], x[n-2] at the
// tail; REPEAT wraps around; ZERO gives 0.
__device__ __forceinline__ int tap(int i, int d, int n, int wrap) {
    const int k = i + d;
    if (k >= 0 && k < n) return k;
    if (wrap == ZERO) return -1;
    if (d == -1) return wrap == REPEAT ? n - 1 : 0;
    if (d == 1) return wrap == REPEAT ? 0 : n - 1;
    if (d == -2) {  // i is 0 or 1
        if (wrap == CLAMP) return 0;
        if (wrap == MIRROR) return i + 1;
        return n - 2 + i;  // REPEAT
    }
    // d == 2, i is n-2 or n-1
    if (wrap == CLAMP) return n - 1;
    if (wrap == MIRROR) return i - 1;
    return i - (n - 2);  // REPEAT
}

// The lifting steps on one line of a level: pair m = (even 2m, odd 2m+1)
// of n pairs at line[(2 * (m - base) + {0, 1}) * step], so a line that
// holds only pairs from `base` on (lift_level.cu's windows) takes global
// pair indices. A fake odd sample (k >= n_real) is the even one. EDGE: k
// is within two pairs of an end, and the taps follow the wrap rules; else
// every tap is in the line. Every substituted tap lies within the taps
// of an inner pair (predict: k-1 .. k+2, update: k-2 .. k+1).
template <int WAV, int KIND, bool EDGE>
__device__ __forceinline__ void lift_step(int16_t* line, int step, int k, int n, int n_real,
                                          int wrap, int base = 0) {
    // the edge taps' loads are unconditional (a zero tap reads the pair
    // itself and drops it), so a step's loads go out back to back
    auto at = [&](int m, int odd) -> int { return line[(2 * (m - base) + odd) * step]; };
    auto ev = [&](int d) -> int {
        if (!EDGE) return at(k + d, 0);
        const int m = tap(k, d, n, wrap);
        const int v = at(m < 0 ? k : m, 0);
        return m < 0 ? 0 : v;
    };
    auto hp = [&](int d) -> int {
        if (!EDGE) return at(k + d, 1);
        const int m = tap(k, d, n, wrap);
        const int v = at(m < 0 ? k : m, 1);
        return m < 0 ? 0 : v;
    };
    int16_t* even = line + 2 * (k - base) * step;
    int16_t* odd = even + step;
    if (KIND == PREDICT || KIND == UNDO_PREDICT) {
        const int e = *even, o_slot = *odd;  // a fake odd slot is padding: read, then dropped
        const int o = (KIND == UNDO_PREDICT || k < n_real) ? o_slot : e;
        int r;
        if (WAV == HAAR) r = KIND == PREDICT ? o - e : o + e;
        else if (WAV == CDF53) r = KIND == PREDICT ? o - div2(e + ev(1)) : o + div2(e + ev(1));
        else {
            const int t = div16(ev(-1) + ev(2) - 9 * (e + ev(1)));
            r = KIND == PREDICT ? o + t : o - t;
        }
        *odd = (int16_t)r;
    } else {
        if (WAV == HAAR) return;
        const int h = *odd;
        const int t = WAV == CDF53 ? div4(hp(-1) + h) : div32(-hp(-2) - hp(1) + 9 * (hp(-1) + h));
        *even = (int16_t)(KIND == UPDATE ? *even + t : *even - t);
    }
}

// Windows of a line in shared memory (lift_level.cu, vlift.cu): a CTA
// loads a region of a line's pairs and a halo around it, and the lift
// runs on the window.

// The two rules of a window's slots. REPEAT's pair for pair index p of a
// line of n pairs is p modulo n; the sample in pair p's even (odd = 0) or
// odd (odd = 1) slot of a line of len samples is 2 p + odd, the fake odd
// sample of an odd line its even one, also where it arrives as REPEAT's
// wrapped halo.
__device__ __forceinline__ int repeat_pair(int p, int n) { return ((p % n) + n) % n; }
__device__ __forceinline__ int pair_sample(int p, int odd, int len) { return min(2 * p + odd, len - 1); }

// The line's pair (of n) that a window holds for pair index p, and its
// sample for sample index s (pair s >> 1, parity s & 1); -1 off the line
// (vlift.cu's tiles, which are not clipped to the line).
__device__ __forceinline__ int line_pair(int p, int n, bool rep) {
    if (rep) return repeat_pair(p, n);
    return p >= 0 && p < n ? p : -1;
}
__device__ __forceinline__ int line_sample(int s, int len, bool rep) {
    const int p = line_pair(s >> 1, (len + 1) / 2, rep);
    return p < 0 ? -1 : pair_sample(p, s & 1, len);
}

// One axis of a CTA's window: of a line of len samples (n pairs), the
// region's pairs [r0, r1), the idx-th run of `region` pairs from pair p0
// cut at p1 (the whole line: 0 and n; lift_level.cu's row windows: a
// shard's pairs), and the window's pairs [lo, hi), the region and its
// halo, clipped to the line or, for REPEAT, taken modulo n.
struct Axis {
    int len, n, r0, r1, lo, hi;
    bool rep;
    __device__ Axis(int len_, int region, int idx, int halo_, bool rep_, int p0, int p1)
        : len(len_), n((len_ + 1) / 2), rep(rep_) {
        r0 = p0 + idx * region;
        r1 = min(r0 + region, p1);
        lo = rep ? r0 - halo_ : max(r0 - halo_, 0);
        hi = rep ? r1 + halo_ : min(r1 + halo_, n);
    }
    // the line's pair at window pair i (the window lies on the line but
    // for REPEAT's)
    __device__ __forceinline__ int pair(int i) const { return rep ? repeat_pair(lo + i, n) : lo + i; }
    // the line's sample at window slot j (pair lo + j/2, parity j & 1)
    __device__ __forceinline__ int sample(int j) const { return pair_sample(pair(j >> 1), j & 1, len); }
    __device__ __forceinline__ bool edge(int k) const { return !rep && (k < 2 || k >= n - 2); }
};

// 16-byte copies from device memory into shared memory, in flight until
// waited for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The first three planes of a pixel (r, g, b) after the forward colour
// transform `color` (not COLOR_NONE).
__device__ __forceinline__ void colour_yuv(int r, int g, int b, int color, int* out) {
    if (color == SUBTRACT_G) {
        out[0] = g;
        out[1] = wrap16(r - g);
        out[2] = wrap16(b - g);
        return;
    }
    const int co = wrap16(r - b);
    const int tmp = wrap16(b + div2(co));
    const int cg = wrap16(g - tmp);
    const int y = wrap16(tmp + div2(cg));
    out[0] = color == YCOCG_Q ? wrap16(y * 2) : y;
    out[1] = co;
    out[2] = cg;
}

// Channel ch of one pixel of C channels after discard-non-visible and the
// forward colour transform (ops/colorspace.py to_planar_yuv).
__device__ __forceinline__ int colour_fwd(const uint8_t* px, int C, int ch, int color, int discard) {
    const bool hide = discard && (C == 2 || C == 4) && px[C - 1] == 0;
    auto val = [&](int k) -> int { return hide && k < C - 1 ? 0 : px[k]; };
    if (C < 3 || ch >= 3 || color == COLOR_NONE) return val(ch);
    int yuv[3];
    colour_yuv(val(0), val(1), val(2), color, yuv);
    return ch == 0 ? yuv[0] : ch == 1 ? yuv[1] : yuv[2];
}

__device__ __forceinline__ uint8_t saturate(int x) { return (uint8_t)min(max(x, 0), 255); }

// The saturated u8 pixel v[0..C) from its planar values val(0..C) after
// the inverse colour transform (ops/colorspace.py to_interleaved_u8).
template <class V>
__device__ __forceinline__ void colour_inv(const V& val, int C, int color, uint8_t* v) {
    int k0 = 0;
    if (C >= 3 && color != COLOR_NONE) {
        int y = val(0);
        const int u = val(1), vv = val(2);
        int rr, gg, bb;
        if (color == SUBTRACT_G) {
            rr = wrap16(u + y);
            gg = y;
            bb = wrap16(vv + y);
        } else {
            if (color == YCOCG_Q) y = wrap16(div2(y));
            const int tmp = wrap16(y - div2(vv));
            gg = wrap16(vv + tmp);
            bb = wrap16(tmp - div2(u));
            rr = wrap16(bb + u);
        }
        v[0] = saturate(rr);
        v[1] = saturate(gg);
        v[2] = saturate(bb);
        k0 = 3;
    }
    for (int k = k0; k < C; ++k) v[k] = saturate(val(k));
}

// C's truncating x / qd for |x| <= 32768 and qd >= 1. For 1 < qd < 2^16,
// floor(|x| / qd) is the high word of |x| * ceil(2^32 / qd): the
// product's error stays under |x| / 2^32 < 1 / qd, so one multiply
// replaces the division.
struct Divider {
    int qd;
    unsigned m;
    Divider() = default;  // so that a table of them can live in shared memory
    __device__ explicit Divider(int qd_)
        : qd(qd_), m(qd_ > 1 && qd_ < 65536 ? (unsigned)(((1ull << 32) + qd_ - 1) / qd_) : 0u) {}
    __device__ __forceinline__ int operator()(int x) const {
        if (m == 0) return qd == 1 ? x : x / qd;
        const int f = (int)__umulhi((unsigned)abs(x), m);
        return x < 0 ? -f : f;
    }
};

}  // namespace ako
