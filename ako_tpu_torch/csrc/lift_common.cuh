// C integer semantics and the edge rules shared by the lift kernels
// (lift2d.cu, lift_pyramid.cu): one copy of the truncating power-of-two
// divisions of ops/intmath.py, the int16 store wrap and the wrap-mode tap
// substitutions of ops/wavelets.py.

#pragma once

#include <stdint.h>

namespace ako {

enum { DD137 = 0, CDF53 = 1, HAAR = 2 };
enum { CLAMP = 0, MIRROR = 1, REPEAT = 2, ZERO = 3 };

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

}  // namespace ako
