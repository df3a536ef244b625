// What the two attention sources share (attention.cu: the kernels for a
// head of up to 64 columns whose row is a multiple of 16 bytes;
// attention_chunked.cu: every other head of up to 256 columns): the blocks'
// geometry, the copies into shared memory, the softmax's reductions, the
// stores and the launch-time shared memory limit.  attention.cu's opening
// note gives the design.
#pragma once

#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;                     // warps of a block, 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int TILE = WARPS * 16;             // a block's rows, and the rows of a shared tile
constexpr int STAGES = 2;                    // tiles in the cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

// 2^x by the special-function unit (`ex2.approx.ftz`): relative error about
// 2^-22, results below 2^-126 flushed to 0.  On the card it gave the same
// output bits as exp2f at every shape chip_smoke.py checks, and a faster
// backward.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

constexpr int CH = 64;          // columns of a chunk (attention_chunked.cu)
constexpr int MAX_CHUNKS = 4;   // chunks of a head: hs <= 256
constexpr int NARROW_MAX = 64;  // the widest head of attention.cu's kernels

// ---------------------------------------------------------------------------
// Copies into shared memory, both types.

// W bytes from global to shared memory, asynchronously; zeros if !valid.
template <int W> __device__ __forceinline__ void cp_async_w(void* dst, const void* src, bool valid);
template <> __device__ __forceinline__ void cp_async_w<16>(void* d, const void* s, bool v) {
    cp_async16(d, s, v);
}
template <> __device__ __forceinline__ void cp_async_w<8>(void* d, const void* s, bool v) {
    cp_async8(d, s, v);
}
template <> __device__ __forceinline__ void cp_async_w<4>(void* d, const void* s, bool v) {
    cp_async4(d, s, v);
}

// Copies rows [r0, r0 + TILE) of a head's columns [0, cols) (row r at src +
// r * stride) into the first `width` columns of a tile whose rows are `ld`
// values apart, in pieces of W bytes (W divides cols * sizeof(E) and width *
// sizeof(E)); rows at or past n and columns at or past cols are zero-filled.
// Pieces of 2 bytes (bfloat16 at an odd head size) are plain loads and
// stores, which the barrier after the ring's wait shows to the block as well.
template <typename E, int W>
__device__ __forceinline__ void copy_rows_w(E* dst, int ld, int width, const E* src, size_t stride,
                                            int r0, int n, int cols) {
    constexpr int V = W / (int)sizeof(E);  // values a piece
    const int per_row = width / V;
#pragma unroll
    for (int e = threadIdx.x; e < TILE * per_row; e += THREADS) {
        const int r = e / per_row, c = e % per_row * V;
        const bool valid = r0 + r < n && c < cols;
        E* d = dst + r * ld + c;
        const E* s = src + (valid ? (size_t)(r0 + r) * stride + c : 0);
        if constexpr (W == 2) {
            *reinterpret_cast<uint16_t*>(d) = valid ? *reinterpret_cast<const uint16_t*>(s) : 0;
        } else {
            cp_async_w<W>(d, s, valid);
        }
    }
}

// Multiplies by `scale` (rounding to E: qs) the pieces of a tile that this
// thread copied with `copy_rows_w` at the same width and piece: its own copies
// are visible to it once its wait returns, before the block's barrier.
template <typename E, int W>
__device__ __forceinline__ void scale_rows_w(E* dst, int ld, int width, float scale) {
    constexpr int V = W / (int)sizeof(E);
    const int per_row = width / V;
#pragma unroll
    for (int e = threadIdx.x; e < TILE * per_row; e += THREADS) {
        Vec<E, V>* piece = reinterpret_cast<Vec<E, V>*>(dst + e / per_row * ld + e % per_row * V);
        Vec<E, V> v = *piece;
#pragma unroll
        for (int k = 0; k < V; ++k) v.v[k] = from_float<E>(to_float<E>(v.v[k]) * scale);
        *piece = v;
    }
}

// The accumulator fragment of n-tile j (rows g, g + 8; columns 2t, 2t + 1)
// as half of the A fragment of k-step j / 2 of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, float c0, float c1, float c2,
                                       float c3) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(c0, c1);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c2, c3);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Writes the warp's 16 x 8NT float32 accumulator times `mul`, rounded to E,
// to rows `row` and row + 8 (lane 4g + t: row = first + g) of dst (row r at
// dst + r * stride); rows at or past n and columns at or past cols are
// skipped.  With `odd` (an odd head size: a pair of values is not aligned
// to its own size) value by value; attention.cu's kernels pass false.
template <typename E, int NT>
__device__ __forceinline__ void store_acc(E* dst, size_t stride, int row, int n,
                                          const float (&acc)[NT][4], int cols, bool odd,
                                          float mul0, float mul1) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        if (r >= n) continue;
        const float mul = i ? mul1 : mul0;
        E* p = dst + (size_t)r * stride;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = 8 * j + 2 * t;
            if (c >= cols) continue;
            const float x = acc[j][2 * i] * mul, y = acc[j][2 * i + 1] * mul;
            if (!odd) {
                store_pair(p + c, x, y);
            } else {
                p[c] = from_float<E>(x);
                if (c + 1 < cols) p[c + 1] = from_float<E>(y);
            }
        }
    }
}

// Scores of keys at or past T_len set to -inf, in NJ n-tiles whose first
// key is k0 (lane 4g + t: keys k0 + 8j + 2t and k0 + 8j + 2t + 1).
template <int NJ>
__device__ __forceinline__ void mask_keys(float (&s)[NJ][4], int k0, int T_len) {
    if (k0 + 8 * NJ <= T_len) return;
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= T_len) s[j][e] = -INFINITY;
}

// The kernels, per device, whose dynamic shared memory limit is set.
std::mutex g_mutex;
std::set<std::pair<int, const void*>> g_prepared;

// Before a kernel's first launch on a device: allow it `bytes` of dynamic
// shared memory (beyond the 48 KB a launch may take without asking).
template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), int bytes) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const std::pair<int, const void*> key(device, reinterpret_cast<const void*>(kernel));
    std::lock_guard<std::mutex> lock(g_mutex);
    if (g_prepared.count(key)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) g_prepared.insert(key);
    return err;
}

}  // namespace

// attention_chunked.cu's launchers: the arguments and the result of
// attention.cu's `unet_qkv_attention_fwd` and `unet_qkv_attention_bwd`.
int attention_fwd_chunked(const void* qkv, void* out, int B, int T_len, int C, int NH,
                          float scale, int is_bf16, cudaStream_t stream);
int attention_bwd_chunked(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                          int T_len, int C, int NH, float scale, int is_bf16,
                          cudaStream_t stream);
