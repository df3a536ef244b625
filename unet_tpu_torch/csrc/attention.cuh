// What the three attention sources share (attention.cu: the kernels for a
// head of up to 64 columns whose row is a multiple of 16 bytes;
// attention_chunked.cu: every other head of up to 256 columns;
// attention_wide.cu: every wider head): the blocks' geometry, the copies
// into shared memory, the chunk tiles and their products, the softmax's
// reductions, the stores and the launch-time shared memory limit.
// attention.cu's opening note gives the design.
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

constexpr int CH = 64;          // columns of a chunk (attention_chunked.cu, attention_wide.cu)
constexpr int MAX_CHUNKS = 4;   // chunks of a head in attention_chunked.cu: hs <= 256
constexpr int NARROW_MAX = 64;  // the widest head of attention.cu's kernels
constexpr int MAX_CLUSTER = 8;  // blocks of a cluster in attention_wide.cu (the portable most)

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

// ---------------------------------------------------------------------------
// The chunk tiles and products of the kernels that cut a head into chunks of
// CH columns (attention_chunked.cu, attention_wide.cu).

// `copy_rows_w` with the piece the launcher chose for the launch (16, 8, 4
// or, bfloat16 only, 2 bytes): the same branch in every thread.
template <typename E>
__device__ __forceinline__ void copy_rows(E* dst, int ld, int width, const E* src, size_t stride,
                                          int r0, int n, int cols, int piece) {
    if (piece == 16) {
        copy_rows_w<E, 16>(dst, ld, width, src, stride, r0, n, cols);
    } else if (piece == 8) {
        copy_rows_w<E, 8>(dst, ld, width, src, stride, r0, n, cols);
    } else if constexpr (sizeof(E) == 4) {
        copy_rows_w<E, 4>(dst, ld, width, src, stride, r0, n, cols);
    } else if (piece == 4) {
        copy_rows_w<E, 4>(dst, ld, width, src, stride, r0, n, cols);
    } else {
        copy_rows_w<E, 2>(dst, ld, width, src, stride, r0, n, cols);
    }
}

template <typename E>
__device__ __forceinline__ void scale_rows(E* dst, int ld, int width, float scale, int piece) {
    if (piece == 16) {
        scale_rows_w<E, 16>(dst, ld, width, scale);
    } else if (piece == 8) {
        scale_rows_w<E, 8>(dst, ld, width, scale);
    } else if constexpr (sizeof(E) == 4) {
        scale_rows_w<E, 4>(dst, ld, width, scale);
    } else if (piece == 4) {
        scale_rows_w<E, 4>(dst, ld, width, scale);
    } else {
        scale_rows_w<E, 2>(dst, ld, width, scale);
    }
}

// A chunk tile row: CH values + the padding of attention.cu's tiles at HS = 64
// (LD<64>, LDF<64>), without bank conflicts for the same reasons.
template <typename E> constexpr int CPAD = sizeof(E) == 2 ? 8 : 4;
template <typename E> constexpr int LDC = CH + CPAD<E>;
template <typename E> using ChunkRing = E (*)[TILE][LDC<E>];

__device__ __forceinline__ void zero_acc(float (&a)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// acc += a tile^T over the chunk's first `cols` columns, for the warp's 16
// own rows a (row r at own + r * ld, from shared memory: `ldmatrix`) and a
// chunk tile whose rows are the product's n index: scores from k or qs, dp
// from v or dout.  k-steps at or past cols are skipped (the chunk's columns
// past hs are zero on both sides).
__device__ __forceinline__ void chunk_scores(float (&acc)[8][4], const bf16* own, int ld,
                                             const bf16 (*tile)[LDC<bf16>], int cols) {
    const int lane = threadIdx.x & 31;
    const bf16* a_row = own + ((threadIdx.x >> 5) * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
        if (16 * ks >= cols) break;
        uint32_t a[4];
        ldsm_x4(a, a_row + 16 * ks);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint32_t b[2];
            ldsm_x2(b, &tile[8 * j + (lane & 7)][16 * ks + ((lane >> 3) & 1) * 8]);
            mma_bf16(acc[j], a, b[0], b[1]);
        }
    }
}

// The same in 3xTF32: the own rows' A fragment by 32-bit loads (lane 4g + t:
// rows g, g + 8, columns t, t + 4; rows ld apart fall in banks 4g + t), the
// tile's as `rows_product_f32` reads it.
__device__ __forceinline__ void chunk_scores(float (&acc)[8][4], const float* own, int ld,
                                             const float (*tile)[LDC<float>], int cols) {
    const int lane = threadIdx.x & 31;
    const float* a_row = own + ((threadIdx.x >> 5) * 16 + (lane >> 2)) * ld + (lane & 3);
#pragma unroll
    for (int ks = 0; ks < CH / 8; ++ks) {
        if (8 * ks >= cols) break;
        const float* p = a_row + 8 * ks;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);
        split_tf32(p[8 * ld], ah[1], al[1]);
        split_tf32(p[4], ah[2], al[2]);
        split_tf32(p[8 * ld + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
            uint32_t b[4];
            ldsm_x4(b, &tile[8 * j + (lane & 7) + (lane >> 4) * 8][8 * ks + ((lane >> 3) & 1) * 4]);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                uint32_t bh[2], bl[2];
                split_tf32(__uint_as_float(b[2 * jj]), bh[0], bl[0]);
                split_tf32(__uint_as_float(b[2 * jj + 1]), bh[1], bl[1]);
                mma_3xtf32(acc[j + jj], ah, al, bh, bl);
            }
        }
    }
}

// acc += p tile over the tile's first `cols` columns, for the warp's 16 x
// TILE fragment p (the accumulator of `chunk_scores`, float32) and a chunk
// tile whose rows are the product's k index: out += p v, dq += ds k, dv +=
// p^T dout, dk += ds^T qs.  In bfloat16 p is rounded and packed into A
// fragments (`cols_product`); n-tiles at or past cols are skipped.
__device__ __forceinline__ void chunk_pv(float (&acc)[8][4], const float (&p)[8][4],
                                         const bf16 (*tile)[LDC<bf16>], int cols) {
    const int lane = threadIdx.x & 31;
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pack_a(pf, j, p[j][0], p[j][1], p[j][2], p[j][3]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int pp = 0; pp < CH / 16; ++pp) {
            if (16 * pp >= cols) break;
            uint32_t b[4];
            ldsm_x4_trans(b, &tile[16 * kk + (lane & 7) + (lane & 8)][16 * pp + (lane >> 4) * 8]);
            mma_bf16(acc[2 * pp], pf[kk], b[0], b[1]);
            mma_bf16(acc[2 * pp + 1], pf[kk], b[2], b[3]);
        }
    }
}

// The same in 3xTF32, one k-step of 8 tile rows per n-tile of p as
// `cols_step_f32` takes it.
__device__ __forceinline__ void chunk_pv(float (&acc)[8][4], const float (&p)[8][4],
                                         const float (*tile)[LDC<float>], int cols) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32(p[kk][0], ah[0], al[0]);
        split_tf32(p[kk][2], ah[1], al[1]);
        split_tf32(p[kk][1], ah[2], al[2]);
        split_tf32(p[kk][3], ah[3], al[3]);
        const float* r = &tile[8 * kk + 2 * (lane & 3)][lane >> 2];
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) {
            if (8 * n >= cols) break;
            uint32_t bh[2], bl[2];
            split_tf32(r[8 * n], bh[0], bl[0]);
            split_tf32(r[LDC<float> + 8 * n], bh[1], bl[1]);
            mma_3xtf32(acc[n], ah, al, bh, bl);
        }
    }
}

// The copies' piece for a head of hs values of `itemsize` bytes: the widest
// of 16, 8, 4 and 2 bytes that divides hs * itemsize (so every row of every
// head starts on a piece).
inline int piece_bytes(int hs, int itemsize) {
    const int bytes = hs * itemsize;
    const int low = bytes & -bytes;
    return low < 16 ? low : 16;
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

// attention_chunked.cu's and attention_wide.cu's launchers: the arguments
// and the result of attention.cu's `unet_qkv_attention_fwd` and
// `unet_qkv_attention_bwd`.
int attention_fwd_chunked(const void* qkv, void* out, int B, int T_len, int C, int NH,
                          float scale, int is_bf16, cudaStream_t stream);
int attention_bwd_chunked(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                          int T_len, int C, int NH, float scale, int is_bf16,
                          cudaStream_t stream);
int attention_fwd_wide(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
                       int is_bf16, cudaStream_t stream);
int attention_bwd_wide(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                       int T_len, int C, int NH, float scale, int is_bf16, cudaStream_t stream);
