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
// What the kernels that cut a head into chunks of CH columns share
// (attention_chunked.cu, attention_wide.cu).

__device__ __forceinline__ void zero_acc(float (&a)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
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

// ---------------------------------------------------------------------------
// The blocks of the kernels that cut a head into chunks of CH columns and
// sum their groups' partial scores in shared memory (attention_chunked.cu;
// attention_wide.cu, whose blocks are the same blocks in a cluster): their
// geometry, copies and products.

// A block's geometry by type: ROWS own rows (a group's: 16 a warp), KEYS
// rows of the other side a stage, at most DKV_THREADS threads a block of
// the dk/dv kernel (`dkv_chunks`).
template <typename E> struct Geo;
template <> struct Geo<bf16> {
    static constexpr int ROWS = 64, KEYS = 32, DKV_THREADS = 384;
};
template <> struct Geo<float> {
    static constexpr int ROWS = 32, KEYS = 32, DKV_THREADS = 256;
};

constexpr int ALIGN = 1024;  // the swizzle's period: tiles start 1024-byte aligned

// The tiles of the chunked kernels of type E.
template <typename E> struct Tiles {
    using Elem = E;
    static constexpr int ROWS = Geo<E>::ROWS, KEYS = Geo<E>::KEYS;
    static constexpr int GT = ROWS / 16 * 32;             // threads of a group
    static constexpr int NJ = KEYS / 8;                   // n-tiles of a warp's scores
    static constexpr int RB = CH * (int)sizeof(E);        // bytes of a tile row
    static constexpr int OWN = ROWS * RB;                 // a chunk tile of own rows
    static constexpr int STAGE = KEYS * RB;               // a chunk tile of a stage
    static constexpr int PART = ROWS * KEYS * 4;          // a group's float32 partial
    static constexpr int XV = PART / 16;                  // its float4s
};

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have

// The chunks each group of the dk/dv kernel takes: one, or, where nd groups
// would pass DKV_THREADS, as many as keep the block within it (bfloat16 at
// four chunks: two warpgroups of two chunks, whose dk and dv take 128
// registers a thread, where four warpgroups would have 128 in all).
template <typename E> __host__ __device__ constexpr int dkv_chunks(int nd) {
    return (nd * Tiles<E>::GT + Geo<E>::DKV_THREADS - 1) / Geo<E>::DKV_THREADS;
}

// The byte offset of 16-byte piece c of row r in a chunk tile: conv3x3.cu's
// 128-byte swizzle, with rows of 256 bytes in float32.
template <typename E> __device__ __forceinline__ uint32_t tile_at(int r, int c) {
    if constexpr (sizeof(E) == 2) {
        return swizzled(r, c);
    } else {
        return (uint32_t)(r * CH * (int)sizeof(E) + ((c ^ (r & 7)) << 4));
    }
}

// ---------------------------------------------------------------------------
// Copies.

// Rows [r0, r0 + R) of the head's columns [0, hs) (row r at src + r *
// stride) into ND chunk tiles of R rows (tile d at dst + d * R * RB: columns
// 64 d ..), in pieces of W bytes by the block's NT threads; rows at or past
// n and columns at or past hs are zero.  With SCALE, the pieces this thread
// copied are multiplied by `scale` and rounded to E instead (qs; after the
// thread's wait, which shows it its own copies).
template <typename E, int ND, int R, int NT, int W, bool SCALE>
__device__ __forceinline__ void tiles_w(unsigned char* dst, const E* src, size_t stride, int r0,
                                        int n, int hs, float scale) {
    constexpr int V = W / (int)sizeof(E);  // values a piece
    constexpr int PR = CH / V;             // pieces a tile row
#pragma unroll 2
    for (int e = threadIdx.x; e < ND * R * PR; e += NT) {
        const int d = e / (R * PR), r = e / PR % R, p = e % PR;
        unsigned char* to = dst + d * R * CH * (int)sizeof(E) + tile_at<E>(r, p * W >> 4) +
                            (p * W & 15);
        if constexpr (SCALE) {
            Vec<E, V> v = *reinterpret_cast<Vec<E, V>*>(to);
#pragma unroll
            for (int k = 0; k < V; ++k) v.v[k] = from_float<E>(to_float<E>(v.v[k]) * scale);
            *reinterpret_cast<Vec<E, V>*>(to) = v;
        } else {
            const int c = d * CH + p * V;
            const bool valid = r0 + r < n && c < hs;
            const E* from = src + (valid ? (size_t)(r0 + r) * stride + c : 0);
            if constexpr (W == 2) {
                *reinterpret_cast<uint16_t*>(to) =
                    valid ? *reinterpret_cast<const uint16_t*>(from) : 0;
            } else {
                cp_async_w<W>(to, from, valid);
            }
        }
    }
}

// `tiles_w` with the piece the launcher chose for the launch (16, 8, 4 or,
// bfloat16 only, 2 bytes): the same branch in every thread.
template <typename E, int ND, int R, int NT, bool SCALE = false>
__device__ __forceinline__ void tiles(unsigned char* dst, const E* src, size_t stride, int r0,
                                      int n, int hs, int piece, float scale = 1.f) {
    if (piece == 16) {
        tiles_w<E, ND, R, NT, 16, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if (piece == 8) {
        tiles_w<E, ND, R, NT, 8, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if constexpr (sizeof(E) == 4) {
        tiles_w<E, ND, R, NT, 4, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if (piece == 4) {
        tiles_w<E, ND, R, NT, 4, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else {
        tiles_w<E, ND, R, NT, 2, SCALE>(dst, src, stride, r0, n, hs, scale);
    }
}

// ---------------------------------------------------------------------------
// bfloat16 products on `wgmma` (the group is one warpgroup; every thread of
// it calls them, with the same arguments).

// Keeps the compiler from moving the registers' reads and writes across the
// asynchronous products: before `wgmma_fence` and after `wgmma_wait`.
template <int N> __device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d += a b over k = 16, a 64-row A and an N-column B both K-major in
// shared memory (the scores).
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 8][4], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_scores<32>(float (&d)[4][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b)
        : "memory");
}

// d[0 .. N/8) += a b over k = 16, A from registers (lane 4g + t of warp w:
// rows 16 w + g and + 8, as `mma_bf16`'s A fragment) and an N-column B
// N-major in shared memory (the output products).
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rows<16>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<32>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<48>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

// acc = own tile (64 rows) x other tile (KEYS rows)^T over the chunk's
// first `cols` columns: k-steps of 16 at or past cols are skipped (both
// tiles are zero there).
template <typename T, int CPW>
__device__ __forceinline__ void scores_wgmma(float (&acc)[T::NJ][4], const unsigned char* own,
                                             const unsigned char* other, int c0, int step,
                                             int nd, int hs) {
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
        const int c = c0 + i * step, cols = hs - c * CH;
        if (c >= nd) break;
        const unsigned char* a = own + c * T::OWN;
        const unsigned char* b = other + c * T::STAGE;
#pragma unroll
        for (int ks = 0; ks < CH / 16; ++ks) {
            if (16 * ks >= cols) break;
            wgmma_scores<T::KEYS>(acc, wgmma_desc(a + 32 * ks, 16), wgmma_desc(b + 32 * ks, 16));
        }
    }
    wgmma_commit();
}

// acc += p tile over the tile's KEYS rows, for the scores' accumulator p
// (float32, rounded and packed into A fragments) and a tile whose rows are
// the product's k index, N = cols rounded up to 16 (the tile is zero past
// cols, and acc's columns past cols are never stored).
template <typename T>
__device__ __forceinline__ void output_wgmma(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                             const unsigned char* tile, int cols) {
    constexpr int KSTEPS = T::KEYS / 16;
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
        a[j >> 1][(j & 1) * 2] = pack_bf16(p[j][0], p[j][1]);
        a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
    }
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
    pin(acc);
    wgmma_fence();
    const int n16 = (cols + 15) >> 4;
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t b = wgmma_desc(tile + k * 16 * 128, T::KEYS * 128);
        if (n16 == 4) {
            wgmma_rows<64>(acc, a[k], b);
        } else if (n16 == 3) {
            wgmma_rows<48>(acc, a[k], b);
        } else if (n16 == 2) {
            wgmma_rows<32>(acc, a[k], b);
        } else {
            wgmma_rows<16>(acc, a[k], b);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
}

// ---------------------------------------------------------------------------
// float32 products in 3xTF32 on `mma.sync` (each warp its 16 rows).

// acc = own tile (the warp's rows 16 w ..) x other tile^T over the chunk's
// first `cols` columns in k-steps of 8: the own rows' A fragment by 32-bit
// loads (lane 4g + t: rows g, g + 8, columns t, t + 4), the other tile's B
// fragments by `ldmatrix` (a float as two 16-bit halves).
template <typename T, int CPW>
__device__ __forceinline__ void scores_tf32(float (&acc)[T::NJ][4], const unsigned char* own_base,
                                            const unsigned char* other_base, int c0, int step,
                                            int nd, int hs) {
    constexpr int NJ = T::NJ;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r = (threadIdx.x & (T::GT - 1)) / 32 * 16 + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
    const int c = c0 + i * step, cols = hs - c * CH;
    if (c >= nd) break;
    const unsigned char* own = own_base + c * T::OWN;
    const unsigned char* other = other_base + c * T::STAGE;
#pragma unroll
    for (int ks = 0; ks < CH / 8; ++ks) {
        if (8 * ks >= cols) break;
        auto at = [&](int row, int c) {  // column 8 ks + t (c = 0) or + 4 (c = 1)
            return *reinterpret_cast<const float*>(own + tile_at<float>(row, 2 * ks + c) + 4 * t);
        };
        uint32_t ah[4], al[4];
        split_tf32(at(r, 0), ah[0], al[0]);
        split_tf32(at(r + 8, 0), ah[1], al[1]);
        split_tf32(at(r, 1), ah[2], al[2]);
        split_tf32(at(r + 8, 1), ah[3], al[3]);
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            const int row = 8 * j + (lane & 7) + (lane >> 4) * 8;
            uint32_t b[4];
            ldsm_x4(b, other + tile_at<float>(row, 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                split_tf32(__uint_as_float(b[2 * jj]), bh[j + jj][0], bl[j + jj][0]);
                split_tf32(__uint_as_float(b[2 * jj + 1]), bh[j + jj][1], bl[j + jj][1]);
            }
        }
        // the three products of each n-tile in turn over all n-tiles, so
        // that no product waits for the one before it on its accumulator
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
    }
    }
}

// acc += p tile over the tile's KEYS rows, n-tiles at or past cols skipped
// (the three products of each n-tile in turn over the n-tiles):
// p's accumulator holds keys 2t, 2t + 1 of its n-tile where the A fragment
// holds k = t, t + 4, so k = t is taken as tile row 2t and k = t + 4 as row
// 2t + 1, in A and B alike (attention.cu's float32 note).
template <typename T>
__device__ __forceinline__ void output_tf32(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                            const unsigned char* tile, int cols) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < T::NJ; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32(p[kk][0], ah[0], al[0]);
        split_tf32(p[kk][2], ah[1], al[1]);
        split_tf32(p[kk][1], ah[2], al[2]);
        split_tf32(p[kk][3], ah[3], al[3]);
        const int r = 8 * kk + 2 * t, nn = (cols + 7) / 8;
        uint32_t bh[CH / 8][2], bl[CH / 8][2];
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) {
            const int c = 2 * n + (g >> 2), w = 4 * (g & 3);  // column 8 n + g
            split_tf32(*reinterpret_cast<const float*>(tile + tile_at<float>(r, c) + w), bh[n][0],
                       bl[n][0]);
            split_tf32(*reinterpret_cast<const float*>(tile + tile_at<float>(r + 1, c) + w),
                       bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
    }
}

// The group's score product over its chunks c = c0 + step i < nd (acc =
// the sum of own tile c x other tile c^T; the tiles of chunk c at own + c
// OWN and other + c STAGE), by type: in bfloat16 `scores_start` issues the
// products and `scores_done` waits for them (so the two products of the
// backward are in flight together), in float32 `scores_start` does them.
template <typename T, int CPW = 1>
__device__ __forceinline__ void scores_start(float (&acc)[T::NJ][4], const unsigned char* own,
                                             const unsigned char* other, int c0, int step,
                                             int nd, int hs) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        scores_wgmma<T, CPW>(acc, own, other, c0, step, nd, hs);
    } else {
        scores_tf32<T, CPW>(acc, own, other, c0, step, nd, hs);
    }
}

template <typename T> __device__ __forceinline__ void scores_done(float (&acc)[T::NJ][4]) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        wgmma_wait<0>();
        pin(acc);
    }
}

template <typename T>
__device__ __forceinline__ void output_product(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                               const unsigned char* tile, int cols) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        output_wgmma<T>(acc, p, tile, cols);
    } else {
        output_tf32<T>(acc, p, tile, cols);
    }
}

// The start of the dynamic shared memory, aligned to ALIGN.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    return raw + ((ALIGN - (smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

// The top of each step of a ring: this thread's copies of the stage have
// landed (and, first, the own rows, of which it then scales qs's pieces
// with `scale_own`), `wgmma` may see them, and the block's barrier shows
// them to every thread and says every group is done with the stage before.
template <typename E, typename F>
__device__ __forceinline__ void stage_ready(F&& scale_own) {
    cp_async_wait<0>();
    scale_own();
    if constexpr (sizeof(E) == 2) fence_proxy_async();
    __syncthreads();
}

template <typename E> __host__ __device__ constexpr int dkv_threads(int nd) {
    return (nd + dkv_chunks<E>(nd) - 1) / dkv_chunks<E>(nd) * Tiles<E>::GT;
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
