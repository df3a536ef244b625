// Shared helpers of the hand-written kernels: element conversions between
// the storage type (float or bf16) and the float the arithmetic runs in, an
// aligned vector type for wide loads and stores, the tensor-core building
// blocks of the bfloat16 kernels, and the 3xTF32 ones of the float32
// attention kernels.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Round a float to the storage type and back: the value a tensor of type T
// would hold.  The identity for float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
    return to_float<T>(from_float<T>(v));
}

// V elements of T, aligned so that one load or store moves all of them.
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
    T v[V];
};

// ---------------------------------------------------------------------------
// Tensor-core building blocks shared by the bfloat16 kernels (attention.cu,
// conv3x3.cu): asynchronous copies into shared memory, `ldmatrix` and the
// `mma.sync.m16n8k16` product on bf16 operands with float32 accumulators.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1;
// zeros if !valid (then `src` is not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// 8 and 4 bytes from global to shared memory, asynchronously; zeros if
// !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the groups committed by this thread are still in
// flight: with one group per stage of a ring of S stages, N = S - 1 (or
// S - 2 where the next stage is issued after the wait) leaves the newer
// stages copying while the oldest is read.
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and receives in r[i] the two values of matrix i at
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (transposed with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// Two 8x8 matrices: lanes 0-15 give the row addresses (lane l: row l % 8 of
// matrix l / 8), the other lanes' addresses are not read.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
}

// c += a b for a 16x16 bf16 A fragment and a 16x8 B fragment (b0, b1).
// Lane l = 4 g + t holds A at rows g, g + 8 and columns 2t, 2t + 1, 2t + 8,
// 2t + 9 (a0: (g, 2t), a1: (g + 8, 2t), a2: (g, 2t + 8), a3: (g + 8, 2t + 8),
// two values each), B at rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of
// column g, and C at rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// 3xTF32: a float32 product on the TF32 tensor cores.  x = hi + lo + r with
// hi = tf32(x) and lo = tf32(x - hi) (each rounded to nearest, ties away
// from zero), so |r| <= 2^-22 |x|; a b is taken as a_hi b_lo + a_lo b_hi +
// a_hi b_hi, each product exact in the tensor core and summed into a
// float32 accumulator, which leaves out a_lo b_lo (at most 2^-22 |a b|) and
// the r terms.  The tensor core truncates its sums where IEEE float32
// rounds them: on the card that, not the split, is most of the error left.

// x rounded to TF32 as `cvt.rna.tf32.f32` rounds it (to nearest, ties away
// from zero; the low 13 bits zero), by integer arithmetic on its bits: half
// a TF32 step added to the magnitude, then the low bits cleared.  The same
// bits as the instruction for every finite x, in two integer operations; on
// the card the instruction made the attention kernels slower and took more
// registers (PERF.md, the float32 attention findings).
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = cvt_tf32(x);
    lo = cvt_tf32(x - __uint_as_float(hi));
}

// c += a b for a 16x8 TF32 A fragment and an 8x8 B fragment (b0, b1).
// Lane l = 4 g + t holds A at (g, t) (a0), (g + 8, t) (a1), (g, t + 4) (a2),
// (g + 8, t + 4) (a3), B at rows t (b0) and t + 4 (b1) of column g, and C
// as `mma_bf16` does: rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 from the split fragments: the two small products
// first, then the large one.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
    mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
    mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
    mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// ---------------------------------------------------------------------------
// `wgmma` on operands in shared memory in the 128-byte swizzled layout
// (conv3x3.cu, attention_chunked.cu): the descriptor, the layout, and the
// ordering of the asynchronous products and copies.

// A shared-memory matrix descriptor of `wgmma` for a tile in the 128-byte
// swizzled layout: rows of 128 bytes, 16-byte chunk c of row r at r * 128 +
// ((c ^ r % 8) << 4), 8-row groups 1024 bytes apart (SBO); LBO is the
// distance between 64-column atoms of an N-major operand.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes) {
    return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
           (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// The byte offset of 16-byte chunk c of row r in the swizzled layout.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
    return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's shared-memory writes (cp.async) visible to `wgmma`,
// which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
