// Non-causal multi-head attention straight from the packed QKV: forward and
// backward, with bfloat16 on the tensor cores and float32 on FMAs.
//
// Forward.  Replaces the Pallas kernel `_fwd_kernel` of
// unet_tpu/ops/pallas/attention.py:41 (launched by `_fwd_call`, reached
// through `qkv_attention_fused`): qkv is (B, T, 3C) laid out [q | k | v],
// each C split contiguously into (NH, HS); per head qs = q * scale
// rounded to the input type, s = qs k^T in float32, a float32 softmax over
// all keys, out = (p rounded to the input type) v accumulated in float32 and
// written at column h * HS of (B, T, C).  No (B, NH, T, T) tensor reaches
// device memory.
//
// Backward.  Replaces the Pallas kernel `_bwd_kernel` of the same file (:61,
// launched by `_bwd_call`, reached through `_att_bwd`): from qkv and dout
// alone, recompute s and p = softmax(s); dp = dout v^T; ds = p (dp - D) with
// D = rowsum(dp * p); dq = (ds k) * scale, dk = ds^T qs, dv = p^T dout,
// written as d(qkv) (B, T, 3C).  The TPU kernel's rounding points are kept:
// dout is taken in v's type, p stays float32 inside ds, ds and p are rounded
// to the input type before their products, every product accumulates in
// float32.  The TPU kernel adds dk and dv over its query blocks in a scratch
// buffer, relying on the grid running in order; blocks here run in no order,
// so the work is split in two kernels with no atomics: one block per (b, h,
// tile of queries) writes dq and the rows' softmax maximum m, 1 / l and D to
// a (3, B, NH, T) float32 scratch; then one block per (b, h, tile of keys)
// loops over the query tiles and accumulates dk and dv.
//
// Bound on an H100.  The forward reads 3C and writes C values per token and
// does 4 * B*NH*T*T*HS operations; the backward moves 7 * B*T*C values and
// does 10 * B*NH*T*T*HS.  In bfloat16 that is T/2 (forward) and 5T/7
// (backward) operations a byte against the card's 295 (989 TFLOP/s over
// 3.35 TB/s): at the U-Net's T = 64 and 256 device memory bounds both, and
// only the benchmark's T = 1024 is bound by the tensor cores.
//
// bfloat16 design (the *_mma_kernel kernels).  Every product is a
// tensor-core `mma.sync.m16n8k16` on bf16 operands with a float32
// accumulator.  A warp owns 16 rows (queries in the forward and the dq
// kernel, keys in the dk/dv kernel) and a block has 4 warps, 64 rows: at
// (8, 64, 256, 8) that is 64 blocks for the card's 132 SMs, and one-warp
// blocks, which gave every SM a block, were no faster there (PERF.md,
// prediction P23).  The warp's own rows go straight from device memory
// into A fragments in registers (qs scaled and rounded once there).
// The other side (k and v, or qs and dout) passes through shared memory in
// bf16 tiles of 64 rows, copied with 16-byte `cp.async` into a two-tile ring
// so that the next tile's copy overlaps this tile's products, and read as B
// fragments with `ldmatrix` (`.trans` where the tile's rows are the product's
// k index).  A tile row is HS values padded to HS + 8, so the eight rows
// one `ldmatrix` phase reads start in eight different 16-byte bank groups:
// no bank conflicts.  Rows past T are zero-filled by the copy, and
// their scores are -inf (keys) or their weights 0 (queries in the dk/dv
// kernel); rows past T are never written.  The scores' accumulator fragment
// (m16n8, float32) is exponentiated, rounded and packed in registers into
// the A fragment of the next product (m16n8k16 bf16): p and ds never go to
// shared memory.
//
// The softmax is online, per 64-key tile: each row's running maximum is
// reduced over the four threads that hold the row (`__shfl_xor_sync`), its
// running sum is kept per thread and reduced once at the end.  The exponent
// is 2^(fmaf(s, log2 e, -m log2 e)) by `ex2.approx`: the argument carries a
// rounding error of about 2^-24 |s log2 e| and the instruction one of about
// 2^-22, so p is off by about 2^-22 of itself, far below the 2^-8 step of
// the bf16 rounding that follows.  As in the
// float32 kernels, the forward rounds p relative to the running maximum and
// divides by the sum at the end, where the plain version rounds the
// normalised p; the difference is noise of about 2^-8 of the output.
//
// The dk/dv kernel recomputes s^T = k qs^T with the keys as the mma's rows,
// where the dq kernel computed s = qs k^T with the queries as rows; both
// then take p = 2^(fmaf(s, log2 e, -m log2 e)) * (1 / l) from the same
// stored m and 1 / l.  The 32 products of each score are the same exact bf16
// products, summed in two k-steps of 16 in the same order, but the PTX ISA
// does not promise that one k-step sums its 16 products in an order that is
// independent of the operand they come from; so p in the two kernels is
// equal in value up to that order, and bit-equal only where the hardware
// makes it so.  Not measured; the tolerances do not depend on it.
//
// float32 design (qkv_attention_fwd_kernel and the two qkv_attention_bwd_*
// kernels without the _mma suffix).  One query (or key) per thread in
// registers, the other side through shared memory in float32 tiles of 64
// rows, and float32 FMAs: the JAX package's float32 path is
// Precision.HIGHEST, which TF32 tensor cores would not match.  At HS = 64
// a row is split over two neighbouring threads, 32 columns each, whose
// partial dot products are added with one shuffle: the dk/dv kernel keeps
// four row vectors (k, v, dk, dv) in registers, which at 64 columns a
// thread would be 256 floats and spill.
//
// Head sizes.  Every kernel is a template on HS, compiled for HS = 16, 32
// and 64 (`with_head_size`, the launchers' dispatch on C / NH); each is a
// multiple of the mma's k-step of 16.  At HS = 16 a score's B fragment is
// one `ldmatrix.x2`; at 64 the products take four k-steps, and a tile row
// is 144 bytes (two 64-row tiles of k and v, 36 KB, stay static shared
// memory).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int QT = 64;  // float32: queries per block
constexpr int KT = 64;  // float32: keys per shared-memory tile
constexpr int SG = 16;  // float32: scores held in registers between rescales

// float32: the columns of a row one thread holds in registers, and the
// threads that share a row (a row of HS = 64 is split over two threads, so
// that no thread holds more than 32 columns of each of its row vectors).
__host__ __device__ constexpr int fma_cols(int HS) { return HS < 32 ? HS : 32; }
__host__ __device__ constexpr int fma_threads(int HS) { return QT * (HS / fma_cols(HS)); }

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The sum of a value over the P neighbouring lanes that share a row; each
// lane gets the same sum (a + b and b + a are equal in IEEE arithmetic).
template <int P> __device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int o = 1; o < P; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// The dot product of a thread's RC columns, in the forward's order of FMAs:
// d = 0 .. RC-1.
template <int RC> __device__ __forceinline__ float dot_cols(const float* a, const float* b) {
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < RC; ++d) dot = fmaf(a[d], b[d], dot);
    return dot;
}

// Fills the shared tiles with keys and values [k0, k0 + nk) of the head,
// by a block of NT threads (a stride known to the compiler: the forward was
// 20% slower with blockDim.x).
template <int HS, int NT>
__device__ __forceinline__ void load_kv_tile(const float* base, size_t row, int C, int k0, int nk,
                                             float (*k_s)[HS], float (*v_s)[HS]) {
    for (int e = threadIdx.x * 4; e < nk * HS; e += NT * 4) {
        const int j = e / HS, d = e % HS;
        const float* kp = base + (size_t)(k0 + j) * row + C + d;
        *reinterpret_cast<float4*>(&k_s[j][d]) = ld4(kp);
        *reinterpret_cast<float4*>(&v_s[j][d]) = ld4(kp + C);
    }
}

template <int HS>
__global__ void __launch_bounds__(fma_threads(HS))
qkv_attention_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T_len, int C,
                         float scale) {
    constexpr int RC = fma_cols(HS), P = HS / RC, NT = fma_threads(HS);
    __shared__ __align__(16) float k_s[KT][HS];
    __shared__ __align__(16) float v_s[KT][HS];

    const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int c0 = threadIdx.x % P * RC;  // this thread's columns [c0, c0 + RC) of the row
    const int tq = q_tile * QT + threadIdx.x / P;
    const bool q_valid = tq < T_len;
    const size_t row = (size_t)3 * C;
    const float* base = qkv + (size_t)b * T_len * row + (size_t)h * HS;

    // A row past the end takes row 0's q (its output is never written):
    // with the load under a branch instead, ptxas spilled 8 bytes at HS =
    // 16 and 64.
    float q[RC], acc[RC];
    const float* qp = base + (size_t)(q_valid ? tq : 0) * row + c0;
#pragma unroll
    for (int d = 0; d < RC; d += 4) {
        const float4 v = ld4(qp + d);
        q[d] = v.x * scale;
        q[d + 1] = v.y * scale;
        q[d + 2] = v.z * scale;
        q[d + 3] = v.w * scale;
        acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
    }
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();  // the previous tile has been consumed
        load_kv_tile<HS, NT>(base, row, C, k0, nk, k_s, v_s);
        __syncthreads();

        for (int j0 = 0; j0 < nk; j0 += SG) {
            float s[SG];
            float smax = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                float dot = -INFINITY;
                if (j < nk) {  // the same for every thread of the block
                    const float4* kr = reinterpret_cast<const float4*>(k_s[j] + c0);
                    dot = 0.f;
#pragma unroll
                    for (int d4 = 0; d4 < RC / 4; ++d4) {
                        const float4 kk = kr[d4];
                        dot = fmaf(q[4 * d4 + 0], kk.x, dot);
                        dot = fmaf(q[4 * d4 + 1], kk.y, dot);
                        dot = fmaf(q[4 * d4 + 2], kk.z, dot);
                        dot = fmaf(q[4 * d4 + 3], kk.w, dot);
                    }
                    dot = row_sum<P>(dot);
                }
                s[jj] = dot;
                smax = fmaxf(smax, dot);
            }
            // j0 < nk, so the group holds at least one finite score
            const float m_new = fmaxf(m, smax);
            const float corr = expf(m - m_new);  // 0 on the first group
            l *= corr;
#pragma unroll
            for (int d = 0; d < RC; ++d) acc[d] *= corr;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                if (j < nk) {
                    const float p = expf(s[jj] - m_new);
                    l += p;
                    const float4* vr = reinterpret_cast<const float4*>(v_s[j] + c0);
#pragma unroll
                    for (int d4 = 0; d4 < RC / 4; ++d4) {
                        const float4 vv = vr[d4];
                        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
                        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
                        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
                        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
                    }
                }
            }
            m = m_new;
        }
    }

    if (q_valid) {
        const float inv_l = 1.f / l;
        float* op = out + ((size_t)b * T_len + tq) * C + (size_t)h * HS + c0;
#pragma unroll
        for (int d = 0; d < RC; d += 4)
            st4(op + d, acc[d] * inv_l, acc[d + 1] * inv_l, acc[d + 2] * inv_l,
                acc[d + 3] * inv_l);
    }
}

// Loads the thread's columns [c0, c0 + RC) of row `tq` of the head's q
// (scaled as the forward does) and of dout into registers; zeros for a row
// past the end.
template <int HS>
__device__ __forceinline__ void load_q_dout(const float* qkv, const float* dout, int b, int h,
                                            int tq, int c0, int T_len, int C, float scale,
                                            float* q, float* dob) {
    constexpr int RC = fma_cols(HS);
#pragma unroll
    for (int d = 0; d < RC; ++d) q[d] = dob[d] = 0.f;
    if (tq >= T_len) return;
    const float* qp = qkv + ((size_t)b * T_len + tq) * 3 * C + (size_t)h * HS + c0;
    const float* op = dout + ((size_t)b * T_len + tq) * C + (size_t)h * HS + c0;
#pragma unroll
    for (int d = 0; d < RC; d += 4) {
        const float4 qv = ld4(qp + d), ov = ld4(op + d);
        q[d] = qv.x * scale;
        q[d + 1] = qv.y * scale;
        q[d + 2] = qv.z * scale;
        q[d + 3] = qv.w * scale;
        dob[d] = ov.x;
        dob[d + 1] = ov.y;
        dob[d + 2] = ov.z;
        dob[d + 3] = ov.w;
    }
}

template <int HS>
__global__ void __launch_bounds__(fma_threads(HS))
qkv_attention_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                            float* __restrict__ dqkv, float* __restrict__ stats, int T_len, int C,
                            int NH, float scale) {
    constexpr int RC = fma_cols(HS), P = HS / RC, NT = fma_threads(HS);
    __shared__ __align__(16) float k_s[KT][HS];
    __shared__ __align__(16) float v_s[KT][HS];
    const int h = blockIdx.y, b = blockIdx.z;
    const int c0 = threadIdx.x % P * RC;
    const int tq = blockIdx.x * QT + threadIdx.x / P;
    const size_t row = (size_t)3 * C;
    const float* base = qkv + (size_t)b * T_len * row + (size_t)h * HS;

    float q[RC], dob[RC];
    load_q_dout<HS>(qkv, dout, b, h, tq, c0, T_len, C, scale, q, dob);

    // Sweep 1: the row's maximum m, sum l and D * l, online.
    float m = -INFINITY, l = 0.f, dl = 0.f;
    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();  // the previous tile has been consumed
        load_kv_tile<HS, NT>(base, row, C, k0, nk, k_s, v_s);
        __syncthreads();
        for (int j0 = 0; j0 < nk; j0 += SG) {
            float s[SG], dp[SG];
            float smax = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                s[jj] = j < nk ? row_sum<P>(dot_cols<RC>(q, k_s[j] + c0)) : -INFINITY;
                dp[jj] = j < nk ? row_sum<P>(dot_cols<RC>(dob, v_s[j] + c0)) : 0.f;
                smax = fmaxf(smax, s[jj]);
            }
            const float m_new = fmaxf(m, smax);
            const float corr = expf(m - m_new);  // 0 on the first group
            l *= corr;
            dl *= corr;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                if (j0 + jj < nk) {
                    const float p = expf(s[jj] - m_new);
                    l += p;
                    dl = fmaf(p, dp[jj], dl);
                }
            }
            m = m_new;
        }
    }
    const float inv_l = 1.f / l;
    const float D = dl * inv_l;

    // Sweep 2: dq = sum_j ds_j k_j.
    float dq[RC];
#pragma unroll
    for (int d = 0; d < RC; ++d) dq[d] = 0.f;
    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();
        load_kv_tile<HS, NT>(base, row, C, k0, nk, k_s, v_s);
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
            const float p = expf(row_sum<P>(dot_cols<RC>(q, k_s[j] + c0)) - m) * inv_l;
            const float ds = p * (row_sum<P>(dot_cols<RC>(dob, v_s[j] + c0)) - D);
            const float4* kr = reinterpret_cast<const float4*>(k_s[j] + c0);
#pragma unroll
            for (int d4 = 0; d4 < RC / 4; ++d4) {
                const float4 kk = kr[d4];
                dq[4 * d4 + 0] = fmaf(ds, kk.x, dq[4 * d4 + 0]);
                dq[4 * d4 + 1] = fmaf(ds, kk.y, dq[4 * d4 + 1]);
                dq[4 * d4 + 2] = fmaf(ds, kk.z, dq[4 * d4 + 2]);
                dq[4 * d4 + 3] = fmaf(ds, kk.w, dq[4 * d4 + 3]);
            }
        }
    }

    if (tq < T_len) {
        float* op = dqkv + ((size_t)b * T_len + tq) * row + (size_t)h * HS + c0;
#pragma unroll
        for (int d = 0; d < RC; d += 4)
            st4(op + d, dq[d] * scale, dq[d + 1] * scale, dq[d + 2] * scale, dq[d + 3] * scale);
        if (c0 == 0) {
            const size_t plane = (size_t)gridDim.z * NH * T_len;
            const size_t at = ((size_t)b * NH + h) * T_len + tq;
            stats[at] = m;
            stats[plane + at] = inv_l;
            stats[2 * plane + at] = D;
        }
    }
}

template <int HS>
__global__ void __launch_bounds__(fma_threads(HS))
qkv_attention_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                             float* __restrict__ dqkv, const float* __restrict__ stats, int T_len,
                             int C, int NH, float scale) {
    constexpr int RC = fma_cols(HS), P = HS / RC, NT = fma_threads(HS);
    __shared__ __align__(16) float q_s[QT][HS];
    __shared__ __align__(16) float o_s[QT][HS];
    __shared__ float m_s[QT], il_s[QT], d_s[QT];
    const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int c0 = tid % P * RC;
    const int tk = blockIdx.x * KT + tid / P;
    const size_t row = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const float* st = stats + ((size_t)b * NH + h) * T_len;

    float k[RC], v[RC], dk[RC], dv[RC];
#pragma unroll
    for (int d = 0; d < RC; ++d) k[d] = v[d] = dk[d] = dv[d] = 0.f;
    if (tk < T_len) {
        const float* kp = qkv + ((size_t)b * T_len + tk) * row + C + (size_t)h * HS + c0;
#pragma unroll
        for (int d = 0; d < RC; d += 4) {
            const float4 kv = ld4(kp + d), vv = ld4(kp + C + d);
            k[d] = kv.x;
            k[d + 1] = kv.y;
            k[d + 2] = kv.z;
            k[d + 3] = kv.w;
            v[d] = vv.x;
            v[d + 1] = vv.y;
            v[d + 2] = vv.z;
            v[d + 3] = vv.w;
        }
    }

    for (int q0 = 0; q0 < T_len; q0 += QT) {
        const int nq = min(QT, T_len - q0);
        __syncthreads();  // the previous tile has been consumed
        for (int e = tid * 4; e < nq * HS; e += NT * 4) {
            const int i = e / HS, d = e % HS;
            const size_t tok = (size_t)b * T_len + q0 + i;
            const float4 qv = ld4(qkv + tok * row + h * HS + d);
            st4(&q_s[i][d], qv.x * scale, qv.y * scale, qv.z * scale, qv.w * scale);
            *reinterpret_cast<float4*>(&o_s[i][d]) = ld4(dout + tok * C + h * HS + d);
        }
        for (int i = tid; i < nq; i += NT) {
            m_s[i] = st[q0 + i];
            il_s[i] = st[plane + q0 + i];
            d_s[i] = st[2 * plane + q0 + i];
        }
        __syncthreads();
        for (int i = 0; i < nq; ++i) {
            const float p = expf(row_sum<P>(dot_cols<RC>(q_s[i] + c0, k)) - m_s[i]) * il_s[i];
            const float ds = p * (row_sum<P>(dot_cols<RC>(o_s[i] + c0, v)) - d_s[i]);
            const float4* qr = reinterpret_cast<const float4*>(q_s[i] + c0);
            const float4* orow = reinterpret_cast<const float4*>(o_s[i] + c0);
#pragma unroll
            for (int d4 = 0; d4 < RC / 4; ++d4) {
                const float4 qq = qr[d4], oo = orow[d4];
                dk[4 * d4 + 0] = fmaf(ds, qq.x, dk[4 * d4 + 0]);
                dk[4 * d4 + 1] = fmaf(ds, qq.y, dk[4 * d4 + 1]);
                dk[4 * d4 + 2] = fmaf(ds, qq.z, dk[4 * d4 + 2]);
                dk[4 * d4 + 3] = fmaf(ds, qq.w, dk[4 * d4 + 3]);
                dv[4 * d4 + 0] = fmaf(p, oo.x, dv[4 * d4 + 0]);
                dv[4 * d4 + 1] = fmaf(p, oo.y, dv[4 * d4 + 1]);
                dv[4 * d4 + 2] = fmaf(p, oo.z, dv[4 * d4 + 2]);
                dv[4 * d4 + 3] = fmaf(p, oo.w, dv[4 * d4 + 3]);
            }
        }
    }

    if (tk < T_len) {
        float* kp = dqkv + ((size_t)b * T_len + tk) * row + C + (size_t)h * HS + c0;
#pragma unroll
        for (int d = 0; d < RC; d += 4) {
            st4(kp + d, dk[d], dk[d + 1], dk[d + 2], dk[d + 3]);
            st4(kp + C + d, dv[d], dv[d + 1], dv[d + 2], dv[d + 3]);
        }
    }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;                     // warps of a block, 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int TILE = WARPS * 16;             // a block's rows, and the rows of a shared tile
constexpr int STAGES = 2;                    // tiles in the cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

// A shared tile row: HS values + 8 of padding (LD<HS> in all), so that the
// eight rows one `ldmatrix` phase reads start in eight different 16-byte
// bank groups (rows of 48, 80 and 144 bytes at HS = 16, 32, 64).
template <int HS> constexpr int LD = HS + 8;

// 2^x by the special-function unit (`ex2.approx.ftz`): relative error about
// 2^-22, results below 2^-126 flushed to 0.  On the card it gave the same
// output bits as exp2f at every shape chip_smoke.py checks, and a faster
// backward.
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Copies rows [r0, r0 + TILE) of one head's HS columns (row r at src + r *
// stride) into a padded tile; rows at or past n are zero-filled.
template <int HS>
__device__ __forceinline__ void tile_async(bf16 (*dst)[LD<HS>], const bf16* src, size_t stride,
                                           int r0, int n) {
#pragma unroll
    for (int e = threadIdx.x; e < TILE * HS / 8; e += THREADS) {
        const int r = e / (HS / 8), c = e % (HS / 8) * 8;
        const bool valid = r0 + r < n;
        cp_async16(&dst[r][c], src + (size_t)(valid ? r0 + r : 0) * stride + c, valid);
    }
}

// Keys and values [k0, k0 + TILE) of the head whose q starts at q_head.
template <int HS>
__device__ __forceinline__ void kv_tile_async(bf16 (*k_s)[LD<HS>], bf16 (*v_s)[LD<HS>],
                                              const bf16* q_head, int C, size_t stride, int k0,
                                              int T_len) {
    tile_async<HS>(k_s, q_head + C, stride, k0, T_len);
    tile_async<HS>(v_s, q_head + 2 * C, stride, k0, T_len);
}

// The A fragments of the warp's 16 rows (lane 4g + t: rows `row` = first +
// g and row + 8) over the head's HS columns, in HS / 16 k-steps of 16, read
// straight from device memory; rows at or past n are zero.  With SCALE each
// value is multiplied by `scale` and rounded to bf16 (qs).
template <int HS, bool SCALE>
__device__ __forceinline__ void a_frags(uint32_t (&a)[HS / 16][4], const bf16* src,
                                        size_t stride, int row, int n, float scale) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
#pragma unroll
        for (int ks = 0; ks < HS / 16; ++ks) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                uint32_t v = 0;
                if (r < n) {
                    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                        src + (size_t)r * stride + 16 * ks + 8 * half + 2 * t);
                    if (SCALE) {
                        const float2 f = __bfloat1622float2(x);
                        v = pack_bf16(f.x * scale, f.y * scale);
                    } else {
                        v = *reinterpret_cast<const uint32_t*>(&x);
                    }
                }
                a[ks][i + 2 * half] = v;
            }
        }
    }
}

// acc[j] = a b_j^T for the eight n-tiles j of a 64-row tile whose rows are
// the product's n index (b_j: rows 8j .. 8j + 7): scores from k or qs, dp
// from v or dout.  The HS / 16 k-steps are summed in order.
template <int HS>
__device__ __forceinline__ void rows_product(float (&acc)[8][4], const uint32_t (&a)[HS / 16][4],
                                             const bf16 (*tile)[LD<HS>]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        if constexpr (HS == 16) {
            uint32_t b[2];
            ldsm_x2(b, &tile[8 * j + (lane & 7)][((lane >> 3) & 1) * 8]);
            mma_bf16(acc[j], a[0], b[0], b[1]);
        } else {
#pragma unroll
            for (int c = 0; c < HS / 32; ++c) {
                uint32_t b[4];
                ldsm_x4(b, &tile[8 * j + (lane & 7)][32 * c + (lane >> 3) * 8]);
                mma_bf16(acc[j], a[2 * c], b[0], b[1]);
                mma_bf16(acc[j], a[2 * c + 1], b[2], b[3]);
            }
        }
    }
}

// acc += p tile for the packed A fragments p (four k-steps of 16 tile rows)
// and a 64-row tile whose rows are the product's k index: out += p v,
// dq += ds k, dv += p^T dout, dk += ds^T qs.
template <int HS>
__device__ __forceinline__ void cols_product(float (&acc)[HS / 8][4], const uint32_t (&p)[4][4],
                                             const bf16 (*tile)[LD<HS>]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int pp = 0; pp < HS / 16; ++pp) {
            uint32_t b[4];
            ldsm_x4_trans(b, &tile[16 * kk + (lane & 7) + (lane & 8)][16 * pp + (lane >> 4) * 8]);
            mma_bf16(acc[2 * pp], p[kk], b[0], b[1]);
            mma_bf16(acc[2 * pp + 1], p[kk], b[2], b[3]);
        }
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

// Writes the warp's 16 x HS float32 accumulator times `mul`, rounded to
// bf16, to rows `row` and row + 8 (lane 4g + t: row = first + g) of dst
// (row r at dst + r * stride); rows at or past n are skipped.
template <int HS>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, int row, int n,
                                           const float (&acc)[HS / 8][4], float mul0,
                                           float mul1) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        if (r >= n) continue;
        const float mul = i ? mul1 : mul0;
#pragma unroll
        for (int j = 0; j < HS / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + (size_t)r * stride + 8 * j + 2 * t) =
                pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
    }
}

// Forward: one block per (batch, head, TILE queries).
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T_len,
                             int C, float scale) {
    __shared__ __align__(128) bf16 k_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 v_s[STAGES][TILE][LD<HS>];
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * HS;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles)
            kv_tile_async<HS>(k_s[it], v_s[it], q_head, C, stride, it * TILE, T_len);
        cp_async_commit();
    }

    uint32_t qf[HS / 16][4];
    a_frags<HS, true>(qf, q_head, stride, row, T_len, scale);
    float o[HS / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, ahead = it + STAGES - 1;
        if (ahead < ntiles)
            kv_tile_async<HS>(k_s[ahead % STAGES], v_s[ahead % STAGES], q_head, C, stride,
                              ahead * TILE, T_len);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncthreads();

        float s[8][4];
        rows_product<HS>(s, qf, k_s[buf]);
        const int k0 = it * TILE;
        if (k0 + TILE > T_len) {  // the ragged last tile
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + 8 * j + 2 * t + (e & 1) >= T_len) s[j][e] = -INFINITY;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
        float mL[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = quad_max(mx[i]);  // finite: key 0 of the first tile is real
            const float corr = exp2_approx((m[i] - mx[i]) * LOG2E);  // 0 on the first tile
            m[i] = mx[i];
            mL[i] = mx[i] * LOG2E;
            l[i] *= corr;
#pragma unroll
            for (int j = 0; j < HS / 8; ++j) {
                o[j][2 * i] *= corr;
                o[j][2 * i + 1] *= corr;
            }
        }
        uint32_t pf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float p0 = exp2_approx(fmaf(s[j][0], LOG2E, -mL[0]));
            const float p1 = exp2_approx(fmaf(s[j][1], LOG2E, -mL[0]));
            const float p2 = exp2_approx(fmaf(s[j][2], LOG2E, -mL[1]));
            const float p3 = exp2_approx(fmaf(s[j][3], LOG2E, -mL[1]));
            l[0] += p0 + p1;
            l[1] += p2 + p3;
            pack_a(pf, j, p0, p1, p2, p3);
        }
        cols_product<HS>(o, pf, v_s[buf]);
        __syncthreads();  // the tile has been consumed before it is refilled
    }

    store_rows<HS>(out + (size_t)b * T_len * C + (size_t)h * HS, C, row, T_len, o,
                   1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// Backward, kernel 1: one block per (batch, head, TILE queries).  Two
// sweeps over the key tiles, one pipeline: the first takes each row's m, l
// and D = sum p dp / l online, the second recomputes p and ds and
// accumulates dq.  Writes dq and the rows' m, 1 / l and D.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dq_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                bf16* __restrict__ dqkv, float* __restrict__ stats, int T_len,
                                int C, int NH, float scale) {
    __shared__ __align__(128) bf16 k_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 v_s[STAGES][TILE][LD<HS>];
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * HS;
    const bf16* o_head = dout + (size_t)b * T_len * C + (size_t)h * HS;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {  // iteration it sweeps tile it % ntiles
        if (it < 2 * ntiles)
            kv_tile_async<HS>(k_s[it], v_s[it], q_head, C, stride, it % ntiles * TILE, T_len);
        cp_async_commit();
    }

    uint32_t qf[HS / 16][4], of[HS / 16][4];
    a_frags<HS, true>(qf, q_head, stride, row, T_len, scale);
    a_frags<HS, false>(of, o_head, C, row, T_len, 0.f);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2], inv_l[2], D[2];
    float dq[HS / 8][4] = {};

    for (int it = 0; it < 2 * ntiles; ++it) {
        const int buf = it % STAGES, tile = it % ntiles, ahead = it + STAGES - 1;
        if (ahead < 2 * ntiles)
            kv_tile_async<HS>(k_s[ahead % STAGES], v_s[ahead % STAGES], q_head, C, stride,
                              ahead % ntiles * TILE, T_len);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncthreads();

        float s[8][4], dp[8][4];
        rows_product<HS>(s, qf, k_s[buf]);
        rows_product<HS>(dp, of, v_s[buf]);
        const int k0 = tile * TILE;
        if (k0 + TILE > T_len) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + 8 * j + 2 * t + (e & 1) >= T_len) s[j][e] = -INFINITY;
        }
        if (it < ntiles) {  // sweep 1
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = quad_max(mx[i]);
                const float corr = exp2_approx((m[i] - mx[i]) * LOG2E);
                m[i] = mx[i];
                mL[i] = mx[i] * LOG2E;
                l[i] *= corr;
                dl[i] *= corr;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));
                    l[e >> 1] += p;
                    dl[e >> 1] = fmaf(p, dp[j][e], dl[e >> 1]);
                }
            if (it == ntiles - 1) {  // the rows' statistics, for sweep 2
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    inv_l[i] = 1.f / quad_sum(l[i]);
                    D[i] = quad_sum(dl[i]) * inv_l[i];
                }
            }
        } else {  // sweep 2
            uint32_t dsf[4][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e >> 1;
                    const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[i])) * inv_l[i];
                    ds[e] = p * (dp[j][e] - D[i]);
                }
                pack_a(dsf, j, ds[0], ds[1], ds[2], ds[3]);
            }
            cols_product<HS>(dq, dsf, k_s[buf]);
        }
        __syncthreads();
    }

    store_rows<HS>(dqkv + (size_t)b * T_len * stride + (size_t)h * HS, stride, row, T_len, dq,
                   scale, scale);
    if (t == 0) {
        const size_t plane = (size_t)gridDim.z * NH * T_len;
        float* st = stats + ((size_t)b * NH + h) * T_len;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = row + 8 * i;
            if (r >= T_len) continue;
            st[r] = m[i];
            st[plane + r] = inv_l[i];
            st[2 * plane + r] = D[i];
        }
    }
}

// Stages query tile [q0, q0 + TILE) for the dk/dv kernel: q (scaled once
// it has arrived), dout, and the rows' m, 1 / l and D (rows from `st`, the
// three planes `plane` apart); rows at or past T_len are zero-filled.
template <int HS>
__device__ __forceinline__ void q_tile_async(bf16 (*q_s)[LD<HS>], bf16 (*o_s)[LD<HS>],
                                             float (*st_s)[TILE], const bf16* q_head,
                                             const bf16* o_head, const float* st, size_t stride,
                                             int C, size_t plane, int q0, int T_len) {
    tile_async<HS>(q_s, q_head, stride, q0, T_len);
    tile_async<HS>(o_s, o_head, C, q0, T_len);
    for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
        const int k = e / TILE, i = e % TILE;
        const bool valid = q0 + i < T_len;
        cp_async4(&st_s[k][i], st + k * plane + (valid ? q0 + i : 0), valid);
    }
}

// Backward, kernel 2: one block per (batch, head, TILE keys).  Loops
// over the query tiles (qs, dout and the rows' m, 1 / l, D), recomputes s^T,
// dp^T, p^T and ds^T with the keys as rows, and accumulates dv += p^T dout
// and dk += ds^T qs.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv, const float* __restrict__ stats,
                                 int T_len, int C, int NH, float scale) {
    __shared__ __align__(128) bf16 q_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 o_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(16) float st_s[STAGES][3][TILE];  // m, 1 / l, D of the tile's queries
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * HS;
    const bf16* o_head = dout + (size_t)b * T_len * C + (size_t)h * HS;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles)
            q_tile_async<HS>(q_s[it], o_s[it], st_s[it], q_head, o_head, st, stride, C, plane,
                             it * TILE, T_len);
        cp_async_commit();
    }

    uint32_t kf[HS / 16][4], vf[HS / 16][4];
    a_frags<HS, false>(kf, q_head + C, stride, row, T_len, 0.f);
    a_frags<HS, false>(vf, q_head + 2 * C, stride, row, T_len, 0.f);
    float dk[HS / 8][4] = {}, dv[HS / 8][4] = {};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, q0 = it * TILE, ahead = it + STAGES - 1;
        if (ahead < ntiles)
            q_tile_async<HS>(q_s[ahead % STAGES], o_s[ahead % STAGES], st_s[ahead % STAGES],
                             q_head, o_head, st, stride, C, plane, ahead * TILE, T_len);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        // qs = round(q * scale), once per staged value: each thread scales
        // the 16-byte pieces it copied itself, which the wait made visible
        // to it; the barrier then shows them to the block.
#pragma unroll
        for (int e = threadIdx.x; e < TILE * HS / 8; e += THREADS) {
            uint4* piece = reinterpret_cast<uint4*>(&q_s[buf][e / (HS / 8)][e % (HS / 8) * 8]);
            uint4 v = *piece;
            uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[k]));
                w[k] = pack_bf16(f.x * scale, f.y * scale);
            }
            *piece = v;
        }
        __syncthreads();

        float s[8][4], dp[8][4];
        rows_product<HS>(s, kf, q_s[buf]);
        rows_product<HS>(dp, vf, o_s[buf]);
        uint32_t pf[4][4], dsf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * t;  // the tile's query columns c, c + 1
            const float2 mm = *reinterpret_cast<const float2*>(&st_s[buf][0][c]);
            const float2 il = *reinterpret_cast<const float2*>(&st_s[buf][1][c]);
            const float2 dd = *reinterpret_cast<const float2*>(&st_s[buf][2][c]);
            const float mLc[2] = {mm.x * LOG2E, mm.y * LOG2E};
            const float ilc[2] = {il.x, il.y}, ddc[2] = {dd.x, dd.y};
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = e & 1;
                p[e] = q0 + c + k < T_len
                           ? exp2_approx(fmaf(s[j][e], LOG2E, -mLc[k])) * ilc[k]
                           : 0.f;
                ds[e] = p[e] * (dp[j][e] - ddc[k]);
            }
            pack_a(pf, j, p[0], p[1], p[2], p[3]);
            pack_a(dsf, j, ds[0], ds[1], ds[2], ds[3]);
        }
        cols_product<HS>(dv, pf, o_s[buf]);
        cols_product<HS>(dk, dsf, q_s[buf]);
        __syncthreads();
    }

    bf16* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * HS;
    store_rows<HS>(k_out, stride, row, T_len, dk, 1.f, 1.f);
    store_rows<HS>(k_out + C, stride, row, T_len, dv, 1.f, 1.f);
}

// Calls f(std::integral_constant<int, HS>()) for the head size HS = hs if
// the kernels are compiled for it; cudaErrorInvalidValue otherwise.  These
// cases are the head sizes the kernels take (ops/kernels/attention.py's
// HEAD_SIZES): each a multiple of the mma's k-step of 16.
template <class F>
int with_head_size(int hs, F&& f) {
    switch (hs) {
        case 16: return f(std::integral_constant<int, 16>());
        case 32: return f(std::integral_constant<int, 32>());
        case 64: return f(std::integral_constant<int, 64>());
        default: return (int)cudaErrorInvalidValue;
    }
}

// A head size the kernels are not compiled for is refused by
// `with_head_size`.
bool bad_shape(int B, int T_len, int C, int NH) {
    return B <= 0 || T_len <= 0 || NH <= 0 || C % NH != 0 || B > 65535 || NH > 65535;
}

}  // namespace

// qkv: (B, T, 3C) contiguous, out: (B, T, C) contiguous, both 16-byte
// aligned, C == NH * HS with HS one of the compiled head sizes (16, 32, 64),
// B and NH at most 65535; scale is 1 / sqrt(HS), given by the caller so that
// it is the same float the plain version multiplies by.  Returns the CUDA
// error code of the launch (0 = success).
extern "C" int unet_qkv_attention_fwd(const void* qkv, void* out, int B, int T_len, int C,
                                      int NH, float scale, int is_bf16, cudaStream_t stream) {
    if (bad_shape(B, T_len, C, NH)) return (int)cudaErrorInvalidValue;
    return with_head_size(C / NH, [&](auto hs) {
        constexpr int HS = decltype(hs)::value;
        if (is_bf16) {
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            qkv_attention_fwd_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T_len, C, scale);
        } else {
            const dim3 grid((T_len + QT - 1) / QT, NH, B);
            qkv_attention_fwd_kernel<HS><<<grid, fma_threads(HS), 0, stream>>>(
                static_cast<const float*>(qkv), static_cast<float*>(out), T_len, C, scale);
        }
        return (int)cudaGetLastError();
    });
}

// qkv, dqkv: (B, T, 3C), dout: (B, T, C), all contiguous and 16-byte
// aligned, of one type; stats: (3, B, NH, T) float32 scratch (the rows' m,
// 1/l and D, written by the first kernel and read by the second).  C, NH,
// B and scale as for the forward.  Returns the CUDA error code of the
// launches (0 = success).
extern "C" int unet_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                      float* stats, int B, int T_len, int C, int NH, float scale,
                                      int is_bf16, cudaStream_t stream) {
    if (bad_shape(B, T_len, C, NH)) return (int)cudaErrorInvalidValue;
    return with_head_size(C / NH, [&](auto hs) {
        constexpr int HS = decltype(hs)::value;
        cudaError_t err;
        if (is_bf16) {
            const bf16* x = static_cast<const bf16*>(qkv);
            const bf16* dy = static_cast<const bf16*>(dout);
            bf16* dx = static_cast<bf16*>(dqkv);
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            qkv_attention_bwd_dq_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, scale);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            qkv_attention_bwd_dkv_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, scale);
        } else {
            const float* x = static_cast<const float*>(qkv);
            const float* dy = static_cast<const float*>(dout);
            float* dx = static_cast<float*>(dqkv);
            const dim3 grid_q((T_len + QT - 1) / QT, NH, B), grid_k((T_len + KT - 1) / KT, NH, B);
            qkv_attention_bwd_dq_kernel<HS><<<grid_q, fma_threads(HS), 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, scale);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            qkv_attention_bwd_dkv_kernel<HS><<<grid_k, fma_threads(HS), 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, scale);
        }
        return (int)cudaGetLastError();
    });
}
