// Non-causal multi-head attention, forward, straight from the packed QKV.
//
// Replaces the Pallas kernel `_fwd_kernel` of unet_tpu/ops/pallas/attention.py
// (launched by `_fwd_call`, reached through `qkv_attention_fused`): qkv is
// (B, T, 3C) laid out [q | k | v], each C split contiguously into (NH, HS);
// per head qs = q / sqrt(HS) rounded to the input type, s = qs k^T in
// float32, a float32 softmax over all keys, out = (p rounded to the input
// type) v accumulated in float32 and written at column h * HS of (B, T, C).
// No (B, NH, T, T) tensor reaches device memory.
//
// Bound on an H100.  The function reads 3C and writes C values per token,
// 4 * B*T*C * itemsize bytes, and does 4 * B*NH*T*T*HS operations.  At the
// U-Net's shapes (T = 64..1024, HS = 32) the operations set the bound for
// T above a few hundred and the bytes below.
//
// Design.  A block serves one (batch, head, tile of QT queries); a thread
// owns one query: its scaled q row, its float32 output row and its running
// softmax maximum and sum stay in registers.  The keys and values of the head
// pass through shared memory in tiles of KT keys, converted to float32 once
// per tile; every thread of a warp reads the same key element, which shared
// memory serves as one broadcast.  The sequential key loop with an online
// softmax (scores in groups of SG keys: group maximum, one rescale of the
// accumulators, then exponentials) takes the place of the TPU kernel's
// whole-row softmax, so T is not bounded by on-chip memory, and the ragged
// last tile is masked with -inf scores, so T need not divide by anything.
// The products are plain float32 FMAs: exact products of the rounded bf16
// inputs, accumulated in float32, as the TPU kernel's matrix unit does.
// Tensor-core products (mma.sync, wgmma) are left for a later change.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int HS = 32;  // head size the kernel is compiled for
constexpr int QT = 64;  // queries per block, one per thread
constexpr int KT = 64;  // keys per shared-memory tile
constexpr int SG = 16;  // scores held in registers between rescales
constexpr int LV = 4;   // elements per load when filling the tile

template <typename T>
__global__ void __launch_bounds__(QT)
qkv_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int T_len, int C,
                         int NH, float scale) {
    __shared__ __align__(16) float k_s[KT][HS];
    __shared__ __align__(16) float v_s[KT][HS];

    const int q_tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int tq = q_tile * QT + tid;
    const bool q_valid = tq < T_len;
    const size_t row = (size_t)3 * C;
    const T* base = qkv + (size_t)b * T_len * row + (size_t)h * HS;

    float q[HS], acc[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) {
        acc[d] = 0.f;
        q[d] = 0.f;
    }
    if (q_valid) {
        const T* qp = base + (size_t)tq * row;
#pragma unroll
        for (int d = 0; d < HS; d += LV) {
            Vec<T, LV> v = *reinterpret_cast<const Vec<T, LV>*>(qp + d);
#pragma unroll
            for (int k = 0; k < LV; ++k) q[d + k] = round_to<T>(to_float<T>(v.v[k]) * scale);
        }
    }
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();  // the previous tile has been consumed
        for (int e = tid * LV; e < nk * HS; e += QT * LV) {
            const int j = e / HS, d = e % HS;
            const T* kp = base + (size_t)(k0 + j) * row + C + d;
            Vec<T, LV> kv = *reinterpret_cast<const Vec<T, LV>*>(kp);
            Vec<T, LV> vv = *reinterpret_cast<const Vec<T, LV>*>(kp + C);
#pragma unroll
            for (int k = 0; k < LV; ++k) {
                k_s[j][d + k] = to_float<T>(kv.v[k]);
                v_s[j][d + k] = to_float<T>(vv.v[k]);
            }
        }
        __syncthreads();

        for (int j0 = 0; j0 < nk; j0 += SG) {
            float s[SG];
            float smax = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                float dot = 0.f;
                if (j < nk) {
                    const float4* kr = reinterpret_cast<const float4*>(k_s[j]);
#pragma unroll
                    for (int d4 = 0; d4 < HS / 4; ++d4) {
                        const float4 kk = kr[d4];
                        dot = fmaf(q[4 * d4 + 0], kk.x, dot);
                        dot = fmaf(q[4 * d4 + 1], kk.y, dot);
                        dot = fmaf(q[4 * d4 + 2], kk.z, dot);
                        dot = fmaf(q[4 * d4 + 3], kk.w, dot);
                    }
                } else {
                    dot = -INFINITY;
                }
                s[jj] = dot;
                smax = fmaxf(smax, dot);
            }
            // j0 < nk, so the group holds at least one finite score
            const float m_new = fmaxf(m, smax);
            const float corr = expf(m - m_new);  // 0 on the first group
            l *= corr;
#pragma unroll
            for (int d = 0; d < HS; ++d) acc[d] *= corr;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                if (j < nk) {
                    const float p = expf(s[jj] - m_new);
                    l += p;
                    const float pw = round_to<T>(p);
                    const float4* vr = reinterpret_cast<const float4*>(v_s[j]);
#pragma unroll
                    for (int d4 = 0; d4 < HS / 4; ++d4) {
                        const float4 vv = vr[d4];
                        acc[4 * d4 + 0] = fmaf(pw, vv.x, acc[4 * d4 + 0]);
                        acc[4 * d4 + 1] = fmaf(pw, vv.y, acc[4 * d4 + 1]);
                        acc[4 * d4 + 2] = fmaf(pw, vv.z, acc[4 * d4 + 2]);
                        acc[4 * d4 + 3] = fmaf(pw, vv.w, acc[4 * d4 + 3]);
                    }
                }
            }
            m = m_new;
        }
    }

    if (q_valid) {
        const float inv_l = 1.f / l;
        T* op = out + ((size_t)b * T_len + tq) * C + (size_t)h * HS;
#pragma unroll
        for (int d = 0; d < HS; d += LV) {
            Vec<T, LV> o;
#pragma unroll
            for (int k = 0; k < LV; ++k) o.v[k] = from_float<T>(acc[d + k] * inv_l);
            *reinterpret_cast<Vec<T, LV>*>(op + d) = o;
        }
    }
}

}  // namespace

// qkv: (B, T, 3C) contiguous, out: (B, T, C) contiguous, both 16-byte
// aligned, C == NH * 32, B and NH at most 65535; scale is 1 / sqrt(32), given
// by the caller so that it is the same float the plain version multiplies by.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int unet_qkv_attention_fwd(const void* qkv, void* out, int B, int T_len, int C,
                                      int NH, float scale, int is_bf16, cudaStream_t stream) {
    if (B <= 0 || T_len <= 0 || NH <= 0 || C != NH * HS || B > 65535 || NH > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((T_len + QT - 1) / QT, NH, B), block(QT);
    if (is_bf16) {
        qkv_attention_fwd_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), T_len, C,
            NH, scale);
    } else {
        qkv_attention_fwd_kernel<float><<<grid, block, 0, stream>>>(
            static_cast<const float*>(qkv), static_cast<float*>(out), T_len, C, NH, scale);
    }
    return (int)cudaGetLastError();
}
