// Non-causal multi-head attention straight from the packed QKV: forward and
// backward.
//
// Forward.  Replaces the Pallas kernel `_fwd_kernel` of
// unet_tpu/ops/pallas/attention.py (launched by `_fwd_call`, reached through
// `qkv_attention_fused`): qkv is (B, T, 3C) laid out [q | k | v], each C split
// contiguously into (NH, HS); per head qs = q / sqrt(HS) rounded to the input
// type, s = qs k^T in float32, a float32 softmax over all keys, out = (p
// rounded to the input type) v accumulated in float32 and written at column
// h * HS of (B, T, C).  No (B, NH, T, T) tensor reaches device memory.
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
//
// Backward.  Replaces the Pallas kernel `_bwd_kernel` of the same file
// (launched by `_bwd_call`, reached through `_att_bwd`): from qkv and dout
// alone, recompute s and p = softmax(s); dp = dout v^T; ds = p (dp - D) with
// D = rowsum(dp * p); dq = (ds k) * scale, dk = ds^T qs, dv = p^T dout, written
// as d(qkv) (B, T, 3C).  The TPU kernel's rounding points are kept: dout is
// taken in v's type, p stays float32 inside ds, ds and p are rounded to the
// input type before their products, every product accumulates in float32.
// Bound: 10 * B*NH*T*T*HS operations against 7 * B*T*C * itemsize bytes, so
// operations above T of about a hundred.  The TPU kernel adds dk and dv over
// its query blocks in a scratch buffer, relying on the grid running in
// order; blocks here run in no order, so the work is split by what each
// thread owns, with no atomics:
//   1. qkv_attention_bwd_dq_kernel, one thread per query, like the forward:
//      a first sweep over the key tiles takes the row's softmax maximum m,
//      its sum l and D (online, rescaled per group of SG keys as in the
//      forward); a second sweep recomputes p = exp(s - m) / l and ds and
//      accumulates dq.  It writes dq and the row statistics m, 1/l and D,
//      (B, NH, T) float32 each;
//   2. qkv_attention_bwd_dkv_kernel, one thread per key: its k and v rows
//      and its dk and dv sums stay in registers while the query tiles (qs,
//      dout and the three statistics) pass through shared memory; it
//      recomputes s, p, dp and ds with the same operands in the same order
//      as kernel 1, so both see the same p.

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


__device__ __forceinline__ float dot_hs(const float* a, const float* b) {
    // the forward's order of FMAs: d = 0 .. HS-1
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HS; ++d) dot = fmaf(a[d], b[d], dot);
    return dot;
}

// Loads row `tq` of the head's q (scaled and rounded as the forward does)
// and of dout into registers; zeros for a row past the end.
template <typename T>
__device__ __forceinline__ void load_q_dout(const T* qkv, const T* dout, int b, int h, int tq,
                                            int T_len, int C, float scale, float* q,
                                            float* dob) {
#pragma unroll
    for (int d = 0; d < HS; ++d) q[d] = dob[d] = 0.f;
    if (tq >= T_len) return;
    const T* qp = qkv + ((size_t)b * T_len + tq) * 3 * C + (size_t)h * HS;
    const T* op = dout + ((size_t)b * T_len + tq) * C + (size_t)h * HS;
#pragma unroll
    for (int d = 0; d < HS; d += LV) {
        Vec<T, LV> qv = *reinterpret_cast<const Vec<T, LV>*>(qp + d);
        Vec<T, LV> ov = *reinterpret_cast<const Vec<T, LV>*>(op + d);
#pragma unroll
        for (int k = 0; k < LV; ++k) {
            q[d + k] = round_to<T>(to_float<T>(qv.v[k]) * scale);
            dob[d + k] = to_float<T>(ov.v[k]);
        }
    }
}

// Fills the shared tiles with keys and values [k0, k0 + nk) of the head.
template <typename T>
__device__ __forceinline__ void load_kv_tile(const T* base, size_t row, int C, int k0, int nk,
                                             float (*k_s)[HS], float (*v_s)[HS]) {
    for (int e = threadIdx.x * LV; e < nk * HS; e += blockDim.x * LV) {
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
}

template <typename T>
__global__ void __launch_bounds__(QT)
qkv_attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            T* __restrict__ dqkv, float* __restrict__ stats, int T_len, int C,
                            int NH, float scale) {
    __shared__ __align__(16) float k_s[KT][HS];
    __shared__ __align__(16) float v_s[KT][HS];
    const int h = blockIdx.y, b = blockIdx.z;
    const int tq = blockIdx.x * QT + threadIdx.x;
    const size_t row = (size_t)3 * C;
    const T* base = qkv + (size_t)b * T_len * row + (size_t)h * HS;

    float q[HS], dob[HS];
    load_q_dout<T>(qkv, dout, b, h, tq, T_len, C, scale, q, dob);

    // Sweep 1: the row's maximum m, sum l and D * l, online.
    float m = -INFINITY, l = 0.f, dl = 0.f;
    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();  // the previous tile has been consumed
        load_kv_tile<T>(base, row, C, k0, nk, k_s, v_s);
        __syncthreads();
        for (int j0 = 0; j0 < nk; j0 += SG) {
            float s[SG], dp[SG];
            float smax = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < SG; ++jj) {
                const int j = j0 + jj;
                s[jj] = j < nk ? dot_hs(q, k_s[j]) : -INFINITY;
                dp[jj] = j < nk ? dot_hs(dob, v_s[j]) : 0.f;
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

    // Sweep 2: dq = sum_j round(ds_j) k_j.
    float dq[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) dq[d] = 0.f;
    for (int k0 = 0; k0 < T_len; k0 += KT) {
        const int nk = min(KT, T_len - k0);
        __syncthreads();
        load_kv_tile<T>(base, row, C, k0, nk, k_s, v_s);
        __syncthreads();
        for (int j = 0; j < nk; ++j) {
            const float p = expf(dot_hs(q, k_s[j]) - m) * inv_l;
            const float ds = round_to<T>(p * (dot_hs(dob, v_s[j]) - D));
            const float4* kr = reinterpret_cast<const float4*>(k_s[j]);
#pragma unroll
            for (int d4 = 0; d4 < HS / 4; ++d4) {
                const float4 kk = kr[d4];
                dq[4 * d4 + 0] = fmaf(ds, kk.x, dq[4 * d4 + 0]);
                dq[4 * d4 + 1] = fmaf(ds, kk.y, dq[4 * d4 + 1]);
                dq[4 * d4 + 2] = fmaf(ds, kk.z, dq[4 * d4 + 2]);
                dq[4 * d4 + 3] = fmaf(ds, kk.w, dq[4 * d4 + 3]);
            }
        }
    }

    if (tq < T_len) {
        T* op = dqkv + ((size_t)b * T_len + tq) * row + (size_t)h * HS;
#pragma unroll
        for (int d = 0; d < HS; d += LV) {
            Vec<T, LV> o;
#pragma unroll
            for (int k = 0; k < LV; ++k) o.v[k] = from_float<T>(dq[d + k] * scale);
            *reinterpret_cast<Vec<T, LV>*>(op + d) = o;
        }
        const size_t plane = (size_t)gridDim.z * NH * T_len;
        const size_t at = ((size_t)b * NH + h) * T_len + tq;
        stats[at] = m;
        stats[plane + at] = inv_l;
        stats[2 * plane + at] = D;
    }
}

template <typename T>
__global__ void __launch_bounds__(KT)
qkv_attention_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                             T* __restrict__ dqkv, const float* __restrict__ stats, int T_len,
                             int C, int NH, float scale) {
    __shared__ __align__(16) float q_s[QT][HS];
    __shared__ __align__(16) float o_s[QT][HS];
    __shared__ float m_s[QT], il_s[QT], d_s[QT];
    const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int tk = blockIdx.x * KT + tid;
    const size_t row = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const float* st = stats + ((size_t)b * NH + h) * T_len;

    float k[HS], v[HS], dk[HS], dv[HS];
#pragma unroll
    for (int d = 0; d < HS; ++d) k[d] = v[d] = dk[d] = dv[d] = 0.f;
    if (tk < T_len) {
        const T* kp = qkv + ((size_t)b * T_len + tk) * row + C + (size_t)h * HS;
#pragma unroll
        for (int d = 0; d < HS; d += LV) {
            Vec<T, LV> kv = *reinterpret_cast<const Vec<T, LV>*>(kp + d);
            Vec<T, LV> vv = *reinterpret_cast<const Vec<T, LV>*>(kp + C + d);
#pragma unroll
            for (int e = 0; e < LV; ++e) {
                k[d + e] = to_float<T>(kv.v[e]);
                v[d + e] = to_float<T>(vv.v[e]);
            }
        }
    }

    for (int q0 = 0; q0 < T_len; q0 += QT) {
        const int nq = min(QT, T_len - q0);
        __syncthreads();  // the previous tile has been consumed
        for (int e = tid * LV; e < nq * HS; e += KT * LV) {
            const int i = e / HS, d = e % HS;
            const size_t tok = (size_t)b * T_len + q0 + i;
            Vec<T, LV> qv = *reinterpret_cast<const Vec<T, LV>*>(qkv + tok * row + h * HS + d);
            Vec<T, LV> ov = *reinterpret_cast<const Vec<T, LV>*>(dout + tok * C + h * HS + d);
#pragma unroll
            for (int c = 0; c < LV; ++c) {
                q_s[i][d + c] = round_to<T>(to_float<T>(qv.v[c]) * scale);
                o_s[i][d + c] = to_float<T>(ov.v[c]);
            }
        }
        for (int i = tid; i < nq; i += KT) {
            m_s[i] = st[q0 + i];
            il_s[i] = st[plane + q0 + i];
            d_s[i] = st[2 * plane + q0 + i];
        }
        __syncthreads();
        for (int i = 0; i < nq; ++i) {
            const float p = expf(dot_hs(q_s[i], k) - m_s[i]) * il_s[i];
            const float ds = round_to<T>(p * (dot_hs(o_s[i], v) - d_s[i]));
            const float pr = round_to<T>(p);
            const float4* qr = reinterpret_cast<const float4*>(q_s[i]);
            const float4* orow = reinterpret_cast<const float4*>(o_s[i]);
#pragma unroll
            for (int d4 = 0; d4 < HS / 4; ++d4) {
                const float4 qq = qr[d4], oo = orow[d4];
                dk[4 * d4 + 0] = fmaf(ds, qq.x, dk[4 * d4 + 0]);
                dk[4 * d4 + 1] = fmaf(ds, qq.y, dk[4 * d4 + 1]);
                dk[4 * d4 + 2] = fmaf(ds, qq.z, dk[4 * d4 + 2]);
                dk[4 * d4 + 3] = fmaf(ds, qq.w, dk[4 * d4 + 3]);
                dv[4 * d4 + 0] = fmaf(pr, oo.x, dv[4 * d4 + 0]);
                dv[4 * d4 + 1] = fmaf(pr, oo.y, dv[4 * d4 + 1]);
                dv[4 * d4 + 2] = fmaf(pr, oo.z, dv[4 * d4 + 2]);
                dv[4 * d4 + 3] = fmaf(pr, oo.w, dv[4 * d4 + 3]);
            }
        }
    }

    if (tk < T_len) {
        T* kp = dqkv + ((size_t)b * T_len + tk) * row + C + (size_t)h * HS;
#pragma unroll
        for (int d = 0; d < HS; d += LV) {
            Vec<T, LV> ok, ov;
#pragma unroll
            for (int e = 0; e < LV; ++e) {
                ok.v[e] = from_float<T>(dk[d + e]);
                ov.v[e] = from_float<T>(dv[d + e]);
            }
            *reinterpret_cast<Vec<T, LV>*>(kp + d) = ok;
            *reinterpret_cast<Vec<T, LV>*>(kp + C + d) = ov;
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

// qkv, dqkv: (B, T, 3C), dout: (B, T, C), all contiguous and 16-byte
// aligned, of one type; stats: (3, B, NH, T) float32 scratch (the rows' m,
// 1/l and D, written by the first kernel and read by the second).  C == NH *
// 32, B and NH at most 65535; scale as for the forward.  Returns the CUDA
// error code of the launches (0 = success).
extern "C" int unet_qkv_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                      float* stats, int B, int T_len, int C, int NH, float scale,
                                      int is_bf16, cudaStream_t stream) {
    if (B <= 0 || T_len <= 0 || NH <= 0 || C != NH * HS || B > 65535 || NH > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid_q((T_len + QT - 1) / QT, NH, B), grid_k((T_len + KT - 1) / KT, NH, B);
    cudaError_t err;
    if (is_bf16) {
        using T = __nv_bfloat16;
        qkv_attention_bwd_dq_kernel<T><<<grid_q, QT, 0, stream>>>(
            static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
            stats, T_len, C, NH, scale);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        qkv_attention_bwd_dkv_kernel<T><<<grid_k, KT, 0, stream>>>(
            static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
            stats, T_len, C, NH, scale);
    } else {
        qkv_attention_bwd_dq_kernel<float><<<grid_q, QT, 0, stream>>>(
            static_cast<const float*>(qkv), static_cast<const float*>(dout),
            static_cast<float*>(dqkv), stats, T_len, C, NH, scale);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        qkv_attention_bwd_dkv_kernel<float><<<grid_k, KT, 0, stream>>>(
            static_cast<const float*>(qkv), static_cast<const float*>(dout),
            static_cast<float*>(dqkv), stats, T_len, C, NH, scale);
    }
    return (int)cudaGetLastError();
}
