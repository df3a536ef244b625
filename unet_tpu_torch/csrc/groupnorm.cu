// GroupNorm + optional SiLU, forward, on an NHWC tensor.
//
// Replaces the Pallas kernel `_fwd_kernel` of unet_tpu/ops/pallas/groupnorm.py
// (launched by `_fwd_call`, reached through `group_norm_act`): float32 mean
// and variance per (batch, group) over (H, W, C/G), z = (x - mean) * rstd *
// gamma + beta, z * sigmoid(z) when the activation is SiLU; y in x's type,
// mean and rstd (B, G) in float32.
//
// Bound on an H100: memory traffic.  The function must read x once and
// write y once, 2 * B*H*W*C * itemsize bytes; the arithmetic is a few
// operations per element.
//
// Design.  In NHWC one group's elements are H*W runs of only C/G contiguous
// values, so a block per group would read short pieces at stride C.  Here a
// thread owns one group within one row: thread t works on group t % G of
// row t / G, so that G neighbouring threads read one whole contiguous row,
// each with one vector load per V elements, and sums its own group with no
// fold from channels to groups.  One batch element is too much for one block
// and too few blocks would leave most SMs idle, so the rows of a batch
// element are cut into chunks, one block each.  Blocks run in no order, so
// the reduction has two stages:
//   1. gn_stats_kernel: each block takes the mean of its chunk per group,
//      then the sum of squared differences from that mean (two passes over
//      the chunk, the second served by the cache), and writes (mean, M2)
//      per (batch, chunk, group) to scratch memory;
//   2. gn_apply_kernel: each block first combines the chunks' partials of
//      its batch element by the parallel-variance formula
//      (M2 = sum M2_i + n_i (mean_i - mean)^2), which has none of the
//      cancellation of E[x^2] - E[x]^2, then normalises its own chunk.
// The same stream orders the two launches.

#include "common.cuh"

namespace {

// Rows [r0, r1) of this block's chunk.
__device__ __forceinline__ void chunk_rows(int chunk, int rows_per_chunk, int HW,
                                           int& r0, int& r1) {
    r0 = chunk * rows_per_chunk;
    r1 = min(HW, r0 + rows_per_chunk);
}

// Sum over the row slots of one group; the result is valid in row slot 0.
__device__ __forceinline__ float reduce_row_slots(float* red, float v, int g, int rs,
                                                  int G, int RS) {
    red[rs * G + g] = v;
    __syncthreads();
    float tot = 0.f;
    if (rs == 0) {
        for (int i = 0; i < RS; ++i) tot += red[i * G + g];
    }
    return tot;
}

template <typename T, int V>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                int HW, int C, int G, int rows_per_chunk) {
    extern __shared__ float smem[];
    const int RS = blockDim.x / G;
    float* red = smem;            // RS * G
    float* mean_s = smem + RS * G;  // G
    const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
    const int g = threadIdx.x % G, rs = threadIdx.x / G;
    const int cg = C / G;
    int r0, r1;
    chunk_rows(chunk, rows_per_chunk, HW, r0, r1);
    const T* xg = x + (size_t)b * HW * C + (size_t)g * cg;

    float s = 0.f;
    for (int r = r0 + rs; r < r1; r += RS) {
        const T* p = xg + (size_t)r * C;
        for (int j = 0; j < cg; j += V) {
            Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p + j);
#pragma unroll
            for (int k = 0; k < V; ++k) s += to_float<T>(v.v[k]);
        }
    }
    float tot = reduce_row_slots(red, s, g, rs, G, RS);
    if (rs == 0) mean_s[g] = tot / (float)((r1 - r0) * cg);
    __syncthreads();
    const float mu = mean_s[g];

    float s2 = 0.f;
    for (int r = r0 + rs; r < r1; r += RS) {
        const T* p = xg + (size_t)r * C;
        for (int j = 0; j < cg; j += V) {
            Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p + j);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                float d = to_float<T>(v.v[k]) - mu;
                s2 += d * d;
            }
        }
    }
    float m2 = reduce_row_slots(red, s2, g, rs, G, RS);
    if (rs == 0) {
        float* out = partials + (((size_t)b * nchunks + chunk) * G + g) * 2;
        out[0] = mu;
        out[1] = m2;
    }
}

template <typename T, int V>
__global__ void gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                                const T* __restrict__ beta,
                                const float* __restrict__ partials, T* __restrict__ y,
                                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                int HW, int C, int G, int rows_per_chunk, float eps,
                                int act_silu) {
    extern __shared__ float smem[];
    float* mean_s = smem;          // G
    float* rstd_s = smem + G;      // G
    float* gamma_s = smem + 2 * G;  // C
    float* beta_s = gamma_s + C;   // C
    const int RS = blockDim.x / G;
    const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
    const int cg = C / G;

    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        const float* part = partials + ((size_t)b * nchunks * G + g) * 2;
        const float n_all = (float)HW * (float)cg;
        float mean = 0.f;
        for (int i = 0; i < nchunks; ++i) {
            int q0, q1;
            chunk_rows(i, rows_per_chunk, HW, q0, q1);
            mean += (float)((q1 - q0) * cg) * part[(size_t)i * G * 2];
        }
        mean /= n_all;
        float m2 = 0.f;
        for (int i = 0; i < nchunks; ++i) {
            int q0, q1;
            chunk_rows(i, rows_per_chunk, HW, q0, q1);
            float d = part[(size_t)i * G * 2] - mean;
            m2 += part[(size_t)i * G * 2 + 1] + (float)((q1 - q0) * cg) * d * d;
        }
        float rstd = rsqrtf(m2 / n_all + eps);
        mean_s[g] = mean;
        rstd_s[g] = rstd;
        if (chunk == 0) {
            mean_out[(size_t)b * G + g] = mean;
            rstd_out[(size_t)b * G + g] = rstd;
        }
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        gamma_s[c] = to_float<T>(gamma[c]);
        beta_s[c] = to_float<T>(beta[c]);
    }
    __syncthreads();

    const int g = threadIdx.x % G, rs = threadIdx.x / G;
    const float mean = mean_s[g], rstd = rstd_s[g];
    int r0, r1;
    chunk_rows(chunk, rows_per_chunk, HW, r0, r1);
    const size_t base = (size_t)b * HW * C + (size_t)g * cg;
    for (int r = r0 + rs; r < r1; r += RS) {
        const size_t off = base + (size_t)r * C;
        for (int j = 0; j < cg; j += V) {
            Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(x + off + j);
            Vec<T, V> o;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const int c = g * cg + j + k;
                float z = (to_float<T>(v.v[k]) - mean) * rstd * gamma_s[c] + beta_s[c];
                if (act_silu) z = z / (1.f + expf(-z));
                o.v[k] = from_float<T>(z);
            }
            *reinterpret_cast<Vec<T, V>*>(y + off + j) = o;
        }
    }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   float* mean, float* rstd, float* partials, int B, int HW, int C, int G,
                   float eps, int act_silu, int nchunks, int rows_per_chunk,
                   cudaStream_t stream) {
    const int RS = G >= 256 ? 1 : 256 / G;
    const dim3 grid(nchunks, B), block(G * RS);
    const size_t smem_stats = (size_t)(RS * G + G) * sizeof(float);
    const size_t smem_apply = (size_t)(2 * G + 2 * C) * sizeof(float);
    gn_stats_kernel<T, V><<<grid, block, smem_stats, stream>>>(
        static_cast<const T*>(x), partials, HW, C, G, rows_per_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn_apply_kernel<T, V><<<grid, block, smem_apply, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        partials, static_cast<T*>(y), mean, rstd, HW, C, G, rows_per_chunk, eps, act_silu);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, const void* gamma, const void* beta, void* y,
                     float* mean, float* rstd, float* partials, int B, int HW, int C, int G,
                     float eps, int act_silu, int nchunks, int rows_per_chunk,
                     cudaStream_t stream) {
#define GN_CASE(V)                                                                       \
    case V:                                                                              \
        return launch<T, V>(x, gamma, beta, y, mean, rstd, partials, B, HW, C, G, eps,   \
                            act_silu, nchunks, rows_per_chunk, stream)
    switch (vec) {
        GN_CASE(1);
        GN_CASE(2);
        GN_CASE(4);
        GN_CASE(8);
    }
#undef GN_CASE
    return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of x's type;
// mean, rstd: (B, G) float32; partials: (B, nchunks, G, 2) float32 scratch.
// The rows of a batch element are cut into `nchunks` chunks of
// `rows_per_chunk` rows (the last may be shorter, none is empty).
// Requires G <= 1024, C % G == 0 and (2G + 2C) floats of shared memory
// within 48 KB.  Returns the CUDA error code of the launches (0 = success).
extern "C" int unet_gn_act_fwd(const void* x, const void* gamma, const void* beta, void* y,
                               float* mean, float* rstd, float* partials, int B, int HW,
                               int C, int G, float eps, int act_silu, int is_bf16,
                               int nchunks, int rows_per_chunk, cudaStream_t stream) {
    if (B <= 0 || HW <= 0 || G <= 0 || G > 1024 || C % G != 0 || nchunks <= 0 ||
        (size_t)(nchunks - 1) * rows_per_chunk >= (size_t)HW ||
        (size_t)nchunks * rows_per_chunk < (size_t)HW ||
        (size_t)(2 * G + 2 * C) * sizeof(float) > 48 * 1024 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int cg = C / G;
    const int max_vec = is_bf16 ? 8 : 4;  // 16 bytes a thread
    int vec = 1;
    while (vec * 2 <= max_vec && cg % (vec * 2) == 0) vec *= 2;
    cudaError_t err =
        is_bf16 ? dispatch<__nv_bfloat16>(vec, x, gamma, beta, y, mean, rstd, partials, B, HW,
                                          C, G, eps, act_silu, nchunks, rows_per_chunk, stream)
                : dispatch<float>(vec, x, gamma, beta, y, mean, rstd, partials, B, HW, C, G,
                                  eps, act_silu, nchunks, rows_per_chunk, stream);
    return (int)err;
}
