// GroupNorm + optional SiLU on an NHWC tensor: forward and backward.
//
// Forward.  Replaces the Pallas kernel `_fwd_kernel` of
// unet_tpu/ops/pallas/groupnorm.py (launched by `_fwd_call`, reached through
// `group_norm_act`): float32 mean and variance per (batch, group) over
// (H, W, C/G), z = (x - mean) * rstd * gamma + beta, z * sigmoid(z) when the
// activation is SiLU; y in x's type, mean and rstd (B, G) in float32.
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
//
// Backward.  Replaces the Pallas kernel `_bwd_kernel` of the same file
// (launched by `_bwd_call`, reached through `_gn_bwd`): from x, gamma, beta,
// the forward's mean and rstd and dy, recompute xhat = (x - mean) * rstd and
// dz = dy * s(z) (1 + z (1 - s(z))) with z = xhat * gamma + beta (dz = dy
// without activation); the per-batch float32 partials dbeta_b = sum_hw dz and
// dgamma_b = sum_hw dz * xhat (B, C); per group t1 = mean_g(dbeta_b * gamma)
// and t2 = mean_g(dgamma_b * gamma); dx = rstd (dz gamma - t1 - xhat t2) in
// x's type.  Bound: memory traffic again, x and dy read and dx written once.
// The sums are per channel, so here a thread owns V neighbouring channels of
// one row (C / V threads cover a row) and keeps V sums of each kind in
// registers.  The rows are cut into the forward's chunks, and the reduction
// has two stages without atomics, so a rerun gives the same bits:
//   1. gn_bwd_sums_kernel: per (batch, chunk) the chunk's sums per channel,
//      added over the block's row slots in a fixed order, to scratch memory;
//   2. gn_bwd_apply_kernel: each block adds the chunks' sums of its batch
//      element in chunk order (block 0 of the batch element writes them out
//      as dgamma_b, dbeta_b), forms t1 and t2 per group, and writes dx for
//      its own chunk (x and dy read a second time, mostly from the cache).

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

// d(loss)/dz from d(loss)/dy, where y = silu(z) or y = z.
__device__ __forceinline__ float dz_of(float dy, float xhat, float gamma, float beta,
                                       int act_silu) {
    if (!act_silu) return dy;
    const float z = xhat * gamma + beta;
    const float s = 1.f / (1.f + expf(-z));
    return dy * (s * (1.f + z * (1.f - s)));
}

template <typename T, int V>
__global__ void gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                                   const T* __restrict__ beta, const float* __restrict__ mean,
                                   const float* __restrict__ rstd, const T* __restrict__ dy,
                                   float* __restrict__ partials, int HW, int C, int G,
                                   int rows_per_chunk, int act_silu) {
    extern __shared__ float smem[];
    const int TPR = C / V, RS = blockDim.x / TPR;
    float* mean_s = smem;          // G
    float* rstd_s = mean_s + G;    // G
    float* gamma_s = rstd_s + G;   // C
    float* beta_s = gamma_s + C;   // C
    float* red = beta_s + C;       // 2 * RS * C: dbeta sums, then dgamma sums
    const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
    const int cg = C / G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        mean_s[g] = mean[(size_t)b * G + g];
        rstd_s[g] = rstd[(size_t)b * G + g];
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        gamma_s[c] = to_float<T>(gamma[c]);
        beta_s[c] = to_float<T>(beta[c]);
    }
    __syncthreads();

    const int c0 = (threadIdx.x % TPR) * V, rs = threadIdx.x / TPR;
    float db[V], dg[V];
#pragma unroll
    for (int k = 0; k < V; ++k) db[k] = dg[k] = 0.f;
    int r0, r1;
    chunk_rows(chunk, rows_per_chunk, HW, r0, r1);
    for (int r = r0 + rs; r < r1; r += RS) {
        const size_t off = ((size_t)b * HW + r) * C + c0;
        Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + off);
        Vec<T, V> dv = *reinterpret_cast<const Vec<T, V>*>(dy + off);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int c = c0 + k, g = c / cg;
            const float xhat = (to_float<T>(xv.v[k]) - mean_s[g]) * rstd_s[g];
            const float dz = dz_of(to_float<T>(dv.v[k]), xhat, gamma_s[c], beta_s[c], act_silu);
            db[k] += dz;
            dg[k] += dz * xhat;
        }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
        red[rs * C + c0 + k] = db[k];
        red[(RS + rs) * C + c0 + k] = dg[k];
    }
    __syncthreads();
    float* out = partials + ((size_t)b * nchunks + chunk) * 2 * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float sb = 0.f, sg = 0.f;
        for (int i = 0; i < RS; ++i) {
            sb += red[i * C + c];
            sg += red[(RS + i) * C + c];
        }
        out[c] = sb;
        out[C + c] = sg;
    }
}

template <typename T, int V>
__global__ void gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                                    const T* __restrict__ beta, const float* __restrict__ mean,
                                    const float* __restrict__ rstd, const T* __restrict__ dy,
                                    const float* __restrict__ partials, T* __restrict__ dx,
                                    float* __restrict__ dgamma_b, float* __restrict__ dbeta_b,
                                    int HW, int C, int G, int rows_per_chunk, int act_silu) {
    extern __shared__ float smem[];
    float* mean_s = smem;          // G
    float* rstd_s = mean_s + G;    // G
    float* t1_s = rstd_s + G;      // G
    float* t2_s = t1_s + G;        // G
    float* gamma_s = t2_s + G;     // C
    float* beta_s = gamma_s + C;   // C
    float* sb_s = beta_s + C;      // C: dbeta_b of this batch element
    float* sg_s = sb_s + C;        // C: dgamma_b
    const int TPR = C / V, RS = blockDim.x / TPR;
    const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
    const int cg = C / G;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        mean_s[g] = mean[(size_t)b * G + g];
        rstd_s[g] = rstd[(size_t)b * G + g];
    }
    const float* part = partials + (size_t)b * nchunks * 2 * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        gamma_s[c] = to_float<T>(gamma[c]);
        beta_s[c] = to_float<T>(beta[c]);
        float sb = 0.f, sg = 0.f;
        for (int i = 0; i < nchunks; ++i) {
            sb += part[(size_t)i * 2 * C + c];
            sg += part[(size_t)i * 2 * C + C + c];
        }
        sb_s[c] = sb;
        sg_s[c] = sg;
        if (chunk == 0) {
            dbeta_b[(size_t)b * C + c] = sb;
            dgamma_b[(size_t)b * C + c] = sg;
        }
    }
    __syncthreads();
    const float inv_n = 1.f / ((float)HW * (float)cg);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        float t1 = 0.f, t2 = 0.f;
        for (int c = g * cg; c < (g + 1) * cg; ++c) {
            t1 += sb_s[c] * gamma_s[c];
            t2 += sg_s[c] * gamma_s[c];
        }
        t1_s[g] = t1 * inv_n;
        t2_s[g] = t2 * inv_n;
    }
    __syncthreads();

    const int c0 = (threadIdx.x % TPR) * V, rs = threadIdx.x / TPR;
    int r0, r1;
    chunk_rows(chunk, rows_per_chunk, HW, r0, r1);
    for (int r = r0 + rs; r < r1; r += RS) {
        const size_t off = ((size_t)b * HW + r) * C + c0;
        Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + off);
        Vec<T, V> dv = *reinterpret_cast<const Vec<T, V>*>(dy + off);
        Vec<T, V> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int c = c0 + k, g = c / cg;
            const float xhat = (to_float<T>(xv.v[k]) - mean_s[g]) * rstd_s[g];
            const float dz = dz_of(to_float<T>(dv.v[k]), xhat, gamma_s[c], beta_s[c], act_silu);
            o.v[k] = from_float<T>(rstd_s[g] * (dz * gamma_s[c] - t1_s[g] - xhat * t2_s[g]));
        }
        *reinterpret_cast<Vec<T, V>*>(dx + off) = o;
    }
}

// Threads per block of the backward: C / V threads cover a row, and a block
// holds as many whole rows as fit in 256 threads (at least one).
inline int bwd_block(int C, int V) {
    const int tpr = C / V;
    return tpr >= 256 ? tpr : (256 / tpr) * tpr;
}

inline size_t bwd_sums_smem(int C, int G, int V) {
    const int rs = bwd_block(C, V) / (C / V);
    return (size_t)(2 * G + 2 * C + 2 * rs * C) * sizeof(float);
}

inline size_t bwd_apply_smem(int C, int G) { return (size_t)(4 * G + 4 * C) * sizeof(float); }

template <typename T, int V>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* beta, const float* mean,
                       const float* rstd, const void* dy, void* dx, float* dgamma_b,
                       float* dbeta_b, float* partials, int B, int HW, int C, int G,
                       int act_silu, int nchunks, int rows_per_chunk, cudaStream_t stream) {
    const dim3 grid(nchunks, B), block(bwd_block(C, V));
    gn_bwd_sums_kernel<T, V><<<grid, block, bwd_sums_smem(C, G, V), stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        mean, rstd, static_cast<const T*>(dy), partials, HW, C, G, rows_per_chunk, act_silu);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn_bwd_apply_kernel<T, V><<<grid, block, bwd_apply_smem(C, G), stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        mean, rstd, static_cast<const T*>(dy), partials, static_cast<T*>(dx), dgamma_b, dbeta_b,
        HW, C, G, rows_per_chunk, act_silu);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int vec, const void* x, const void* gamma, const void* beta,
                         const float* mean, const float* rstd, const void* dy, void* dx,
                         float* dgamma_b, float* dbeta_b, float* partials, int B, int HW, int C,
                         int G, int act_silu, int nchunks, int rows_per_chunk,
                         cudaStream_t stream) {
#define GN_BWD_CASE(V)                                                                     \
    case V:                                                                                \
        return launch_bwd<T, V>(x, gamma, beta, mean, rstd, dy, dx, dgamma_b, dbeta_b,     \
                                partials, B, HW, C, G, act_silu, nchunks, rows_per_chunk,  \
                                stream)
    switch (vec) {
        GN_BWD_CASE(1);
        GN_BWD_CASE(2);
        GN_BWD_CASE(4);
        GN_BWD_CASE(8);
    }
#undef GN_BWD_CASE
    return cudaErrorInvalidValue;
}

// Widest vector of V elements (at most 16 bytes) that divides n.
inline int vec_width(int n, int is_bf16) {
    const int max_vec = is_bf16 ? 8 : 4;
    int vec = 1;
    while (vec * 2 <= max_vec && n % (vec * 2) == 0) vec *= 2;
    return vec;
}

inline bool bad_chunking(int HW, int nchunks, int rows_per_chunk) {
    return nchunks <= 0 || rows_per_chunk <= 0 ||
           (size_t)(nchunks - 1) * rows_per_chunk >= (size_t)HW ||
           (size_t)nchunks * rows_per_chunk < (size_t)HW;
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
    if (B <= 0 || HW <= 0 || G <= 0 || G > 1024 || C % G != 0 ||
        bad_chunking(HW, nchunks, rows_per_chunk) ||
        (size_t)(2 * G + 2 * C) * sizeof(float) > 48 * 1024 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C / G, is_bf16);  // 16 bytes a thread at most
    cudaError_t err =
        is_bf16 ? dispatch<__nv_bfloat16>(vec, x, gamma, beta, y, mean, rstd, partials, B, HW,
                                          C, G, eps, act_silu, nchunks, rows_per_chunk, stream)
                : dispatch<float>(vec, x, gamma, beta, y, mean, rstd, partials, B, HW, C, G,
                                  eps, act_silu, nchunks, rows_per_chunk, stream);
    return (int)err;
}

// x, dy, dx: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of
// x's type; mean, rstd: (B, G) float32 from the forward; dgamma_b, dbeta_b:
// (B, C) float32 outputs; partials: (B, nchunks, 2, C) float32 scratch.
// The rows are cut as for the forward.  Requires C % G == 0, C / V <= 1024
// threads a row (V the vector width, 8 for bf16 and 4 for float32 when C
// allows) and both kernels' shared memory within 48 KB.  Returns the CUDA
// error code of the launches (0 = success).
extern "C" int unet_gn_act_bwd(const void* x, const void* gamma, const void* beta,
                               const float* mean, const float* rstd, const void* dy, void* dx,
                               float* dgamma_b, float* dbeta_b, float* partials, int B, int HW,
                               int C, int G, int act_silu, int is_bf16, int nchunks,
                               int rows_per_chunk, cudaStream_t stream) {
    if (B <= 0 || HW <= 0 || G <= 0 || C % G != 0 || B > 65535 ||
        bad_chunking(HW, nchunks, rows_per_chunk))
        return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C, is_bf16);
    if (C / vec > 1024 || bwd_sums_smem(C, G, vec) > 48 * 1024 ||
        bwd_apply_smem(C, G) > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaError_t err =
        is_bf16 ? dispatch_bwd<__nv_bfloat16>(vec, x, gamma, beta, mean, rstd, dy, dx, dgamma_b,
                                              dbeta_b, partials, B, HW, C, G, act_silu, nchunks,
                                              rows_per_chunk, stream)
                : dispatch_bwd<float>(vec, x, gamma, beta, mean, rstd, dy, dx, dgamma_b, dbeta_b,
                                      partials, B, HW, C, G, act_silu, nchunks, rows_per_chunk,
                                      stream);
    return (int)err;
}
