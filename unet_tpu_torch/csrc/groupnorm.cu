// GroupNorm + optional SiLU on an NHWC tensor: forward and backward, one
// launch each.
//
// Forward.  Replaces the Pallas kernel `_fwd_kernel` of
// unet_tpu/ops/pallas/groupnorm.py (launched by `_fwd_call`, reached through
// `group_norm_act`): float32 mean and variance per (batch, group) over
// (H, W, C/G), z = (x - mean) * rstd * gamma + beta, z * sigmoid(z) when the
// activation is SiLU; y in x's type, mean and rstd (B, G) in float32.
//
// Backward.  Replaces the Pallas kernel `_bwd_kernel` of the same file
// (launched by `_bwd_call`, reached through `_gn_bwd`): from x, gamma, beta,
// the forward's mean and rstd and dy, recompute xhat = (x - mean) * rstd and
// dz = dy * s(z) (1 + z (1 - s(z))) with z = xhat * gamma + beta (dz = dy
// without activation); the per-batch float32 partials dbeta_b = sum_hw dz and
// dgamma_b = sum_hw dz * xhat (B, C); per group t1 = mean_g(dbeta_b * gamma)
// and t2 = mean_g(dgamma_b * gamma); dx = rstd (dz gamma - t1 - xhat t2) in
// x's type.
//
// Bound on an H100: memory traffic.  The forward must read x and write y
// once, the backward read x and dy and write dx once; the arithmetic is a
// few operations per element (a few tens for the backward's SiLU
// derivative, which both of its passes need).
//
// Design.  The TPU kernel keeps one batch element's (H, W, C) slab in its
// fast memory, so x leaves device memory once however many passes the
// statistics take.  Here one thread-block cluster (up to 16 blocks on
// neighbouring SMs, each able to read the others' shared memory) works on
// one batch element: grid (cluster, B), cluster dims (cluster, 1, 1).  The
// block of rank r takes rows [r * rows_per_block, ...) of the element's H*W
// rows, in NHWC one contiguous run of rows * C values.  Its rows pass
// through a ring of kSlots tiles in shared memory, each tile copied in by
// bulk copies (`cp.async.bulk`) that complete on the tile's `mbarrier`, so
// that a pass works on one tile while the next ones arrive (`Rows`).  Where
// the block's rows fit in the ring (every bfloat16 shape of the U-Net) they
// are copied once and stay, so every pass after the first reads shared
// memory; where they do not, every pass streams them through the ring
// again (the repeats mostly from L2).  Where C * itemsize is no multiple of
// 16 (no bulk copy), every pass reads device memory.  All in one launch.
//
// Inside a block, thread t takes the V neighbouring channels (16 bytes when
// C allows) at (t % L) * V, in rows t / L, + RS, + 2 RS, ..., where L threads
// cover a row (L = C / V, or the whole block where a row has more vectors
// than a block has threads: then each thread also takes the channels
// J * L * V further on, J = 1, 2, ..., one pass over the rows for each):
// neighbouring threads read neighbouring pieces of a row, and a thread's
// channels, their groups and its constants (mean, rstd, gamma, beta) are the
// same in every row, so they are loaded once, before the row loops.  Sums
// are kept per channel in registers and folded over the row slots (within
// a warp by shuffles where it holds several), then over a group's channels,
// through shared memory in a fixed order.
//
//   forward: the block's mean per group, then (a second pass) its sum of
//     squared differences from that mean, M2.  Every block then copies the
//     (mean, M2) of every block of its cluster from their shared memory and
//     combines them by the parallel-variance formula
//     M2 = sum_i M2_i + n_i (mean_i - mean)^2 (none of the cancellation of
//     E[x^2] - E[x]^2) in rank order, so all hold the same bits; then it
//     normalises its rows.
//   backward: pass 1 sums dz and dz * xhat per channel; every block adds the
//     cluster's sums (slices of the ranks side by side, then the slices in
//     order; rank 0 writes dgamma_b and dbeta_b), forms t1 and t2 per group,
//     and writes dx in pass 2.
//
// Nothing goes through device memory between the passes and no atomics are
// used, so a rerun gives the same bits.  A block's shared memory may be read
// by the others only while it runs: after its last read of another block's
// shared memory every thread arrives at the cluster barrier, and the block
// waits on that barrier before it exits.

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>
#include <set>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace {

namespace cgrp = cooperative_groups;

constexpr int kTargetThreads = 256;
// At most this many threads a block: 512, but 256 for the backward at 8
// values a thread, which needs the registers (at 128 a thread, it spills).
constexpr int kMaxThreads = 512;
constexpr int kMaxThreadsBwd8 = 256;
constexpr int kMaxCluster = 16;
constexpr int kSlots = 4;
constexpr int kMaxSmem = 227 * 1024;  // what one block may use on an H100

// C / V threads cover a row; a block holds as many whole rows as fit in
// kTargetThreads (at least one).  Where a row has more vectors than the
// block's cap, each thread takes J of them, in ceil(C / V / J) threads.
__host__ __device__ constexpr int max_threads(int backward, int V) {
    return backward && V >= 8 ? kMaxThreadsBwd8 : kMaxThreads;
}

__host__ __device__ inline int block_threads(int backward, int C, int V) {
    const int per_row = C / V, cap = max_threads(backward, V);
    if (per_row < kTargetThreads) return (kTargetThreads / per_row) * per_row;
    const int J = (per_row + cap - 1) / cap;
    return (per_row + J - 1) / J;
}

// Floats of shared memory beside the staged rows (see the kernels' layouts).
__host__ __device__ inline size_t smem_floats(int backward, int cluster, int RS, int C, int G) {
    return backward ? 2 * (size_t)RS * C + 4 * (size_t)C + 2 * (size_t)G
                    : (size_t)RS * C + C + (4 + 2 * (size_t)cluster) * G;
}

// Offset of the mbarriers, after the staged rows and the floats.
__host__ __device__ inline size_t barrier_offset(size_t staged_bytes, size_t floats) {
    return (staged_bytes + 4 * floats + 7) / 8 * 8;
}

// Bytes of the ring of a block's rows (x, and dy in the backward): room for
// all of them, or for kSlots tiles, whichever is less; none where rows are
// not staged (C * itemsize no multiple of 16).
__host__ __device__ inline size_t ring_bytes(int backward, int rows_per_block, int tile_rows,
                                             int C, int V, int item) {
    if (V * item != 16) return 0;
    return (size_t)(backward ? 2 : 1) * min(rows_per_block, kSlots * tile_rows) * C * item;
}

// Bytes of dynamic shared memory of one block.  The wrapper counts the same
// (ops/kernels/groupnorm.py::smem_bytes) to choose the geometry.
inline size_t smem_bytes(int backward, int cluster, int rows_per_block, int tile_rows, int C,
                         int G, int V, int item) {
    const int threads = block_threads(backward, C, V);
    const int RS = threads / min(C / V, threads);
    return barrier_offset(ring_bytes(backward, rows_per_block, tile_rows, C, V, item),
                          smem_floats(backward, cluster, RS, C, G)) +
           8 * kSlots;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

#ifdef GN_PHASE_CLOCKS
// A build with -DGN_PHASE_CLOCKS (utils/gn_phases.py) keeps thread 0's
// cycle counter at each phase boundary of the first kClockBlocks blocks,
// and the global timer (ns) at the start and the end.
constexpr int kClockBlocks = 4096, kClockSlots = 16;
__device__ long long g_phase_clocks[kClockBlocks * kClockSlots];
#define PHASE(i)                                                                  \
    do {                                                                          \
        const int blk_ = blockIdx.y * gridDim.x + blockIdx.x;                     \
        if (threadIdx.x == 0 && blk_ < kClockBlocks) {                            \
            long long ns_;                                                        \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));               \
            g_phase_clocks[blk_ * kClockSlots + (i)] = clock64();                 \
            if ((i) == 0) g_phase_clocks[blk_ * kClockSlots + 14] = ns_;          \
            g_phase_clocks[blk_ * kClockSlots + 15] = ns_;                        \
        }                                                                         \
    } while (0)
#else
#define PHASE(i) \
    do {         \
    } while (0)
#endif

// Where a block's rows come from.  Staged (STAGED), they pass through a
// ring of kSlots slots of `tile_rows` rows in shared memory, one tile a
// slot, each copied in by one thread's bulk copies and completing on the
// slot's mbarrier.  Where the block's tiles fit in the ring (`resident`)
// each is copied once and every pass after the first reads shared memory;
// otherwise every pass streams the tiles through the ring again, the next
// kSlots - 1 tiles' copies in flight while one is read.  Not staged, every
// pass reads device memory.  x and, in the backward, dy (n = 1 or 2).
template <typename T, bool STAGED>
struct Rows {
    const T* src[2];  // the block's first row in device memory
    T* buf[2];        // the ring (STAGED)
    int n, C, nrows, tile_rows, ntiles, passes;
    uint64_t* bars;

    __device__ bool resident() const { return ntiles <= kSlots; }

    // Thread 0: the copy of the q-th tile of the whole sequence (tile
    // q % ntiles, into slot q % kSlots).
    __device__ void issue(int q) const {
        const int t = q % ntiles, slot = q % kSlots;
        const int r0 = t * tile_rows, r1 = min(nrows, r0 + tile_rows);
        const uint32_t bytes = static_cast<uint32_t>((size_t)(r1 - r0) * C * sizeof(T));
        mbar_arrive_expect_tx(&bars[slot], n * bytes);
        for (int i = 0; i < n; ++i)
            bulk_load(buf[i] + (size_t)slot * tile_rows * C, src[i] + (size_t)r0 * C, bytes,
                      &bars[slot]);
    }

    // Every thread: set up the barriers and start the first copies.
    __device__ void start() const {
        if (!STAGED) return;
        if (threadIdx.x == 0) {
            for (int j = 0; j < kSlots; ++j) mbar_init(&bars[j], 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            const int total = resident() ? ntiles : passes * ntiles;
            for (int q = 0; q < min(kSlots, total); ++q) issue(q);
        }
    }

    // f(r, x row, dy row) for this thread's rows r = rs, rs + RS, ... of
    // the block, in pass `pass` (0, 1, ... passes - 1; every thread takes
    // part in every pass, in order).
    template <typename F>
    __device__ __forceinline__ void pass_over(int pass, int rs, int RS, F f) const {
        const bool res = resident();
        if (!STAGED || (res && pass > 0)) {  // every row where it stays
            const T* s0 = STAGED ? buf[0] : src[0];
            const T* s1 = STAGED ? buf[1] : src[1];
            for (int r = rs; r < nrows; r += RS)
                f(r, s0 + (size_t)r * C, n > 1 ? s1 + (size_t)r * C : nullptr);
            return;
        }
        for (int t = 0; t < ntiles; ++t) {
            const int q = res ? t : pass * ntiles + t, slot = q % kSlots;
            mbar_wait(&bars[slot], (q / kSlots) & 1);
            const int r0 = t * tile_rows, r1 = min(nrows, r0 + tile_rows);
            const size_t shift = ((size_t)slot * tile_rows - r0) * C;  // row r at r * C + shift
            for (int r = r0 + (rs - r0 % RS + RS) % RS; r < r1; r += RS)
                f(r, buf[0] + shift + (size_t)r * C,
                  n > 1 ? buf[1] + shift + (size_t)r * C : nullptr);
            if (!res) {  // the slot is free again once every thread is done with it
                __syncthreads();
                if (threadIdx.x == 0 && q + kSlots < passes * ntiles) issue(q + kSlots);
            }
        }
    }
};

// The logistic function with the hardware's exponential and reciprocal
// (a few ulp, against the many instructions of expf and a division).
__device__ __forceinline__ float sigmoid(float z) {
    return __fdividef(1.f, 1.f + __expf(-z));
}

template <typename T, int V>
__device__ __forceinline__ void load_floats(const T* p, float (&f)[V]) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_float<T>(v.v[k]);
}

// Lanes that one group's fold is spread over: a power of two, at most 32,
// with G groups of them in the block.
__device__ __forceinline__ int fold_lanes(int G) {
    int lanes = 1;
    while (lanes < 32 && 2 * lanes * G <= (int)blockDim.x) lanes *= 2;
    return lanes;
}

// The sum over P neighbouring lanes (a power of two; lanes t < `active`
// take part, whole groups of P of them), in a fixed order.
__device__ __forceinline__ float lanes_sum(float s, int P, int t, int active) {
    if (P > 1) {
        const int in_warp = active - (t & ~31);
        const unsigned mask = in_warp >= 32 ? 0xffffffffu : (1u << in_warp) - 1;
        for (int off = P / 2; off > 0; off /= 2) s += __shfl_xor_sync(mask, s, off);
    }
    return s;
}

// Whether a warp holds several row slots (L threads a row divides 32; then
// blockDim.x is kTargetThreads, whole warps, and a thread takes one vector
// of a row).
__device__ __forceinline__ bool warp_slots(int L) { return L < 32 && 32 % L == 0; }

// Puts this thread's per-channel values v (channels c0 ... c0 + V - 1 of row
// slot rs; none where c0 >= C) into red.  Where a warp holds several row
// slots they are first added across the warp by shuffles, so that red holds
// one row a warp.
template <int V>
__device__ __forceinline__ void deposit(float (&v)[V], float* red, int rs, int c0, int L, int C) {
    if (warp_slots(L)) {
#pragma unroll
        for (int k = 0; k < V; ++k)
            for (int off = L; off < 32; off *= 2) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        if ((threadIdx.x & 31) < L) {
#pragma unroll
            for (int k = 0; k < V; ++k) red[(threadIdx.x / 32) * C + c0 + k] = v[k];
        }
    } else if (c0 < C) {
#pragma unroll
        for (int k = 0; k < V; ++k) red[rs * C + c0 + k] = v[k];
    }
}

// Each group's sum over the block of what `deposit` put into red, divided
// by n: out[2 g].  The row slots are added per channel (one thread a
// channel), then P neighbouring lanes take a group's channels and shuffles
// add the lanes; a fixed order throughout.
__device__ __forceinline__ void group_sums(float* red, float* chan, float* out, int RS, int L,
                                           int C, int G, float n) {
    __syncthreads();
    const int rows = warp_slots(L) ? blockDim.x / 32 : RS;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float sum = 0.f;
        for (int i = 0; i < rows; ++i) sum += red[i * C + c];
        chan[c] = sum;
    }
    __syncthreads();
    const int cg = C / G, P = fold_lanes(G);
    for (int t = threadIdx.x; t < G * P; t += blockDim.x) {
        const int g = t / P, p = t % P;
        float sum = 0.f;
        for (int j = p; j < cg; j += P) sum += chan[g * cg + j];
        sum = lanes_sum(sum, P, t, G * P);
        if (p == 0) out[2 * g] = sum / n;
    }
    __syncthreads();
}

// The forward (K4), or with STATS its statistics alone (gn_stats, K4a:
// two passes, then each block merges a slice of the groups and writes their
// (mean, M2) to mean_out (B, G, 2); gamma, beta, y and rstd_out are not
// read).
template <typename T, int V, bool WIDE, bool STATS>
__device__ __forceinline__ void gn_fwd(const T* __restrict__ x, const T* __restrict__ gamma,
                                       const T* __restrict__ beta, T* __restrict__ y,
                                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                       int HW, int C, int G, int rows_per_block, int tile_rows,
                                       float eps, int act_silu) {
    constexpr bool kStaged = V * sizeof(T) == 16;
    extern __shared__ __align__(16) unsigned char smem[];
    const int rank = blockIdx.x, ranks = gridDim.x, b = blockIdx.y;
    const int row0 = rank * rows_per_block, nrows = min(HW - row0, rows_per_block);
    // L threads cover a row; a thread takes J vectors of it (WIDE: more
    // vectors a row than the block has threads, L the whole block).
    const int L = WIDE ? (int)blockDim.x : C / V, RS = blockDim.x / L, rs = threadIdx.x / L;
    const int J = WIDE ? (C / V + L - 1) / L : 1;
    const int c00 = (threadIdx.x % L) * V;  // the first; the j-th at c00 + j * L * V
    const int cg = C / G;
    const size_t data = ring_bytes(0, rows_per_block, tile_rows, C, V, sizeof(T));
    float* red = reinterpret_cast<float*>(smem + data);  // RS x C: per row slot and channel
    float* chan = red + RS * C;  // C: per channel
    float* part = chan + C;      // 2G: this block's (mean, M2) per group
    float* stat = part + 2 * G;  // 2G: the batch element's (mean, rstd) per group
    float* recv = stat + 2 * G;  // ranks x 2G: every block's (mean, M2)
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        smem + barrier_offset(data, smem_floats(0, ranks, RS, C, G)));
    PHASE(0);
    const int ntiles = (nrows + tile_rows - 1) / tile_rows;
    const Rows<T, kStaged> rows{{x + ((size_t)b * HW + row0) * C, nullptr},
                                {reinterpret_cast<T*>(smem), nullptr},
                                1, C, nrows, tile_rows, ntiles, (STATS ? 2 : 3) * J, bars};
    rows.start();
    PHASE(1);
    float scale[V], shift[V];  // gamma and beta of the thread's channels, for now
    const auto affine = [&](int c0) {
        if (WIDE && c0 >= C) return;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            scale[k] = to_float<T>(gamma[c0 + k]);
            shift[k] = to_float<T>(beta[c0 + k]);
        }
    };
    if (!STATS && !WIDE) affine(c00);  // loaded while the rows arrive

    float acc[V];
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
        const int c0 = c00 + j * L * V;
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = 0.f;
        rows.pass_over(j, rs, RS, [&](int, const T* xr, const T*) {
            if (WIDE && c0 >= C) return;
            float v[V];
            load_floats<T, V>(xr + c0, v);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += v[k];
        });
        deposit<V>(acc, red, rs, c0, L, C);
    }
    PHASE(2);
    group_sums(red, chan, part, RS, L, C, G, (float)(nrows * cg));
    PHASE(3);

    float mu[V];
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
        const int c0 = c00 + j * L * V;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            mu[k] = !WIDE || c0 < C ? part[2 * ((c0 + k) / cg)] : 0.f;
            acc[k] = 0.f;
        }
        rows.pass_over(J + j, rs, RS, [&](int, const T* xr, const T*) {
            if (WIDE && c0 >= C) return;
            float v[V];
            load_floats<T, V>(xr + c0, v);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const float d = v[k] - mu[k];
                acc[k] += d * d;
            }
        });
        deposit<V>(acc, red, rs, c0, L, C);
    }
    group_sums(red, chan, part + 1, RS, L, C, G, 1.f);
    PHASE(4);
    if (STATS && ranks == 1) {  // the block's statistics are the sample's
        for (int g = threadIdx.x; g < G; g += blockDim.x) {
            mean_out[2 * ((size_t)b * G + g)] = part[2 * g];
            mean_out[2 * ((size_t)b * G + g) + 1] = part[2 * g + 1];
        }
        PHASE(5);
        PHASE(6);
        return;
    }

    // Every block's (mean, M2) is written: copy those of every block here,
    // for every group (STATS: this block's slice of them), then combine them
    // in rank order.
    cluster_arrive();
    cluster_wait();
    cgrp::cluster_group cluster = cgrp::this_cluster();
    const int per_g = STATS ? (G + ranks - 1) / ranks : G;
    const int g0 = min(G, rank * (STATS ? per_g : 0)), ng = min(G, g0 + per_g) - g0;
    for (int t = threadIdx.x; t < ng * ranks; t += blockDim.x) {
        const int g = g0 + t % ng, from = t / ng;
        const float* p = cluster.map_shared_rank(part, from) + 2 * g;
        recv[2 * (from * G + g)] = p[0];
        recv[2 * (from * G + g) + 1] = p[1];
    }
    cluster_arrive();  // this block reads no other block's shared memory from here on
    __syncthreads();
    PHASE(5);
    const float n_all = (float)HW * (float)cg;
    for (int g = g0 + threadIdx.x; g < g0 + ng; g += blockDim.x) {
        float pm[kMaxCluster], pq[kMaxCluster], pn[kMaxCluster];
#pragma unroll
        for (int i = 0; i < kMaxCluster; ++i) {
            if (i < ranks) {
                pm[i] = recv[2 * (i * G + g)];
                pq[i] = recv[2 * (i * G + g) + 1];
                pn[i] = (float)(min(HW - i * rows_per_block, rows_per_block) * cg);
            }
        }
        float mean = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxCluster; ++i)
            if (i < ranks) mean += pn[i] * pm[i];
        mean /= n_all;
        float m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxCluster; ++i) {
            if (i < ranks) {
                const float d = pm[i] - mean;
                m2 += pq[i] + pn[i] * d * d;
            }
        }
        if (STATS) {
            mean_out[2 * ((size_t)b * G + g)] = mean;
            mean_out[2 * ((size_t)b * G + g) + 1] = m2;
            continue;
        }
        const float rstd = rsqrtf(m2 / n_all + eps);
        stat[2 * g] = mean;
        stat[2 * g + 1] = rstd;
        if (rank == 0) {
            mean_out[(size_t)b * G + g] = mean;
            rstd_out[(size_t)b * G + g] = rstd;
        }
    }
    if (STATS) {
        PHASE(6);
        cluster_wait();  // the others have read this block's shared memory
        return;
    }
    __syncthreads();
    PHASE(6);

    T* yb = y + ((size_t)b * HW + row0) * C;
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
        const int c0 = c00 + j * L * V;
        if (WIDE) affine(c0);
        if (!WIDE || c0 < C) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const int g = (c0 + k) / cg;
                mu[k] = stat[2 * g];
                scale[k] *= stat[2 * g + 1];
            }
        }
        rows.pass_over(2 * J + j, rs, RS, [&](int r, const T* xr, const T*) {
            if (WIDE && c0 >= C) return;
            float v[V];
            load_floats<T, V>(xr + c0, v);
            Vec<T, V> o;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                float z = (v[k] - mu[k]) * scale[k] + shift[k];
                if (act_silu) z *= sigmoid(z);
                o.v[k] = from_float<T>(z);
            }
            *reinterpret_cast<Vec<T, V>*>(yb + (size_t)r * C + c0) = o;
        });
    }
    PHASE(7);
    cluster_wait();  // the others have read this block's shared memory
}

template <typename T, int V, bool WIDE>
__global__ void __launch_bounds__(max_threads(0, V), 1)
    gn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int HW, int C, int G, int rows_per_block,
                      int tile_rows, float eps, int act_silu) {
    gn_fwd<T, V, WIDE, false>(x, gamma, beta, y, mean_out, rstd_out, HW, C, G, rows_per_block,
                              tile_rows, eps, act_silu);
}

// gn_stats (K4a, the split GroupNorm below): stats (B, G, 2).
template <typename T, int V, bool WIDE>
__global__ void __launch_bounds__(max_threads(0, V), 1)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int HW, int C, int G,
                    int rows_per_block, int tile_rows) {
    gn_fwd<T, V, WIDE, true>(x, nullptr, nullptr, nullptr, stats, nullptr, HW, C, G,
                             rows_per_block, tile_rows, 0.f, 0);
}

// d(loss)/dz from d(loss)/dy, where y = silu(z) or y = z.
__device__ __forceinline__ float dz_of(float dy, float xhat, float gamma, float beta,
                                       int act_silu) {
    if (!act_silu) return dy;
    const float z = xhat * gamma + beta;
    const float s = sigmoid(z);
    return dy * (s * (1.f + z * (1.f - s)));
}

// The backward (K5), or with SUMS its first pass alone (gn_bwd_sums, K5a:
// the cluster's sums reduce-scattered, each block adding a slice of the
// channels and writing it to dgamma_b and dbeta_b; dx is not written).
template <typename T, int V, bool WIDE, bool SUMS>
__device__ __forceinline__ void gn_bwd(const T* __restrict__ x, const T* __restrict__ gamma,
                                       const T* __restrict__ beta, const float* __restrict__ mean,
                                       const float* __restrict__ rstd, const T* __restrict__ dy,
                                       T* __restrict__ dx, float* __restrict__ dgamma_b,
                                       float* __restrict__ dbeta_b, int HW, int C, int G,
                                       int rows_per_block, int tile_rows, int act_silu) {
    constexpr bool kStaged = V * sizeof(T) == 16;
    extern __shared__ __align__(16) unsigned char smem[];
    const int rank = blockIdx.x, ranks = gridDim.x, b = blockIdx.y;
    const int row0 = rank * rows_per_block, nrows = min(HW - row0, rows_per_block);
    // L threads cover a row; a thread takes J vectors of it (WIDE: more
    // vectors a row than the block has threads, L the whole block).
    const int L = WIDE ? (int)blockDim.x : C / V, RS = blockDim.x / L, rs = threadIdx.x / L;
    const int J = WIDE ? (C / V + L - 1) / L : 1;
    const int c00 = (threadIdx.x % L) * V;  // the first; the j-th at c00 + j * L * V
    const int cg = C / G;
    const size_t slab = ring_bytes(0, rows_per_block, tile_rows, C, V, sizeof(T));
    float* red = reinterpret_cast<float*>(smem + 2 * slab);  // 2 x RS x C: dbeta, dgamma
    float* part = red + 2 * RS * C;  // 2C: this block's sums per channel, read by the cluster
    float* tot = part + 2 * C;       // 2C: the batch element's, times gamma
    float* tt = tot + 2 * C;         // 2G: t1, t2 per group
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        smem + barrier_offset(2 * slab, smem_floats(1, ranks, RS, C, G)));
    PHASE(0);
    const size_t base = ((size_t)b * HW + row0) * C;
    const int ntiles = (nrows + tile_rows - 1) / tile_rows;
    const Rows<T, kStaged> rows{{x + base, dy + base},
                                {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + slab)},
                                2, C, nrows, tile_rows, ntiles, (SUMS ? 1 : 2) * J, bars};
    rows.start();
    PHASE(1);

    if (!SUMS)
        for (int c = threadIdx.x; c < C; c += blockDim.x)
            tot[c] = to_float<T>(gamma[c]);  // until the cluster's sums replace it
    // The constants of the thread's channels c0 ... c0 + V - 1 (none where
    // c0 >= C): mean, rstd, gamma, beta.
    float mu[V], rsd[V], ga[V], be[V], db[V], dg[V];
    const auto constants = [&](int c0) {
        if (WIDE && c0 >= C) return;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int c = c0 + k, g = c / cg;
            mu[k] = mean[(size_t)b * G + g];
            rsd[k] = rstd[(size_t)b * G + g];
            ga[k] = to_float<T>(gamma[c]);
            be[k] = to_float<T>(beta[c]);
        }
    };
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
        const int c0 = c00 + j * L * V;
        constants(c0);
#pragma unroll
        for (int k = 0; k < V; ++k) db[k] = dg[k] = 0.f;
        rows.pass_over(j, rs, RS, [&](int, const T* xr, const T* dr) {
            if (WIDE && c0 >= C) return;
            float xv[V], dv[V];
            load_floats<T, V>(xr + c0, xv);
            load_floats<T, V>(dr + c0, dv);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const float xhat = (xv[k] - mu[k]) * rsd[k];
                const float dz = dz_of(dv[k], xhat, ga[k], be[k], act_silu);
                db[k] += dz;
                dg[k] += dz * xhat;
            }
        });
        if (!WIDE || c0 < C) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                red[rs * C + c0 + k] = db[k];
                red[(RS + rs) * C + c0 + k] = dg[k];
            }
        }
    }
    PHASE(2);
    __syncthreads();
    // S threads a channel add row slots s, s + S, ... and leave the sum in
    // row slot s, which no other thread reads; then one thread a channel
    // adds the S sums.
    const int S = max(1, min(RS, (int)blockDim.x / C));
    for (int t = threadIdx.x; t < S * C; t += blockDim.x) {
        const int c = t % C, s = t / C;
        float sb = 0.f, sg = 0.f;
        for (int i = s; i < RS; i += S) {
            sb += red[i * C + c];
            sg += red[(RS + i) * C + c];
        }
        red[s * C + c] = sb;
        red[(RS + s) * C + c] = sg;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float sb = 0.f, sg = 0.f;
        for (int s = 0; s < S; ++s) {
            sb += red[s * C + c];
            sg += red[(RS + s) * C + c];
        }
        if (SUMS && ranks == 1) {  // the block's sums are the sample's
            dbeta_b[(size_t)b * C + c] = sb;
            dgamma_b[(size_t)b * C + c] = sg;
        }
        part[c] = sb;
        part[C + c] = sg;
    }
    if (SUMS && ranks == 1) {
        PHASE(3);
        PHASE(4);
        PHASE(5);
        return;
    }
    PHASE(3);

    // Every block's sums are written: add them, S slices of the ranks (i,
    // i + S, ...) side by side, then the slices in order.
    cluster_arrive();
    cluster_wait();
    PHASE(4);
    cgrp::cluster_group cluster = cgrp::this_cluster();
    if (SUMS) {  // a reduce-scatter: this block adds its slice of the channels
        const int per = (C + ranks - 1) / ranks;
        const int cs = min(C, rank * per), ce = min(C, cs + per);
        for (int c = cs + threadIdx.x; c < ce; c += blockDim.x) {
            float sb = 0.f, sg = 0.f;
#pragma unroll 4
            for (int i = 0; i < ranks; ++i) {
                const float* p = cluster.map_shared_rank(part, i);
                sb += p[c];
                sg += p[C + c];
            }
            dbeta_b[(size_t)b * C + c] = sb;
            dgamma_b[(size_t)b * C + c] = sg;
        }
        PHASE(5);
        cluster_arrive();
        cluster_wait();  // the others have read this block's shared memory
        return;
    }
    for (int t = threadIdx.x; t < S * C; t += blockDim.x) {
        const int c = t % C, slice = t / C;
        float sb = 0.f, sg = 0.f;
#pragma unroll 4
        for (int i = slice; i < ranks; i += S) {
            const float* p = cluster.map_shared_rank(part, i);
            sb += p[c];
            sg += p[C + c];
        }
        red[2 * slice * C + c] = sb;  // free since the barrier
        red[(2 * slice + 1) * C + c] = sg;
    }
    cluster_arrive();  // this block reads no other block's shared memory from here on
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float sb = 0.f, sg = 0.f;
        for (int slice = 0; slice < S; ++slice) {
            sb += red[2 * slice * C + c];
            sg += red[(2 * slice + 1) * C + c];
        }
        const float gc = tot[c];
        tot[c] = sb * gc;
        tot[C + c] = sg * gc;
        if (rank == 0) {
            dbeta_b[(size_t)b * C + c] = sb;
            dgamma_b[(size_t)b * C + c] = sg;
        }
    }
    __syncthreads();
    const float inv_n = 1.f / ((float)HW * (float)cg);
    const int P = fold_lanes(G);
    for (int t = threadIdx.x; t < G * P; t += blockDim.x) {
        const int g = t / P, p = t % P;
        float t1 = 0.f, t2 = 0.f;
        for (int c = g * cg + p; c < (g + 1) * cg; c += P) {
            t1 += tot[c];
            t2 += tot[C + c];
        }
        t1 = lanes_sum(t1, P, t, G * P);
        t2 = lanes_sum(t2, P, t, G * P);
        if (p == 0) {
            tt[2 * g] = t1 * inv_n;
            tt[2 * g + 1] = t2 * inv_n;
        }
    }
    __syncthreads();
    PHASE(5);

    T* dxb = dx + base;
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
        const int c0 = c00 + j * L * V;
        if (WIDE) constants(c0);  // with one vector a thread, still those of pass 1
        if (!WIDE || c0 < C) {
#pragma unroll
            for (int k = 0; k < V; ++k) {  // t1, t2 of each channel, in db, dg
                const int g = (c0 + k) / cg;
                db[k] = tt[2 * g];
                dg[k] = tt[2 * g + 1];
            }
        }
        rows.pass_over(J + j, rs, RS, [&](int r, const T* xr, const T* dr) {
            if (WIDE && c0 >= C) return;
            float xv[V], dv[V];
            load_floats<T, V>(xr + c0, xv);
            load_floats<T, V>(dr + c0, dv);
            Vec<T, V> o;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const float xhat = (xv[k] - mu[k]) * rsd[k];
                const float dz = dz_of(dv[k], xhat, ga[k], be[k], act_silu);
                o.v[k] = from_float<T>(rsd[k] * (dz * ga[k] - db[k] - xhat * dg[k]));
            }
            *reinterpret_cast<Vec<T, V>*>(dxb + (size_t)r * C + c0) = o;
        });
    }
    PHASE(6);
    cluster_wait();  // the others have read this block's shared memory
}

template <typename T, int V, bool WIDE>
__global__ void __launch_bounds__(max_threads(1, V), 1)
    gn_act_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ dgamma_b,
                      float* __restrict__ dbeta_b, int HW, int C, int G, int rows_per_block,
                      int tile_rows, int act_silu) {
    gn_bwd<T, V, WIDE, false>(x, gamma, beta, mean, rstd, dy, dx, dgamma_b, dbeta_b, HW, C, G,
                              rows_per_block, tile_rows, act_silu);
}

// gn_bwd_sums (K5a, the split GroupNorm below): sums (2, B, C), [dgamma_b;
// dbeta_b].
template <typename T, int V, bool WIDE>
__global__ void __launch_bounds__(max_threads(1, V), 1)
    gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const T* __restrict__ dy,
                       float* __restrict__ sums, int HW, int C, int G, int rows_per_block,
                       int tile_rows, int act_silu) {
    gn_bwd<T, V, WIDE, true>(x, gamma, beta, mean, rstd, dy, nullptr, sums,
                             sums + (size_t)gridDim.y * C, HW, C, G, rows_per_block, tile_rows,
                             act_silu);
}

// Widest vector of V elements (at most 16 bytes) that divides C.
inline int vec_width(int C, int is_bf16) {
    const int max_vec = is_bf16 ? 8 : 4;
    int vec = 1;
    while (vec * 2 <= max_vec && C % (vec * 2) == 0) vec *= 2;
    return vec;
}

// Whether `cluster` blocks of `rows_per_block` rows do not cover HW rows
// exactly, with none empty; or the cluster is no power of two <= 16.
inline bool bad_geometry(int HW, int cluster, int rows_per_block) {
    return cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
           rows_per_block <= 0 || (size_t)(cluster - 1) * rows_per_block >= (size_t)HW ||
           (size_t)cluster * rows_per_block < (size_t)HW;
}

// The per-device, per-kernel attributes set so far, and the configurations
// found schedulable.
std::mutex g_mutex;
std::set<std::tuple<int, const void*>> g_prepared;
std::set<std::tuple<int, const void*, int, size_t, int>> g_schedulable;

// Before a kernel's first launch on a device: allow clusters of 16 (beyond
// the portable 8) and dynamic shared memory beyond 48 KB.  Before a
// configuration's first launch: whether one of its clusters fits on the
// card at all (cudaOccupancyMaxActiveClusters), else cudaErrorInvalidClusterSize.
template <typename... Params>
cudaError_t prepare(void (*kernel)(Params...), const cudaLaunchConfig_t& cfg, int cluster) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const void* fn = reinterpret_cast<const void*>(kernel);
    std::lock_guard<std::mutex> lock(g_mutex);
    if (!g_prepared.count({device, fn})) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSmem);
        if (err != cudaSuccess) return err;
        g_prepared.insert({device, fn});
    }
    const auto key = std::make_tuple(device, fn, cluster, cfg.dynamicSmemBytes, (int)cfg.blockDim.x);
    if (!g_schedulable.count(key)) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return err;
        if (clusters == 0) return cudaErrorInvalidClusterSize;
        g_schedulable.insert(key);
    }
    return cudaSuccess;
}

// One launch of `kernel` on grid (cluster, B) in clusters of (cluster, 1, 1).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, int B, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
    if (kernel == nullptr) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = prepare(kernel, cfg, cluster);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();  // clears what a failed call left
    return err != cudaSuccess ? err : last;
}

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, float*, float*, int, int, int, int,
                           int, float, int);
template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const float*, const float*, const T*,
                           T*, float*, float*, int, int, int, int, int, int);

// The instantiation for vector width `vec` (16 bytes: rows staged) and
// rows with more vectors than the block has threads (`wide`) or not.
template <typename T, bool WIDE>
FwdKernel<T> fwd_kernel(int vec) {
    switch (vec) {
        case 1: return gn_act_fwd_kernel<T, 1, WIDE>;
        case 2: return gn_act_fwd_kernel<T, 2, WIDE>;
        case 4: return gn_act_fwd_kernel<T, 4, WIDE>;
    }
    if constexpr (sizeof(T) == 2) {
        if (vec == 8) return gn_act_fwd_kernel<T, 8, WIDE>;
    }
    return nullptr;
}

template <typename T>
FwdKernel<T> fwd_kernel(int vec, bool wide) {
    return wide ? fwd_kernel<T, true>(vec) : fwd_kernel<T, false>(vec);
}

template <typename T, bool WIDE>
BwdKernel<T> bwd_kernel(int vec) {
    switch (vec) {
        case 1: return gn_act_bwd_kernel<T, 1, WIDE>;
        case 2: return gn_act_bwd_kernel<T, 2, WIDE>;
        case 4: return gn_act_bwd_kernel<T, 4, WIDE>;
    }
    if constexpr (sizeof(T) == 2) {
        if (vec == 8) return gn_act_bwd_kernel<T, 8, WIDE>;
    }
    return nullptr;
}

template <typename T>
BwdKernel<T> bwd_kernel(int vec, bool wide) {
    return wide ? bwd_kernel<T, true>(vec) : bwd_kernel<T, false>(vec);
}

// What both launchers require: the shape, the cut of the rows into the
// cluster's blocks, tiles of at most the block's rows, and shared memory
// within what a block may have.  Returns the bytes of dynamic shared
// memory of one block, or 0 for a call the kernels do not take.
inline size_t call_smem(int backward, int B, int HW, int C, int G, int is_bf16, int cluster,
                        int rows_per_block, int tile_rows) {
    if (B <= 0 || B > 65535 || HW <= 0 || G <= 0 || C <= 0 || C % G != 0 ||
        bad_geometry(HW, cluster, rows_per_block) || tile_rows <= 0 ||
        tile_rows > rows_per_block)
        return 0;
    const int item = is_bf16 ? 2 : 4;
    const size_t smem = smem_bytes(backward, cluster, rows_per_block, tile_rows, C, G,
                                   vec_width(C, is_bf16), item);
    return smem <= (size_t)kMaxSmem ? smem : 0;
}

}  // namespace

// x, y: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of x's
// type; mean, rstd: (B, G) float32.  One cluster of `cluster` blocks per
// batch element, the rows cut into blocks of `rows_per_block` (the last may
// be shorter, none is empty); where C * itemsize is a multiple of 16 the
// blocks' rows pass through a ring of shared memory in tiles of `tile_rows`
// (ops/kernels/groupnorm.py::geometry chooses all three).  Returns the CUDA
// error code of the launch (0 = success; cudaErrorInvalidClusterSize when
// no such cluster fits on the card).
extern "C" int unet_gn_act_fwd(const void* x, const void* gamma, const void* beta, void* y,
                               float* mean, float* rstd, int B, int HW, int C, int G, float eps,
                               int act_silu, int is_bf16, int cluster, int rows_per_block,
                               int tile_rows, cudaStream_t stream) {
    const size_t smem = call_smem(0, B, HW, C, G, is_bf16, cluster, rows_per_block, tile_rows);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C, is_bf16), threads = block_threads(0, C, vec);
    const bool wide = C / vec > threads;
    cudaError_t err;
    if (is_bf16) {
        using T = __nv_bfloat16;
        err = launch_cluster(fwd_kernel<T>(vec, wide), cluster, B, threads, smem, stream,
                             static_cast<const T*>(x), static_cast<const T*>(gamma),
                             static_cast<const T*>(beta), static_cast<T*>(y), mean, rstd, HW, C,
                             G, rows_per_block, tile_rows, eps, act_silu);
    } else {
        using T = float;
        err = launch_cluster(fwd_kernel<T>(vec, wide), cluster, B, threads, smem, stream,
                             static_cast<const T*>(x), static_cast<const T*>(gamma),
                             static_cast<const T*>(beta), static_cast<T*>(y), mean, rstd, HW, C,
                             G, rows_per_block, tile_rows, eps, act_silu);
    }
    return (int)err;
}

// x, dy, dx: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of
// x's type; mean, rstd: (B, G) float32 from the forward; dgamma_b, dbeta_b:
// (B, C) float32 outputs.  The geometry as for the forward (the ring holds
// tiles of both x and dy).  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int unet_gn_act_bwd(const void* x, const void* gamma, const void* beta,
                               const float* mean, const float* rstd, const void* dy, void* dx,
                               float* dgamma_b, float* dbeta_b, int B, int HW, int C, int G,
                               int act_silu, int is_bf16, int cluster, int rows_per_block,
                               int tile_rows, cudaStream_t stream) {
    const size_t smem = call_smem(1, B, HW, C, G, is_bf16, cluster, rows_per_block, tile_rows);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C, is_bf16), threads = block_threads(1, C, vec);
    const bool wide = C / vec > threads;
    cudaError_t err;
    if (is_bf16) {
        using T = __nv_bfloat16;
        err = launch_cluster(bwd_kernel<T>(vec, wide), cluster, B, threads, smem, stream,
                             static_cast<const T*>(x), static_cast<const T*>(gamma),
                             static_cast<const T*>(beta), mean, rstd, static_cast<const T*>(dy),
                             static_cast<T*>(dx), dgamma_b, dbeta_b, HW, C, G, rows_per_block,
                             tile_rows, act_silu);
    } else {
        using T = float;
        err = launch_cluster(bwd_kernel<T>(vec, wide), cluster, B, threads, smem, stream,
                             static_cast<const T*>(x), static_cast<const T*>(gamma),
                             static_cast<const T*>(beta), mean, rstd, static_cast<const T*>(dy),
                             static_cast<T*>(dx), dgamma_b, dbeta_b, HW, C, G, rows_per_block,
                             tile_rows, act_silu);
    }
    return (int)err;
}

// ---------------------------------------------------------------------------
// The split GroupNorm (spatial sharding: parallel/spatial.py).  The rows of
// every sample are split over N model ranks, so the statistics and the
// backward's sums that K4 and K5 take inside one launch come from every
// rank.  Four kernels around two all-gathers over the ranks, which the
// caller makes (ops/kernels/groupnorm.py::SplitGroupNormAct):
//
//   gn_stats (K4a): per (b, g), the (mean, M2) of this rank's rows, two
//     passes over them in float32: (B, G, 2).
//   gn_apply (K4b): merges the N ranks' (mean, M2) (N, B, G, 2) in rank
//     order by the pairwise formula mean += d n_b / n, M2 += M2_b + d^2 n_a
//     n_b / n (Chan, Golub and LeVeque), every rank the same bits; writes
//     mean and rstd (B, G) and y = (x - mean) rstd gamma + beta, SiLU'd.
//   gn_bwd_sums (K5a): per (b, c), this rank's dgamma_b = sum dz xhat and
//     dbeta_b = sum dz, xhat from the merged statistics: (2, B, C).
//   gn_bwd_dx (K5b): adds the N ranks' sums (N, 2, B, C) in rank order,
//     forms t1 and t2 per group over the whole sample's count and writes
//     dx as K5 does.
//
// They replace no TPU kernel of their own: they are K4 and K5 (the Pallas
// `_fwd_kernel` and `_bwd_kernel` of unet_tpu/ops/pallas/groupnorm.py) cut
// around the collective that GSPMD places in the JAX package's spatial
// step.  Bound: memory traffic, as K4 and K5 (gn_stats reads x, gn_apply
// reads x and writes y, gn_bwd_sums reads x and dy, gn_bwd_dx reads x and
// dy and writes dx).  gn_stats and gn_bwd_sums are K4's and K5's cluster
// kernels stopped early (`gn_fwd` with STATS, `gn_bwd` with SUMS): one
// cluster per batch element, cut as the wrapper's `split_geometry` says
// (at B=32 and the model's largest rank input, 128 and 256 blocks on the
// card's 132 SMs).  gn_stats stages each block's rows in shared memory
// once (streams them where they do not fit), takes each block's two-pass
// (mean, M2) per group from them, and merges the blocks' in rank order
// through the cluster's shared memory as K4 does, each block a slice of
// the groups.  gn_bwd_sums reads its block's rows of x and dy once (one
// bulk copy each, or streamed through the ring where they are large),
// forms the column sums of dz xhat and dz, and reduce-scatters the
// cluster's 2C partials: block j adds channel slice j of every block's, in
// rank order.  In a cluster of one block neither exchanges anything.
// gn_apply streams the rows: block (chunk, col, b) takes a contiguous run
// of rows of sample b (the wrapper's `apply_geometry` sizes the runs so
// that the grid is about one wave on the card), and each of its threads
// one fixed vector of channels in every slots-th row of the run, so the
// thread works out the mean, gamma * rstd and beta of its channels once,
// into registers: it merges the ranks' statistics of its channels' groups
// itself, in rank order, after its first kApplyUnroll loads of x are on
// their way.  Each element then costs a subtract, an FMA and the SiLU.
// gn_bwd_dx is elementwise over a grid of (chunks, B), each block working
// out its sample's per-group constants at its start in a fixed order.  No
// atomics, so a rerun gives the same bits.

namespace {

constexpr int kElemThreads = 256;   // gn_bwd_dx
constexpr int kElemBlocks = 8 * 132;  // about 8 blocks an SM in all
constexpr int kApplyThreads = 256;  // gn_apply: at most this many threads a block
constexpr int kApplyUnroll = 4;     // loads of x a thread has in flight
constexpr size_t kSplitSmem = 48 * 1024;

// f(T*, integral_constant<V>) for the storage type and the vector width:
// two channels a thread at least (an odd C is refused: the kernels at one
// value a thread spilled registers, and no GroupNorm of the model has one).
template <typename F>
cudaError_t with_type_vec(int is_bf16, int vec, F f) {
    using B16 = __nv_bfloat16;
    if (is_bf16) {
        switch (vec) {
            case 2: return f((B16*)nullptr, std::integral_constant<int, 2>{});
            case 4: return f((B16*)nullptr, std::integral_constant<int, 4>{});
            case 8: return f((B16*)nullptr, std::integral_constant<int, 8>{});
        }
    } else {
        switch (vec) {
            case 2: return f((float*)nullptr, std::integral_constant<int, 2>{});
            case 4: return f((float*)nullptr, std::integral_constant<int, 4>{});
        }
    }
    return cudaErrorInvalidValue;
}

// Where gn_apply's threads sit: a row's C / vec vectors are cut into `cols`
// column blocks of `lanes` vectors (the last may have fewer), and lanes *
// slots of a block's kApplyThreads threads take `slots` rows of one column
// block at a time (ops/kernels/groupnorm.py::apply_geometry mirrors it).
struct ApplyLayout {
    int cols, lanes, slots;
};

inline ApplyLayout apply_layout(int C, int vec) {
    const int L = C / vec;
    const int cols = (L + kApplyThreads - 1) / kApplyThreads;
    const int lanes = (L + cols - 1) / cols;
    const int slots = kApplyThreads / lanes;
    return {cols, lanes, slots};
}

// gn_apply holds a vector of V elements of T as its 32-bit words (a vector
// struct assigned under a condition went to local memory).  x's words are
// read once: past L1 (`ld.global.nc.L1::no_allocate`).
template <typename T, int V> constexpr int kWords = (int)sizeof(T) * V / 4;

template <int N>
__device__ __forceinline__ void load_words_once(const void* p, uint32_t (&w)[N]) {
    if constexpr (N == 4) {
        asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
            : "l"(p));
    } else if constexpr (N == 2) {
        asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
            : "=r"(w[0]), "=r"(w[1])
            : "l"(p));
    } else {
        asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(w[0]) : "l"(p));
    }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[N]) {
    if constexpr (N == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (N == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
        *reinterpret_cast<uint32_t*>(p) = w[0];
    }
}

// The V elements of T held in w, as floats (a bfloat16 is the high half
// of its float); and V floats rounded to T (to nearest), as words.
template <typename T, int V>
__device__ __forceinline__ float word_element(const uint32_t (&w)[kWords<T, V>], int k) {
    if constexpr (std::is_same<T, float>::value) {
        return __uint_as_float(w[k]);
    } else {
        return __uint_as_float(k & 1 ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
    }
}

// A float or a bfloat16 from its bits.
__device__ __forceinline__ float bits_to_float(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float bits_to_float(unsigned short b) {
    return __uint_as_float((uint32_t)b << 16);
}

template <typename T, int V>
__device__ __forceinline__ void to_words(const float (&z)[V], uint32_t (&w)[kWords<T, V>]) {
#pragma unroll
    for (int j = 0; j < kWords<T, V>; ++j) {
        if constexpr (std::is_same<T, float>::value) {
            w[j] = __float_as_uint(z[j]);
        } else {
            w[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(z[2 * j])) |
                   (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(z[2 * j + 1])) << 16;
        }
    }
}

// Block (chunk, col, b) of kApplyThreads threads: rows [chunk *
// rows_per_block, ...) of sample b, vectors [col * lanes, ...) of each row.
// Thread tid < lanes * slots takes vector col * lanes + tid % lanes of rows
// first + tid / lanes, + slots, + 2 slots, ...; the others only help merge.
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads, 1)  // ptxas spilled at V = 2 without the 1
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, const float* __restrict__ stats,
                    T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int N, int HW, int C, int G, int lanes, int rows_per_block, float eps,
                    int act_silu) {
    const int b = blockIdx.z, B = gridDim.z, cg = C / G, lane = threadIdx.x & 31;
    const int slots = kApplyThreads / lanes;
    const int c0 = (blockIdx.y * lanes + threadIdx.x % lanes) * V;
    const int first = blockIdx.x * rows_per_block;
    const int end = min(HW, first + rows_per_block);
    int r = first + threadIdx.x / lanes;
    const bool busy = threadIdx.x < lanes * slots && c0 < C && r < end;
    const T* xb = x + (size_t)b * HW * C + c0;
    T* yb = y + (size_t)b * HW * C + c0;

    // The first loads of x, gamma and beta go out before anything else
    // (gamma and beta as raw bits, at a channel inside the row for the
    // threads past it).
    constexpr int NW = kWords<T, V>;
    uint32_t v[kApplyUnroll][NW];
    if (busy) {
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u)
            if (r + u * slots < end) load_words_once(xb + (size_t)(r + u * slots) * C, v[u]);
    }
    using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, unsigned short>;
    const int cc = min(c0, C - V);
    Bits gamma_bits[V], beta_bits[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        gamma_bits[k] = reinterpret_cast<const Bits*>(gamma)[cc + k];
        beta_bits[k] = reinterpret_cast<const Bits*>(beta)[cc + k];
    }

    // Then the statistics: lane i of every warp merges the ranks' (mean,
    // M2) of groups i, i + 32, ... in rank order (the same formula and
    // order in every warp and on every rank, so the same bits), and each
    // thread takes its channels' mean and rstd from those lanes by
    // shuffles.  Warp 0 of the sample's first block writes them.
    const float n = (float)HW * (float)cg;  // each rank's count
    float mu[V], rs[V];
    for (int q = 0; q < G; q += 32) {
        const int g = q + lane;
        float mean = 0.f, rstd = 0.f;
        if (g < G) {
            const float* s = stats + ((size_t)b * G + g) * 2;
            float m2 = s[1];
            mean = s[0];
            for (int i = 1; i < N; ++i) {
                s = stats + (((size_t)i * B + b) * G + g) * 2;
                const float na = n * (float)i, tot = na + n;
                const float d = s[0] - mean;
                mean = mean + d * (n / tot);
                m2 = m2 + s[1] + d * d * (na * n / tot);
            }
            rstd = rsqrtf(m2 / (n * (float)N) + eps);
            if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 32) {
                mean_out[(size_t)b * G + g] = mean;
                rstd_out[(size_t)b * G + g] = rstd;
            }
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int gk = (c0 + k) / cg - q;
            const float m = __shfl_sync(0xffffffffu, mean, gk & 31);
            const float rr = __shfl_sync(0xffffffffu, rstd, gk & 31);
            if (gk >= 0 && gk < 32) {
                mu[k] = m;
                rs[k] = rr;
            }
        }
    }
    if (!busy) return;
    float scale[V], shift[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        scale[k] = bits_to_float(gamma_bits[k]) * rs[k];
        shift[k] = bits_to_float(beta_bits[k]);
    }

    // Then the rows, kApplyUnroll of them at a time, the next ones' loads
    // issued before this batch is written.
    for (;;) {
        uint32_t o[kApplyUnroll][NW];
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u) {
            float z[V];
#pragma unroll
            for (int k = 0; k < V; ++k) {
                z[k] = (word_element<T, V>(v[u], k) - mu[k]) * scale[k] + shift[k];
                if (act_silu) z[k] *= sigmoid(z[k]);
            }
            to_words<T, V>(z, o[u]);
        }
        const int next = r + kApplyUnroll * slots;
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u)
            if (next + u * slots < end)
                load_words_once(xb + (size_t)(next + u * slots) * C, v[u]);
#pragma unroll
        for (int u = 0; u < kApplyUnroll; ++u)
            if (r + u * slots < end) store_words(yb + (size_t)(r + u * slots) * C, o[u]);
        r = next;
        if (r >= end) break;
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(kElemThreads)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, const float* __restrict__ mean,
                     const float* __restrict__ rstd, const T* __restrict__ dy,
                     const float* __restrict__ sums, T* __restrict__ dx, int N, int HW, int C,
                     int G, int act_silu) {
    extern __shared__ __align__(16) float fsm[];
    float* tot = fsm;         // 2C: dbeta * gamma, dgamma * gamma of the whole sample
    float* tt = tot + 2 * C;  // 2G: t1, t2
    float* ms = tt + 2 * G;   // 2G: mean, rstd
    const int b = blockIdx.y, B = gridDim.y, cg = C / G;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float sg = 0.f, sb = 0.f;
        for (int i = 0; i < N; ++i) {
            sg += sums[((size_t)(2 * i) * B + b) * C + c];
            sb += sums[((size_t)(2 * i + 1) * B + b) * C + c];
        }
        const float gc = to_float<T>(gamma[c]);
        tot[c] = sb * gc;
        tot[C + c] = sg * gc;
    }
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        ms[g] = mean[(size_t)b * G + g];
        ms[G + g] = rstd[(size_t)b * G + g];
    }
    __syncthreads();
    const float inv_n = 1.f / ((float)N * (float)HW * (float)cg);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        float t1 = 0.f, t2 = 0.f;
        for (int c = g * cg; c < (g + 1) * cg; ++c) {
            t1 += tot[c];
            t2 += tot[C + c];
        }
        tt[g] = t1 * inv_n;
        tt[G + g] = t2 * inv_n;
    }
    __syncthreads();
    const int L = C / V;
    const size_t total = (size_t)HW * L, base = (size_t)b * HW * C;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        const int c0 = (int)(i % L) * V;
        const size_t at = base + (i / L) * C + c0;
        float xv[V], dv[V];
        load_floats<T, V>(x + at, xv);
        load_floats<T, V>(dy + at, dv);
        Vec<T, V> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int g = (c0 + k) / cg;
            const float ga = to_float<T>(gamma[c0 + k]), rsd = ms[G + g];
            const float xhat = (xv[k] - ms[g]) * rsd;
            const float dz = dz_of(dv[k], xhat, ga, to_float<T>(beta[c0 + k]), act_silu);
            o.v[k] = from_float<T>(rsd * (dz * ga - tt[g] - xhat * tt[G + g]));
        }
        *reinterpret_cast<Vec<T, V>*>(dx + at) = o;
    }
}

// Bytes of dynamic shared memory of a block of gn_bwd_dx
// (ops/kernels/groupnorm.py::_dx_smem counts the same), 0 for a call the
// kernel does not take.
inline size_t dx_smem(int B, int HW, int C, int G, int vec) {
    if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || vec < 2) return 0;
    const size_t bytes = 4 * (2 * (size_t)C + 4 * (size_t)G);
    return bytes <= kSplitSmem ? bytes : 0;
}

// gn_bwd_dx's blocks for each sample: enough to cover its vectors, about
// kElemBlocks in all.
inline int elem_chunks(int B, int HW, int C, int vec) {
    const size_t vectors = (size_t)HW * (C / vec);
    const size_t need = (vectors + kElemThreads - 1) / kElemThreads;
    const size_t want = (size_t)((kElemBlocks + B - 1) / B);
    return (int)(need < want ? need : want);
}

}  // namespace

// x: (B, HW, C) contiguous, 16-byte aligned, C even; stats: (B, G, 2)
// float32, the (mean, M2) of each (b, g).  The geometry as for
// unet_gn_act_fwd (ops/kernels/groupnorm.py::split_geometry chooses it).
// Returns the CUDA error code of the launch.
extern "C" int unet_gn_stats(const void* x, float* stats, int B, int HW, int C, int G,
                             int is_bf16, int cluster, int rows_per_block, int tile_rows,
                             cudaStream_t stream) {
    const size_t smem = call_smem(0, B, HW, C, G, is_bf16, cluster, rows_per_block, tile_rows);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C, is_bf16), threads = block_threads(0, C, vec);
    const bool wide = C / vec > threads;
    return (int)with_type_vec(is_bf16, vec, [&](auto t, auto v) {
        using T = std::remove_pointer_t<decltype(t)>;
        constexpr int V = decltype(v)::value;
        void (*kernel)(const T*, float*, int, int, int, int, int) = gn_stats_kernel<T, V, false>;
        if (wide) kernel = gn_stats_kernel<T, V, true>;
        return launch_cluster(kernel, cluster, B, threads, smem, stream, static_cast<const T*>(x),
                              stats, HW, C, G, rows_per_block, tile_rows);
    });
}

// x, y: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of x's
// type; stats: (N, B, G, 2) float32, every rank's gn_stats in rank order;
// mean, rstd: (B, G) float32 outputs; rows_per_block: the run of rows a
// block takes (ops/kernels/groupnorm.py::apply_geometry chooses it).
// Returns the CUDA error code.
extern "C" int unet_gn_apply(const void* x, const void* gamma, const void* beta,
                             const float* stats, void* y, float* mean, float* rstd, int N, int B,
                             int HW, int C, int G, float eps, int act_silu, int is_bf16,
                             int rows_per_block, cudaStream_t stream) {
    const int vec = vec_width(C, is_bf16);
    if (N <= 0 || B <= 0 || B > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
        vec < 2 || rows_per_block <= 0)
        return (int)cudaErrorInvalidValue;
    const ApplyLayout lay = apply_layout(C, vec);
    const int chunks = (HW + rows_per_block - 1) / rows_per_block;
    if (lay.cols > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(chunks, lay.cols, B);
    return (int)with_type_vec(is_bf16, vec, [&](auto t, auto v) {
        using T = std::remove_pointer_t<decltype(t)>;
        constexpr int V = decltype(v)::value;
        gn_apply_kernel<T, V><<<grid, kApplyThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
            stats, static_cast<T*>(y), mean, rstd, N, HW, C, G, lay.lanes, rows_per_block, eps,
            act_silu);
        return cudaGetLastError();
    });
}

// x, dy: (B, HW, C) contiguous, 16-byte aligned, C even; gamma, beta: (C,)
// of x's type; mean, rstd: (B, G) float32 from gn_apply; sums: (2, B, C)
// float32 output, this rank's [dgamma_b; dbeta_b].  The geometry as for
// unet_gn_act_bwd (ops/kernels/groupnorm.py::split_geometry chooses it).
// Returns the CUDA error code of the launch.
extern "C" int unet_gn_bwd_sums(const void* x, const void* gamma, const void* beta,
                                const float* mean, const float* rstd, const void* dy,
                                float* sums, int B, int HW, int C, int G, int act_silu,
                                int is_bf16, int cluster, int rows_per_block, int tile_rows,
                                cudaStream_t stream) {
    const size_t smem = call_smem(1, B, HW, C, G, is_bf16, cluster, rows_per_block, tile_rows);
    if (smem == 0) return (int)cudaErrorInvalidValue;
    const int vec = vec_width(C, is_bf16), threads = block_threads(1, C, vec);
    const bool wide = C / vec > threads;
    return (int)with_type_vec(is_bf16, vec, [&](auto t, auto v) {
        using T = std::remove_pointer_t<decltype(t)>;
        constexpr int V = decltype(v)::value;
        void (*kernel)(const T*, const T*, const T*, const float*, const float*, const T*, float*,
                       int, int, int, int, int, int) = gn_bwd_sums_kernel<T, V, false>;
        if (wide) kernel = gn_bwd_sums_kernel<T, V, true>;
        return launch_cluster(kernel, cluster, B, threads, smem, stream, static_cast<const T*>(x),
                              static_cast<const T*>(gamma), static_cast<const T*>(beta), mean,
                              rstd, static_cast<const T*>(dy), sums, HW, C, G, rows_per_block,
                              tile_rows, act_silu);
    });
}

// x, dy, dx: (B, HW, C) contiguous, 16-byte aligned; gamma, beta: (C,) of
// x's type; mean, rstd: (B, G) float32; sums: (N, 2, B, C) float32, every
// rank's gn_bwd_sums in rank order.  Returns the CUDA error code.
extern "C" int unet_gn_bwd_dx(const void* x, const void* gamma, const void* beta,
                              const float* mean, const float* rstd, const void* dy,
                              const float* sums, void* dx, int N, int B, int HW, int C, int G,
                              int act_silu, int is_bf16, cudaStream_t stream) {
    const int vec = vec_width(C, is_bf16);
    const size_t smem = dx_smem(B, HW, C, G, vec);
    if (smem == 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid(elem_chunks(B, HW, C, vec), B);
    return (int)with_type_vec(is_bf16, vec, [&](auto t, auto v) {
        using T = std::remove_pointer_t<decltype(t)>;
        constexpr int V = decltype(v)::value;
        gn_bwd_dx_kernel<T, V><<<grid, kElemThreads, smem, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
            mean, rstd, static_cast<const T*>(dy), sums, static_cast<T*>(dx), N, HW, C, G,
            act_silu);
        return cudaGetLastError();
    });
}

#ifdef GN_PHASE_CLOCKS
// The phase clocks of the last launch (see PHASE): kClockBlocks x
// kClockSlots int64; returns the CUDA error code of the copy.
extern "C" int unet_gn_phase_clocks(long long* out) {
    return (int)cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
}
#endif
