// Attention forward and backward for a head wider than the chunked kernels
// take (CH * MAX_CHUNKS = 256 columns): every wider head, of any size.  The
// same two TPU kernels as attention.cu (`_fwd_kernel` and `_bwd_kernel` of
// unet_tpu/ops/pallas/attention.py, :41 and :61), the same rounding points
// and the same two-kernel backward (dq and the rows' m, 1 / l and D; then dk
// and dv).
//
// Bound on an H100: as attention.cu says, device memory at the U-Net's T =
// 64 and 256 in bfloat16, the operations from T = 256 in float32 (3xTF32 at
// 165 TFLOP/s).  At DDPM 256 x 256's (64, 256, 512, 1): forward 0.0200 ms
// bf16 (bytes), 0.0521 f32 (operations); backward 0.0350 bf16 (bytes),
// 0.1302 f32 (operations).  So each score is computed once.
//
// Design.  A thread-block cluster of n blocks (at most MAX_CLUSTER, the
// portable size) shares a tile of ROWS own rows (64 in bfloat16, 32 in
// float32; `Geo`), for one (batch element, head, group of clusters).  Each
// block is a block of attention_chunked.cu: groups of warps (a warpgroup
// in bfloat16, two warps in float32), each the score products over its
// chunk(s) of CH columns (bfloat16 on `wgmma`, float32 in 3xTF32
// `mma.sync`): the forward one group a chunk, the backward kernels at most
// BWD_THREADS threads a block (`bwd_chunks`), the other side in stages of
// KEYS rows.
// The head's nd chunks are spread over the cluster as evenly as the blocks
// allow (`span_of`: block r a run of base or base + 1 chunks, 288 columns
// in bfloat16 as 3 + 2).  At each stage the groups' partial scores (and dp)
// are summed in shared memory in group order, straight into the block's
// exchange tile (`chain_part`: group 0 stores its partial, each later group
// adds its own, a block barrier before each), and only that one ROWS x
// KEYS float32 partial a block goes through the cluster's distributed
// shared memory: block r adds slice r of the n blocks' tiles in rank order
// into its `sum` tile (`reduce_slice`), then every thread reads the whole
// sum at its own places, each slice from the block that added it
// (`gather_sum`).  So every group of every block holds the same bits, with
// no atomics, runs the online softmax itself and takes its own output
// chunk (out += p v; dq += ds k; dk += ds^T qs and dv += p^T dout).
//
// Hiding the exchange.  Each cluster barrier is split: a block writes stage
// i's partial into mine[i % 2] and arrives (`barrier.cluster.arrive
// .release`); the stage's exchange is finished at the next stage, after
// that stage's score products (and before them the softmax and output of
// stage i - 1): only then does the block wait (`.wait.acquire`), add its
// slice and arrive; the groups then sum stage i + 1's partials into
// mine[(i + 1) % 2] (`chain_part`, its block barriers) before the block
// waits again and reads the sums.  A block writes mine[i % 2] again only
// after waiting at stage i's second barrier, which its peers reach once
// they have read it; its `sum` tile only after waiting at the next stage's
// first barrier, which they reach once they have read the sums; a last
// full barrier keeps every block until its peers have read its sums.  Since a stage's output products run a stage
// after its score products, the tiles of the other side sit in a ring of
// RING = 3 items (one in the products, one waiting for its output, one in
// flight); the own rows are staged once.
//
// Chunks a block (`wide_layout`; the wrapper's `kernel_layout` mirrors
// it): the most of MOST_CHUNKS (4 in bfloat16, 2 in float32: shared
// memory), then 2, then 1, that gives a cluster of at most MAX_CLUSTER
// blocks and a launch of at least MIN_BLOCKS = 64 blocks, else one chunk a
// block.  n = ceil(nd / chunks), ND = ceil(nd / n).  Fewer, larger blocks
// mean fewer exchanges for the same products: on the H100 a block of four
// chunks beat blocks of one and two down to 64 blocks a launch (half the
// SMs; at 32 and fewer the smaller blocks won), in the backward by up to 2x
// (utils/attn_sweep.py, PERF.md).  A head of more chunks than one cluster
// holds at one chunk a block (more than MAX_CLUSTER) takes per = ceil(nd /
// MAX_CLUSTER) groups of clusters of one chunk a block (grid.y = NH *
// per), each recomputing the scores in per passes of each stage, its own
// rows coming through the ring with each pass (the passes in the order g +
// 1, g + 2, ..., g, so that the group's output chunk, chunk g n + r, comes
// last): work_ratio = per in the score products.
//
// Shared memory (`wide_smem_bytes`; tests/test_torch_head_sizes.py reads
// these constants): ALIGN + sides x ND own tiles (ROWS x 64 values; staged)
// + RING x (2 x ND stage tiles, KEYS x 64, and the own tiles when
// streamed) + kinds x 3 partials (ROWS x KEYS floats: mine[2] and sum) and
// the dk/dv kernel's RING x 3 x KEYS floats of m, 1 / l and D; sides = 1
// forward, 2 backward, kinds the same.  bfloat16 at four chunks: forward
// 156,672 bytes, dq kernel 214,016, dk/dv kernel 215,168; float32 at two:
// 128,000, 156,672 and 157,824; within the 232,448 a block may have.

#include "attention.cuh"

namespace {

constexpr int RING = 3;                   // items in the ring of the other side
constexpr int MIN_BLOCKS = 64;            // the grid-size rule's floor (see the note)
template <typename E> constexpr int MOST_CHUNKS = sizeof(E) == 2 ? 4 : 2;  // a block's
constexpr int BWD_THREADS = 256;          // the most threads of a backward block

// The chunks each group of a backward kernel takes: one, or as many as keep
// the block within BWD_THREADS (bfloat16 at three or four chunks: two
// warpgroups, whose dq, or dk and dv, of two chunks and the scores and dp
// of a stage fit in 255 registers a thread, where 384 or 512 threads would
// have 170 or 128 and spill); bwd_groups of them.
template <typename E> __host__ __device__ constexpr int bwd_chunks(int nd) {
    return (nd * Tiles<E>::GT + BWD_THREADS - 1) / BWD_THREADS;
}
template <typename E> __host__ __device__ constexpr int bwd_groups(int nd) {
    return (nd + bwd_chunks<E>(nd) - 1) / bwd_chunks<E>(nd);
}

#ifdef WIDE_PHASE_CLOCKS
// A build with -DWIDE_PHASE_CLOCKS (utils/attn_phases.py) adds up thread
// 0's cycles in each phase of the forward kernel's loop (`WIDE_PHASE(k)`
// ends phase k), summed over the blocks, and counts the blocks.
constexpr int WIDE_PHASES = 8;
__device__ unsigned long long g_wide_clocks[WIDE_PHASES + 1];
#define WIDE_CLOCKS_START long long clocks_[WIDE_PHASES] = {}, clock_at_ = clock64()
#define WIDE_PHASE(k)                        \
    do {                                     \
        const long long t_ = clock64();      \
        clocks_[k] += t_ - clock_at_;        \
        clock_at_ = t_;                      \
    } while (0)
#define WIDE_CLOCKS_END                                                                  \
    do {                                                                                 \
        if (threadIdx.x == 0) {                                                          \
            for (int k_ = 0; k_ < WIDE_PHASES; ++k_)                                     \
                atomicAdd(&g_wide_clocks[k_], (unsigned long long)clocks_[k_]);          \
            atomicAdd(&g_wide_clocks[WIDE_PHASES], 1ull);                                \
        }                                                                                \
    } while (0)
#else
#define WIDE_CLOCKS_START \
    do {                  \
    } while (0)
#define WIDE_PHASE(k) \
    do {              \
    } while (0)
#define WIDE_CLOCKS_END \
    do {                \
    } while (0)
#endif

// ---------------------------------------------------------------------------
// The cluster: its barrier, split, and its distributed shared memory.

__device__ __forceinline__ int cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
    uint32_t n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
    return (int)n;
}

// Every thread of the cluster's blocks arrives (its shared-memory writes
// released) and, later, waits until all have arrived (their writes
// acquired); a thread alternates the two.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (in this block's shared memory) in the shared memory
// of the cluster's block `rank`, and a 16-byte load from there.  Both are
// `asm volatile`, so they happen where they are written: the compiler
// does not hoist the n ranks' addresses out of the kernel's loop, where
// they would hold registers through every product.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    return a;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(a));
    return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// The exchange.  A partial is ROWS x KEYS floats in the warps' accumulator
// order (float4 x[j * GT + gt]: a thread's acc[j][0..3]), as the chunked
// kernels put theirs, so neighbouring threads touch neighbouring 16 bytes.

// The block's G groups' partials summed in group order into x: group 0
// stores its own, then each group in turn adds its own to what is there,
// after a block barrier (the backward's two kinds side by side, dp's tile
// at x + 2 XV).
template <typename T>
__device__ __forceinline__ void chain_put(float4* x, int gt, const float (&acc)[T::NJ][4],
                                          bool add) {
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
        float4* at = x + j * T::GT + gt;
        const float4 v = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        *at = add ? add4(*at, v) : v;
    }
}

template <typename T, int G>
__device__ __forceinline__ void chain_part(float4* x, int g, int gt, const float (&s)[T::NJ][4]) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
        if (q > 0) __syncthreads();
        if (g == q) chain_put<T>(x, gt, s, q > 0);
    }
}

template <typename T, int G>
__device__ __forceinline__ void chain_part(float4* x, int g, int gt, const float (&s)[T::NJ][4],
                                           const float (&dp)[T::NJ][4]) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
        if (q > 0) __syncthreads();
        if (g == q) {
            chain_put<T>(x, gt, s, q > 0);
            chain_put<T>(x + 2 * T::XV, gt, dp, q > 0);
        }
    }
}

// The float4s of a partial that each block of a cluster of n adds up: block
// r those from r * len on.
template <typename T> __device__ __forceinline__ int slice_len(int n) {
    return (T::XV + n - 1) / n;
}

// Block r adds its slice of the n blocks' partials (`mine` in each block),
// in rank order, into its own `sum`; BATCH ranks' loads in flight at a time
// (4; 2 in the backward kernels, where a stage's partials are still held
// in registers: `chain_part` follows).
template <typename T, int NT, int BATCH = 4>
__device__ __forceinline__ void reduce_slice(const float4* mine, float4* sum, int n, int r) {
    const int len = slice_len<T>(n), end = min(T::XV, (r + 1) * len);
#pragma unroll 1
    for (int e = r * len + threadIdx.x; e < end; e += NT) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
        for (int q0 = 0; q0 < n; q0 += BATCH) {
            float4 v[BATCH];
#pragma unroll
            for (int q = 0; q < BATCH; ++q)
                if (q0 + q < n) v[q] = ld_cluster(cluster_addr(mine + e, q0 + q));
#pragma unroll
            for (int q = 0; q < BATCH; ++q)
                if (q0 + q < n) a = q0 + q == 0 ? v[q] : add4(a, v[q]);
        }
        sum[e] = a;
    }
}

// acc = the cluster's sum of the partial at the calling thread's places,
// each float4 read from the block that added it: every thread of every
// block that reads a place gets the same bits.
template <typename T>
__device__ __forceinline__ void gather_sum(float (&acc)[T::NJ][4], const float4* sum, int n,
                                           int gt) {
    const int len = slice_len<T>(n);
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
        const int e = j * T::GT + gt;
        const float4 v = ld_cluster(cluster_addr(sum + e, e / len));
        acc[j][0] = v.x;
        acc[j][1] = v.y;
        acc[j][2] = v.z;
        acc[j][3] = v.w;
    }
}

// ---------------------------------------------------------------------------
// The layout.

// Block r's chunks at pass p of a cluster of n over a head of hs columns:
// the first, c0, and the columns of the run from it (0: none).  One group
// of clusters (per == 1): the nd chunks spread as evenly as the blocks
// allow, a run of base or base + 1 each.  per > 1: one chunk a block, chunk
// p n + r.
struct Span {
    int c0, cols;
};

__device__ __forceinline__ Span span_of(int hs, int n, int r, int per, int p) {
    const int nd = (hs + CH - 1) / CH;
    int c0, cnt;
    if (per == 1) {
        const int base = nd / n, extra = nd % n;
        c0 = r * base + min(r, extra);
        cnt = base + (r < extra ? 1 : 0);
    } else {
        c0 = p * n + r;
        cnt = c0 < nd ? 1 : 0;
    }
    if (cnt == 0) return {0, 0};
    return {c0, min(cnt * CH, hs - c0 * CH)};
}

// The pass of item j of a stage for group `grp` of clusters: grp + 1 + j
// modulo per, so that the last is pass grp, the one with the output chunk.
__device__ __forceinline__ int pass_of(int j, int grp, int per) { return (grp + 1 + j) % per; }

// Dynamic shared memory of a wide kernel (see the opening note).
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes(int nd, int sides, bool streamed, bool stats) {
    return ALIGN + (streamed ? 0 : sides * nd * T::OWN) +
           RING * (2 * nd * T::STAGE + (streamed ? sides * nd * T::OWN : 0)) +
           3 * sides * T::PART + (stats ? RING * 3 * T::KEYS * (int)sizeof(float) : 0);
}

// The regions of that memory: the staged own tiles (`sides` kinds of ND),
// RING slots (two kinds of ND stage tiles, then, streamed, the own tiles),
// the partials (kind k: mine[2] at mine + 2 k XV, its sum at sum + k XV)
// and the dk/dv kernel's m, 1 / l and D of each slot.
template <typename T> struct Smem {
    unsigned char* own;
    unsigned char* ring;
    float4* mine;
    float4* sum;
    float* stats;
    int slot;
    __device__ Smem(unsigned char* raw, int nd, int sides, bool streamed) {
        own = aligned_smem(raw);
        ring = own + (streamed ? 0 : sides * nd * T::OWN);
        slot = 2 * nd * T::STAGE + (streamed ? sides * nd * T::OWN : 0);
        mine = reinterpret_cast<float4*>(ring + RING * slot);
        sum = mine + 2 * sides * T::XV;
        stats = reinterpret_cast<float*>(sum + sides * T::XV);
    }
    // item x's slot; its own tiles of kind s (streamed) or the staged ones
    __device__ unsigned char* at(int x) const { return ring + x % RING * slot; }
    __device__ unsigned char* own_of(int x, int s, int nd, bool streamed) const {
        return streamed ? at(x) + 2 * nd * T::STAGE + s * nd * T::OWN : own + s * nd * T::OWN;
    }
};

// acc += b, n-tile by n-tile (a later pass's partial scores).
template <int NJ> __device__ __forceinline__ void add_acc(float (&a)[NJ][4], const float (&b)[NJ][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[j][e] += b[j][e];
}

// The score products of item j of a stage into acc (the first pass) or
// added to it (a later pass; per > 1 only where ND == 1).
template <typename T, int CPW, int ND, int G>
__device__ __forceinline__ void pass_scores(float (&acc)[T::NJ][4], const unsigned char* own,
                                            const unsigned char* other, int g, int cols, int j) {
    if constexpr (ND == 1) {
        if (j > 0) {
            float more[T::NJ][4];
            scores_start<T, CPW>(more, own, other, g, G, ND, cols);
            scores_done<T>(more);
            add_acc(acc, more);
            return;
        }
    }
    scores_start<T, CPW>(acc, own, other, g, G, ND, cols);
    scores_done<T>(acc);
}

// ---------------------------------------------------------------------------
// The kernels.  In each: g the thread's group, gt its thread in the group,
// its rows `row` and row + 8 of the cluster's ROWS (lane 4g' + t of warp w
// of the group: w * 16 + g'); item x of the ring is stage x / per, pass
// `pass_of(x % per)`; the loop runs one more item than there are, to
// finish the last stage's exchange and output.

// Forward: a cluster per (ROWS queries, head and group of clusters, batch
// element); at one chunk a block, three blocks an SM (registers within
// 170 a thread: on the card a block of one warpgroup ran 1.8x slower at
// two blocks an SM).  Stage i takes key tile i (KEYS keys): the scores' partials
// (own qs against k), their sums, the online softmax, and out[:, chunk]
// += p v[:, chunk] for the group's chunk; v comes with the stage's last
// pass.
template <typename E, int ND>
__global__ void __launch_bounds__(ND * Tiles<E>::GT, ND == 1 ? 3 : 1)
qkv_attention_fwd_wide_kernel(const E* __restrict__ qkv, E* __restrict__ out, int T_len, int C,
                              int hs, int piece, int per, float scale) {
    using T = Tiles<E>;
    constexpr int NT = ND * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_wide[];
    const bool streamed = ND == 1 && per > 1;
    const Smem<T> sm(smem_wide, ND, 1, streamed);
    const int n = cluster_blocks(), r = cluster_rank();
    const int grp = blockIdx.y % per, h = blockIdx.y / per, b = blockIdx.z;
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int q0 = blockIdx.x / n * T::ROWS, row = q0 + gt / 32 * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + T::KEYS - 1) / T::KEYS, items = ntiles * per;
    const Span out_span = span_of(hs, n, r, per, grp);
    const int cols = min(CH, out_span.cols - g * CH);  // the group's output chunk's (<= 0: none)

    auto fetch = [&](int x) {
        const int i = x / per, j = x % per;
        const Span sp = span_of(hs, n, r, per, pass_of(j, grp, per));
        unsigned char* at = sm.at(x);
        tiles<E, ND, T::KEYS, NT>(at, q_head + C + sp.c0 * CH, stride, i * T::KEYS, T_len, sp.cols,
                                  piece);
        if (j == per - 1)
            tiles<E, ND, T::KEYS, NT>(at + ND * T::STAGE, q_head + 2 * C + sp.c0 * CH, stride,
                                      i * T::KEYS, T_len, sp.cols, piece);
        if (streamed)
            tiles<E, ND, T::ROWS, NT>(at + 2 * ND * T::STAGE, q_head + sp.c0 * CH, stride, q0,
                                      T_len, sp.cols, piece);
    };
    if (!streamed)
        tiles<E, ND, T::ROWS, NT>(sm.own, q_head + out_span.c0 * CH, stride, q0, T_len,
                                  out_span.cols, piece);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], e[NJ][4], o[8][4];
    zero_acc(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    WIDE_CLOCKS_START;
    for (int x = 0; x <= items; ++x) {
        const int i = x / per, j = x % per;
        if (x < items) {
            stage_ready<E>([&] {  // qs: the staged rows once, streamed ones as they come
                if (streamed || x == 0)
                    tiles<E, ND, T::ROWS, NT, true>(sm.own_of(x, 0, ND, streamed), qkv, 0, 0,
                                                    0, 0, piece, scale);
            });
            WIDE_PHASE(0);
            if (x + 1 < items) fetch(x + 1);
            cp_async_commit();
            const Span sp = span_of(hs, n, r, per, pass_of(j, grp, per));
            pass_scores<T, 1, ND, ND>(s, sm.own_of(x, 0, ND, streamed), sm.at(x), g, sp.cols, j);
            WIDE_PHASE(1);
        }
        const bool finish = j == 0 && i > 0;  // stage i - 1's exchange and output
        const bool last = x < items && j == per - 1;  // stage i's partial is complete
        if (last) chain_part<T, ND>(sm.mine + i % 2 * T::XV, g, gt, s);
        WIDE_PHASE(2);
        if (finish) {
            cluster_wait();
            WIDE_PHASE(3);
            reduce_slice<T, NT>(sm.mine + (i - 1) % 2 * T::XV, sm.sum, n, r);
            WIDE_PHASE(4);
            cluster_arrive();
            cluster_wait();
            WIDE_PHASE(5);
            gather_sum<T>(e, sm.sum, n, gt);
            WIDE_PHASE(6);
        }
        if (last) cluster_arrive();
        if (finish && cols > 0) {
            mask_keys<NJ>(e, (i - 1) * T::KEYS, T_len);
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int k = 0; k < NJ; ++k) {
                mx[0] = fmaxf(mx[0], fmaxf(e[k][0], e[k][1]));
                mx[1] = fmaxf(mx[1], fmaxf(e[k][2], e[k][3]));
            }
            float mL[2], corr[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                mx[k] = quad_max(mx[k]);  // finite: key 0 of the first tile is real
                corr[k] = exp2_approx((m[k] - mx[k]) * LOG2E);  // 0 on the first tile
                m[k] = mx[k];
                mL[k] = mx[k] * LOG2E;
                l[k] *= corr[k];
            }
#pragma unroll
            for (int k = 0; k < NJ; ++k)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    e[k][q] = exp2_approx(fmaf(e[k][q], LOG2E, -mL[q >> 1]));  // p
                    l[q >> 1] += e[k][q];
                }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                o[k][0] *= corr[0];
                o[k][1] *= corr[0];
                o[k][2] *= corr[1];
                o[k][3] *= corr[1];
            }
            output_product<T>(o, e, sm.at(i * per - 1) + (ND + g) * T::STAGE, cols);
        }
        WIDE_PHASE(7);
    }
    cluster_arrive();  // no block leaves while a peer may still read its sums
    cluster_wait();
    WIDE_CLOCKS_END;

    if (cols > 0)
        store_acc<E, 8>(out + (size_t)b * T_len * C + (size_t)h * hs + (out_span.c0 + g) * CH, C,
                        row, T_len, o, cols, hs & 1, 1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// Backward, kernel 1: a cluster per (ROWS queries, head and group of
// clusters, batch element), two sweeps over the key tiles in one ring as in
// the chunked kernels.  Each stage takes the partials of s (qs k^T) and dp
// (dout v^T) and their sums; the first sweep takes each row's m, l and D,
// the second adds ds k[:, chunk] to each of the group's chunks of dq (G
// groups of CPW chunks, `bwd_chunks`; k's chunks from the stage's last
// pass).  Group 0 of rank 0 of the first group of clusters
// writes the rows' m, 1 / l and D.
template <typename E, int ND>
__global__ void __launch_bounds__(bwd_groups<E>(ND) * Tiles<E>::GT, 1)
qkv_attention_bwd_dq_wide_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                 E* __restrict__ dqkv, float* __restrict__ stats, int T_len, int C,
                                 int NH, int hs, int piece, int per, float scale) {
    using T = Tiles<E>;
    constexpr int CPW = bwd_chunks<E>(ND), G = bwd_groups<E>(ND);
    constexpr int NT = G * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_wide[];
    const bool streamed = ND == 1 && per > 1;
    const Smem<T> sm(smem_wide, ND, 2, streamed);  // own: qs, then dout; slots: k, then v
    const int n = cluster_blocks(), r = cluster_rank();
    const int grp = blockIdx.y % per, h = blockIdx.y / per, b = blockIdx.z;
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int q0 = blockIdx.x / n * T::ROWS, row = q0 + gt / 32 * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int sweep = (T_len + T::KEYS - 1) / T::KEYS, items = 2 * sweep * per;
    const Span out_span = span_of(hs, n, r, per, grp);

    auto own_rows = [&](unsigned char* to, const Span& sp) {
        tiles<E, ND, T::ROWS, NT>(to, q_head + sp.c0 * CH, stride, q0, T_len, sp.cols, piece);
        tiles<E, ND, T::ROWS, NT>(to + ND * T::OWN, o_head + sp.c0 * CH, (size_t)C, q0, T_len,
                                  sp.cols, piece);
    };
    auto fetch = [&](int x) {
        const int k0 = x / per % sweep * T::KEYS;
        const Span sp = span_of(hs, n, r, per, pass_of(x % per, grp, per));
        unsigned char* at = sm.at(x);
        tiles<E, ND, T::KEYS, NT>(at, q_head + C + sp.c0 * CH, stride, k0, T_len, sp.cols, piece);
        tiles<E, ND, T::KEYS, NT>(at + ND * T::STAGE, q_head + 2 * C + sp.c0 * CH, stride, k0,
                                  T_len, sp.cols, piece);
        if (streamed) own_rows(at + 2 * ND * T::STAGE, sp);
    };
    if (!streamed) own_rows(sm.own, out_span);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], dp[NJ][4], es[NJ][4], edp[NJ][4], dq[CPW][8][4];
#pragma unroll
    for (int c = 0; c < CPW; ++c) zero_acc(dq[c]);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
    for (int x = 0; x <= items; ++x) {
        const int i = x / per, j = x % per;
        if (x < items) {
            stage_ready<E>([&] {
                if (streamed || x == 0)
                    tiles<E, ND, T::ROWS, NT, true>(sm.own_of(x, 0, ND, streamed), qkv, 0, 0,
                                                    0, 0, piece, scale);
            });
            if (x + 1 < items) fetch(x + 1);
            cp_async_commit();
            const Span sp = span_of(hs, n, r, per, pass_of(j, grp, per));
            const unsigned char* at = sm.at(x);
            pass_scores<T, CPW, ND, G>(s, sm.own_of(x, 0, ND, streamed), at, g, sp.cols, j);
            pass_scores<T, CPW, ND, G>(dp, sm.own_of(x, 1, ND, streamed), at + ND * T::STAGE, g,
                                       sp.cols, j);
        }
        const bool finish = j == 0 && i > 0;
        const bool last = x < items && j == per - 1;
        // the groups' sums with their block barriers between the second
        // barrier's arrive and wait; one group's before the first's wait
        if (G == 1 && last) chain_part<T, G>(sm.mine + i % 2 * T::XV, g, gt, s, dp);
        if (finish) {
            cluster_wait();
            reduce_slice<T, NT, 2>(sm.mine + (i - 1) % 2 * T::XV, sm.sum, n, r);
            reduce_slice<T, NT, 2>(sm.mine + (2 + (i - 1) % 2) * T::XV, sm.sum + T::XV, n, r);
            cluster_arrive();
        }
        if (G > 1 && last) chain_part<T, G>(sm.mine + i % 2 * T::XV, g, gt, s, dp);
        if (finish) {
            cluster_wait();
            gather_sum<T>(es, sm.sum, n, gt);
            gather_sum<T>(edp, sm.sum + T::XV, n, gt);
        }
        if (last) cluster_arrive();
        if (finish) {
            const int kt = (i - 1) % sweep;
            mask_keys<NJ>(es, kt * T::KEYS, T_len);
            if (i - 1 < sweep) {  // sweep 1
                float mx[2] = {m[0], m[1]};
#pragma unroll
                for (int k = 0; k < NJ; ++k) {
                    mx[0] = fmaxf(mx[0], fmaxf(es[k][0], es[k][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(es[k][2], es[k][3]));
                }
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    mx[k] = quad_max(mx[k]);
                    const float corr = exp2_approx((m[k] - mx[k]) * LOG2E);
                    m[k] = mx[k];
                    mL[k] = mx[k] * LOG2E;
                    l[k] *= corr;
                    dl[k] *= corr;
                }
#pragma unroll
                for (int k = 0; k < NJ; ++k)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const float p = exp2_approx(fmaf(es[k][q], LOG2E, -mL[q >> 1]));
                        l[q >> 1] += p;
                        dl[q >> 1] = fmaf(p, edp[k][q], dl[q >> 1]);
                    }
                if (kt == sweep - 1) {  // the rows' statistics, for sweep 2
#pragma unroll
                    for (int k = 0; k < 2; ++k) {
                        inv_l[k] = 1.f / quad_sum(l[k]);
                        D[k] = quad_sum(dl[k]) * inv_l[k];
                    }
                }
            } else if (out_span.cols > g * CH) {  // sweep 2
#pragma unroll
                for (int k = 0; k < NJ; ++k)
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int rr = q >> 1;
                        const float p = exp2_approx(fmaf(es[k][q], LOG2E, -mL[rr])) * inv_l[rr];
                        es[k][q] = p * (edp[k][q] - D[rr]);  // ds
                    }
                const unsigned char* at = sm.at(i * per - 1);
#pragma unroll
                for (int c = 0; c < CPW; ++c) {
                    const int d = g + c * G, dcols = min(CH, out_span.cols - d * CH);
                    if (d >= ND || dcols <= 0) break;
                    output_product<T>(dq[c], es, at + d * T::STAGE, dcols);
                }
            }
        }
    }
    cluster_arrive();  // no block leaves while a peer may still read its sums
    cluster_wait();

#pragma unroll
    for (int c = 0; c < CPW; ++c) {
        const int d = g + c * G, dcols = min(CH, out_span.cols - d * CH);
        if (d >= ND || dcols <= 0) break;
        store_acc<E, 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs + (out_span.c0 + d) * CH,
                        stride, row, T_len, dq[c], dcols, hs & 1, scale, scale);
    }
    if (grp == 0 && r == 0 && g == 0 && t == 0) {
        const size_t plane = (size_t)gridDim.z * NH * T_len;
        float* st = stats + ((size_t)b * NH + h) * T_len;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int rr = row + 8 * k;
            if (rr >= T_len) continue;
            st[rr] = m[k];
            st[plane + rr] = inv_l[k];
            st[2 * plane + rr] = D[k];
        }
    }
}

// Backward, kernel 2: a cluster per (ROWS keys, head and group of clusters,
// batch element), one sweep over the query tiles (KEYS queries a stage, qs
// scaled as it arrives; their m, 1 / l and D with the stage's last pass).
// Group g takes chunks g + G i of the block's run (G groups of CPW chunks,
// `bwd_chunks`).  Each stage takes the partials of s^T (k qs^T) and dp^T
// (v dout^T) and their sums, then dv += p^T dout and dk += ds^T qs on the
// group's chunks.
template <typename E, int ND>
__global__ void __launch_bounds__(bwd_groups<E>(ND) * Tiles<E>::GT, 1)
qkv_attention_bwd_dkv_wide_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                  E* __restrict__ dqkv, const float* __restrict__ stats,
                                  int T_len, int C, int NH, int hs, int piece, int per,
                                  float scale) {
    using T = Tiles<E>;
    constexpr int CPW = bwd_chunks<E>(ND), G = bwd_groups<E>(ND);
    constexpr int NT = G * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_wide[];
    const bool streamed = ND == 1 && per > 1;
    const Smem<T> sm(smem_wide, ND, 2, streamed);  // own: k, then v; slots: qs, then dout
    const int n = cluster_blocks(), r = cluster_rank();
    const int grp = blockIdx.y % per, h = blockIdx.y / per, b = blockIdx.z;
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int k0 = blockIdx.x / n * T::ROWS, row = k0 + gt / 32 * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int ntiles = (T_len + T::KEYS - 1) / T::KEYS, items = ntiles * per;
    const Span out_span = span_of(hs, n, r, per, grp);

    auto own_rows = [&](unsigned char* to, const Span& sp) {
        tiles<E, ND, T::ROWS, NT>(to, q_head + C + sp.c0 * CH, stride, k0, T_len, sp.cols, piece);
        tiles<E, ND, T::ROWS, NT>(to + ND * T::OWN, q_head + 2 * C + sp.c0 * CH, stride, k0,
                                  T_len, sp.cols, piece);
    };
    auto fetch = [&](int x) {
        const int i = x / per, j = x % per, q0 = i * T::KEYS;
        const Span sp = span_of(hs, n, r, per, pass_of(j, grp, per));
        unsigned char* at = sm.at(x);
        tiles<E, ND, T::KEYS, NT>(at, q_head + sp.c0 * CH, stride, q0, T_len, sp.cols, piece);
        tiles<E, ND, T::KEYS, NT>(at + ND * T::STAGE, o_head + sp.c0 * CH, (size_t)C, q0, T_len,
                                  sp.cols, piece);
        if (j == per - 1) {
            float* to = sm.stats + x % RING * 3 * T::KEYS;
            for (int e = threadIdx.x; e < 3 * T::KEYS; e += NT) {
                const int kind = e / T::KEYS, q = e % T::KEYS;
                const bool valid = q0 + q < T_len;
                cp_async4(to + e, st + kind * plane + (valid ? q0 + q : 0), valid);
            }
        }
        if (streamed) own_rows(at + 2 * ND * T::STAGE, sp);
    };
    if (!streamed) own_rows(sm.own, out_span);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], dp[NJ][4], es[NJ][4], edp[NJ][4], dk[CPW][8][4], dv[CPW][8][4];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
        zero_acc(dk[c]);
        zero_acc(dv[c]);
    }
    for (int x = 0; x <= items; ++x) {
        const int i = x / per, j = x % per;
        if (x < items) {
            // qs = round(q * scale), once per staged value: each thread
            // scales the pieces of the item it copied itself.
            stage_ready<E>([&] {
                tiles<E, ND, T::KEYS, NT, true>(sm.at(x), qkv, 0, 0, 0, 0, piece, scale);
            });
            if (x + 1 < items) fetch(x + 1);
            cp_async_commit();
            const Span sp = span_of(hs, n, r, per, pass_of(j, grp, per));
            const unsigned char* at = sm.at(x);
            pass_scores<T, CPW, ND, G>(s, sm.own_of(x, 0, ND, streamed), at, g, sp.cols, j);  // s^T
            pass_scores<T, CPW, ND, G>(dp, sm.own_of(x, 1, ND, streamed), at + ND * T::STAGE, g,
                                       sp.cols, j);  // dp^T
        }
        const bool finish = j == 0 && i > 0;
        const bool last = x < items && j == per - 1;
        // the groups' sums with their block barriers between the second
        // barrier's arrive and wait; one group's before the first's wait
        if (G == 1 && last) chain_part<T, G>(sm.mine + i % 2 * T::XV, g, gt, s, dp);
        if (finish) {
            cluster_wait();
            reduce_slice<T, NT, 2>(sm.mine + (i - 1) % 2 * T::XV, sm.sum, n, r);
            reduce_slice<T, NT, 2>(sm.mine + (2 + (i - 1) % 2) * T::XV, sm.sum + T::XV, n, r);
            cluster_arrive();
        }
        if (G > 1 && last) chain_part<T, G>(sm.mine + i % 2 * T::XV, g, gt, s, dp);
        if (finish) {
            cluster_wait();
            gather_sum<T>(es, sm.sum, n, gt);
            gather_sum<T>(edp, sm.sum + T::XV, n, gt);
        }
        if (last) cluster_arrive();
        if (finish && out_span.cols > g * CH) {
            const int last = i * per - 1, q0 = (i - 1) * T::KEYS;
            const float (*st_t)[T::KEYS] =
                reinterpret_cast<const float (*)[T::KEYS]>(sm.stats + last % RING * 3 * T::KEYS);
#pragma unroll
            for (int k = 0; k < NJ; ++k) {
                const int q = 8 * k + 2 * t;  // the tile's query columns q, q + 1
                const float2 mm = *reinterpret_cast<const float2*>(&st_t[0][q]);
                const float2 il = *reinterpret_cast<const float2*>(&st_t[1][q]);
                const float2 dd = *reinterpret_cast<const float2*>(&st_t[2][q]);
                const float mLq[2] = {mm.x * LOG2E, mm.y * LOG2E};
                const float ilq[2] = {il.x, il.y}, Dq[2] = {dd.x, dd.y};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kk = e & 1;
                    const float p = q0 + q + kk < T_len
                                        ? exp2_approx(fmaf(es[k][e], LOG2E, -mLq[kk])) * ilq[kk]
                                        : 0.f;
                    edp[k][e] = p * (edp[k][e] - Dq[kk]);  // ds
                    es[k][e] = p;
                }
            }
            const unsigned char* at = sm.at(last);
#pragma unroll
            for (int c = 0; c < CPW; ++c) {
                const int d = g + c * G, dcols = min(CH, out_span.cols - d * CH);
                if (d >= ND || dcols <= 0) break;
                output_product<T>(dv[c], es, at + (ND + d) * T::STAGE, dcols);
                output_product<T>(dk[c], edp, at + d * T::STAGE, dcols);
            }
        }
    }
    cluster_arrive();  // no block leaves while a peer may still read its sums
    cluster_wait();

#pragma unroll
    for (int c = 0; c < CPW; ++c) {
        const int d = g + c * G, dcols = min(CH, out_span.cols - d * CH);
        if (d >= ND || dcols <= 0) break;
        E* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs + (out_span.c0 + d) * CH;
        store_acc<E, 8>(k_out, stride, row, T_len, dk[c], dcols, hs & 1, 1.f, 1.f);
        store_acc<E, 8>(k_out + C, stride, row, T_len, dv[c], dcols, hs & 1, 1.f, 1.f);
    }
}

// ---------------------------------------------------------------------------
// The launchers.

// A head's clusters (ops/kernels/attention.py's `kernel_layout`): n blocks
// a cluster, per groups of clusters, at most `chunks` chunks a block.
struct WideLayout {
    int n, per, chunks;
};

// The layout for a head of hs columns at `row_tiles` tiles of ROWS own rows
// in all (B * NH * ceil(T / ROWS)): the most chunks a block of `most`,
// most / 2, ... that keeps the cluster within MAX_CLUSTER blocks and the
// launch at `min_blocks` blocks or more, else one (see the opening note).
inline WideLayout wide_layout(int hs, long long row_tiles, int most, long long min_blocks) {
    const int nd = (hs + CH - 1) / CH;
    for (int c = most; c > 1; c /= 2) {
        const int n = (nd + c - 1) / c;
        if (n <= MAX_CLUSTER && row_tiles * n >= min_blocks) return {n, 1, (nd + n - 1) / n};
    }
    const int n = nd < MAX_CLUSTER ? nd : MAX_CLUSTER;
    return {n, (nd + n - 1) / n, 1};
}

// Calls f(std::integral_constant<int, ND>()) for ND = 1 .. MOST_CHUNKS<E>.
template <typename E, typename F> int with_block_chunks(int nd, F&& f) {
    if constexpr (MOST_CHUNKS<E> >= 4) {
        if (nd == 4) return f(std::integral_constant<int, 4>());
        if (nd == 3) return f(std::integral_constant<int, 3>());
    }
    if (nd == 2) return f(std::integral_constant<int, 2>());
    return f(std::integral_constant<int, 1>());
}

// One launch of `kernel` on grid (tiles * n, NH * per, B) in clusters of
// (n, 1, 1), `threads` a block, with `smem` bytes of dynamic shared memory
// (`limit` the most any launch of it takes).
template <typename... Params, typename... Args>
cudaError_t launch_wide(void (*kernel)(Params...), int threads, int smem, int limit,
                        WideLayout w, long long tiles, int NH, int B, cudaStream_t stream,
                        Args... args) {
    if ((long long)NH * w.per > 65535 || tiles * w.n > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(kernel, limit);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * w.n), (unsigned)(NH * w.per), (unsigned)B);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = w.n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();  // clears what a failed call left
    return err != cudaSuccess ? err : last;
}

template <typename E> long long row_tiles(int B, int T_len, int NH) {
    return (long long)B * NH * ((T_len + Geo<E>::ROWS - 1) / Geo<E>::ROWS);
}

template <typename E>
int fwd_wide(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale, int most,
             long long min_blocks, cudaStream_t stream) {
    const int hs = C / NH;
    const WideLayout w = wide_layout(hs, row_tiles<E>(B, T_len, NH), most, min_blocks);
    return with_block_chunks<E>(w.chunks, [&](auto chunks) {
        constexpr int ND = decltype(chunks)::value;
        using T = Tiles<E>;
        constexpr int limit = wide_smem_bytes<T>(ND, 1, false, false) >
                                      wide_smem_bytes<T>(ND, 1, ND == 1, false)
                                  ? wide_smem_bytes<T>(ND, 1, false, false)
                                  : wide_smem_bytes<T>(ND, 1, ND == 1, false);
        static_assert(limit <= SMEM_LIMIT, "a block's shared memory");
        return (int)launch_wide(qkv_attention_fwd_wide_kernel<E, ND>, ND * T::GT,
                                wide_smem_bytes<T>(ND, 1, w.per > 1, false), limit, w,
                                (T_len + T::ROWS - 1) / T::ROWS, NH, B, stream,
                                static_cast<const E*>(qkv), static_cast<E*>(out), T_len, C, hs,
                                piece_bytes(hs, sizeof(E)), w.per, scale);
    });
}

template <typename E>
int bwd_wide(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int T_len, int C,
             int NH, float scale, int most, long long min_blocks, cudaStream_t stream) {
    const int hs = C / NH, piece = piece_bytes(hs, sizeof(E));
    const WideLayout w = wide_layout(hs, row_tiles<E>(B, T_len, NH), most, min_blocks);
    return with_block_chunks<E>(w.chunks, [&](auto chunks) {
        constexpr int ND = decltype(chunks)::value;
        using T = Tiles<E>;
        constexpr int dq_limit = wide_smem_bytes<T>(ND, 2, false, false) >
                                         wide_smem_bytes<T>(ND, 2, ND == 1, false)
                                     ? wide_smem_bytes<T>(ND, 2, false, false)
                                     : wide_smem_bytes<T>(ND, 2, ND == 1, false);
        constexpr int dkv_limit = wide_smem_bytes<T>(ND, 2, false, true) >
                                          wide_smem_bytes<T>(ND, 2, ND == 1, true)
                                      ? wide_smem_bytes<T>(ND, 2, false, true)
                                      : wide_smem_bytes<T>(ND, 2, ND == 1, true);
        static_assert(dq_limit <= SMEM_LIMIT && dkv_limit <= SMEM_LIMIT,
                      "a block's shared memory");
        const long long tiles = (T_len + T::ROWS - 1) / T::ROWS;
        const E* x = static_cast<const E*>(qkv);
        const E* dy = static_cast<const E*>(dout);
        E* dx = static_cast<E*>(dqkv);
        const cudaError_t err = launch_wide(
            qkv_attention_bwd_dq_wide_kernel<E, ND>, bwd_groups<E>(ND) * T::GT,
            wide_smem_bytes<T>(ND, 2, w.per > 1, false), dq_limit, w, tiles, NH, B, stream, x, dy,
            dx, stats, T_len, C, NH, hs, piece, w.per, scale);
        if (err != cudaSuccess) return (int)err;
        return (int)launch_wide(qkv_attention_bwd_dkv_wide_kernel<E, ND>, bwd_groups<E>(ND) * T::GT,
                                wide_smem_bytes<T>(ND, 2, w.per > 1, true), dkv_limit, w, tiles,
                                NH, B, stream, x, dy, dx, static_cast<const float*>(stats), T_len,
                                C, NH, hs, piece, w.per, scale);
    });
}

int most_chunks(int is_bf16) { return is_bf16 ? MOST_CHUNKS<bf16> : MOST_CHUNKS<float>; }

}  // namespace

int attention_fwd_wide(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
                       int is_bf16, cudaStream_t stream) {
    const int most = most_chunks(is_bf16);
    return is_bf16 ? fwd_wide<bf16>(qkv, out, B, T_len, C, NH, scale, most, MIN_BLOCKS, stream)
                   : fwd_wide<float>(qkv, out, B, T_len, C, NH, scale, most, MIN_BLOCKS, stream);
}

int attention_bwd_wide(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                       int T_len, int C, int NH, float scale, int is_bf16, cudaStream_t stream) {
    const int most = most_chunks(is_bf16);
    return is_bf16 ? bwd_wide<bf16>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, most,
                                    MIN_BLOCKS, stream)
                   : bwd_wide<float>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, most,
                                     MIN_BLOCKS, stream);
}

// The cluster kernels of `unet_qkv_attention_fwd` and `_bwd` (the same
// arguments, a head wider than CH * MAX_CHUNKS) at `chunks` chunks a block
// at the most (1, 2 or, bfloat16 only, 4), whatever the launch's size:
// utils/attn_sweep.py times each beside the rule's choice, utils/attn_phases.py
// clocks the forward's phases.
extern "C" int unet_qkv_attention_fwd_cluster(const void* qkv, void* out, int B, int T_len, int C,
                                              int NH, float scale, int is_bf16, int chunks,
                                              cudaStream_t stream) {
    if (B <= 0 || T_len <= 0 || NH <= 0 || C % NH != 0 || C / NH <= CH * MAX_CHUNKS ||
        chunks < 1 || chunks > most_chunks(is_bf16))
        return (int)cudaErrorInvalidValue;
    return is_bf16 ? fwd_wide<bf16>(qkv, out, B, T_len, C, NH, scale, chunks, 0, stream)
                   : fwd_wide<float>(qkv, out, B, T_len, C, NH, scale, chunks, 0, stream);
}

extern "C" int unet_qkv_attention_bwd_cluster(const void* qkv, const void* dout, void* dqkv,
                                              float* stats, int B, int T_len, int C, int NH,
                                              float scale, int is_bf16, int chunks,
                                              cudaStream_t stream) {
    if (B <= 0 || T_len <= 0 || NH <= 0 || C % NH != 0 || C / NH <= CH * MAX_CHUNKS ||
        chunks < 1 || chunks > most_chunks(is_bf16))
        return (int)cudaErrorInvalidValue;
    return is_bf16 ? bwd_wide<bf16>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, chunks, 0,
                                    stream)
                   : bwd_wide<float>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, chunks, 0,
                                     stream);
}

#ifdef WIDE_PHASE_CLOCKS
// The forward kernel's phase cycles summed over its blocks since the last
// call, then the blocks counted (WIDE_PHASES + 1 values); zeroes them.
extern "C" int unet_wide_phase_clocks(unsigned long long* out) {
    cudaError_t err = cudaMemcpyFromSymbol(out, g_wide_clocks, sizeof(g_wide_clocks));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[WIDE_PHASES + 1] = {};
    return (int)cudaMemcpyToSymbol(g_wide_clocks, zero, sizeof(zero));
}
#endif
