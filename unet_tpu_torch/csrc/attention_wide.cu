// Attention forward and backward for a head wider than the chunked kernels
// take (CH * MAX_CHUNKS = 256 columns): every wider head, of any size.  The
// same two TPU kernels as attention.cu (`_fwd_kernel` and `_bwd_kernel` of
// unet_tpu/ops/pallas/attention.py, :41 and :61), the same rounding points
// and the same two-kernel backward (dq and the rows' m, 1 / l and D; then dk
// and dv).
//
// Bound on an H100: as attention.cu says, device memory at the U-Net's T =
// 64 and 256 in bfloat16, the operations from T = 256 in float32, so the
// blocks that share a head's rows share its scores (as the groups of a
// block do in attention_chunked.cu), each score computed once.
//
// Design.  One thread-block cluster of n blocks (at most MAX_CLUSTER, the
// portable size) per (batch, head, 64-row tile, group g).  The head is cut
// into nd chunks of CH columns; block r of the cluster owns the chunks r, r
// + n, r + 2n, ... (`Share`): it takes the score products over those chunks
// only, the partial scores of a 64 x 64 tile, and the n blocks add their
// partials through distributed shared memory (the exchange, below), so that
// every block holds the same bits of the tile's scores.  Each
// block then runs the online softmax on the whole tile and takes one output
// chunk, c = r + n g, which is its g-th own chunk and the ring's last at
// each tile, so that the dq and dk/dv kernels take the tiles they need for
// their output (k's, or qs's and dout's chunk c) from the products' own
// items.  One output chunk a block keeps the registers of a 64-wide head
// (the scores, dp and two 16 x 64 accumulators at most, as the chunked
// kernels); a head of nd > MAX_CLUSTER chunks needs per = ceil(nd /
// MAX_CLUSTER) groups (grid.y = NH * per), each a cluster that recomputes
// the scores for its n output chunks: the score products are done per
// times, once for a head of up to 8 chunks (512 columns), which is DDPM's
// 256 x 256 model's one head of 512.  The wrapper's `kernel_layout` names n
// and per, `work_ratio` the work over the exact head.
//
// The exchange of a tile's partials, with no atomics (`put_partial`,
// `reduce_slice`, `gather_sums`): each block writes its partial (the
// forward's scores; the backward's scores and dp) into a tile of its shared
// memory in the warps' accumulator order; after the cluster's barrier
// (release, acquire) block r adds the n partials' r-th slice in rank order
// into a second tile; after a second barrier every block reads the whole
// sum, each slice from the block that added it.  So a block reads two
// tiles' worth however large the cluster, and every block holds the same
// bits.  One tile each is enough: a block writes its partial again after
// this exchange's second barrier, which its peers reach once they have
// read it, and its sum after the next exchange's first barrier, which they
// reach once they have read that; a last barrier keeps every block until
// its peers have read its sums.
//
// The own rows (queries in the forward and the dq kernel, keys and values in
// the dk/dv kernel): where a block owns at most STAGES chunks they are
// staged once (a chunk tile each) and the qs scaled there once; otherwise
// each item of the ring brings its own chunk beside the other side's, in as
// many tiles, so shared memory is the same either way: 137,216 bytes in the
// float32 forward, 204,800 in the dq kernel, 206,336 in the dk/dv kernel.
// Copies take the widest piece of 16, 8, 4 or 2 bytes that every head's row
// starts on, as in attention_chunked.cu.

#include <cooperative_groups.h>

#include "attention.cuh"

namespace cgrp = cooperative_groups;

namespace {

// A 64 x 64 float32 tile in the warps' accumulator order: v[j][thread]
// holds a thread's acc[j][0..3], so neighbouring threads write and read
// neighbouring 16 bytes.
struct XTile {
    float4 v[8][THREADS];
};
constexpr int XVECS = 8 * THREADS;  // the float4s of a tile

// The exchange, in three steps between two cluster barriers.  Step 1: the
// block's partial into its tile `mine`.
__device__ __forceinline__ void put_partial(XTile* mine, const float (&acc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
        mine->v[j][threadIdx.x] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
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

// The float4s of a tile that each block of a cluster of n adds up: block r
// those from r * len on.
__device__ __forceinline__ int slice_len(int n) { return (XVECS + n - 1) / n; }

// Step 2: block r adds its slice of the n blocks' partials (`mine` in each
// block), in rank order, into its own tile `sum`; four ranks' loads in
// flight at a time.
__device__ __forceinline__ void reduce_slice(const XTile* mine, XTile* sum, int n, int r) {
    const int len = slice_len(n), end = min(XVECS, (r + 1) * len);
#pragma unroll 1
    for (int e = r * len + threadIdx.x; e < end; e += THREADS) {
        const float4* here = &mine->v[0][0] + e;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
        for (int q0 = 0; q0 < n; q0 += 4) {
            float4 v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q0 + q < n) v[q] = ld_cluster(cluster_addr(here, q0 + q));
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q0 + q < n) {
                    a.x += v[q].x;
                    a.y += v[q].y;
                    a.z += v[q].z;
                    a.w += v[q].w;
                }
            }
        }
        (&sum->v[0][0])[e] = a;
    }
}

// Step 3: acc = the cluster's sum of the tile, each float4 read from the
// block that added it (`sum` in each block): every block gets the same bits.
__device__ __forceinline__ void gather_sums(float (&acc)[8][4], const XTile* sum, int n) {
    const int len = slice_len(n);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int e = j * THREADS + threadIdx.x;
        const float4 v = ld_cluster(cluster_addr(&sum->v[0][0] + e, e / len));
        acc[j][0] = v.x;
        acc[j][1] = v.y;
        acc[j][2] = v.z;
        acc[j][3] = v.w;
    }
}

// Block r's share of a head of hs columns in a cluster of n at group g: its
// chunks r + n i, i < cnt; its output chunk c = r + n g and that chunk's
// columns (0 where g >= cnt: no output); at each tile the ring takes its
// chunks in the order i = (g + 1 + k) % cnt, k = 0 .. cnt - 1, chunk c last.
struct Share {
    int n, r, g, cnt, c, cols;
    __device__ Share(int hs, int n_, int r_, int g_) : n(n_), r(r_), g(g_) {
        const int nd = (hs + CH - 1) / CH;
        cnt = (nd - r + n - 1) / n;
        c = r + n * g;
        cols = g < cnt ? min(CH, hs - c * CH) : 0;
    }
    __device__ int index(int k) const { return (g + 1 + k) % cnt; }
    __device__ int chunk(int i) const { return r + n * i; }
};

// The columns of chunk d of a head of hs.
__device__ __forceinline__ int chunk_cols(int hs, int d) { return min(CH, hs - d * CH); }

// Forward: a cluster per (batch, head and group, TILE queries).  Item `it`
// of the ring is key tile it / cnt and the block's chunk index(it % cnt):
// k's chunk (and, streamed, qs's), with v's chunk c at the tile's last item;
// there the block's partial scores are complete, the cluster adds them, and
// the online softmax and out += p v run as in attention_chunked.cu.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_fwd_wide_kernel(const E* __restrict__ qkv, E* __restrict__ out, int T_len, int C,
                              int hs, int piece, int per, float scale) {
    extern __shared__ __align__(128) unsigned char smem_wide[];
    cgrp::cluster_group cluster = cgrp::this_cluster();
    XTile* x = reinterpret_cast<XTile*>(smem_wide);  // partial scores, their sum
    const ChunkRing<E> q_s = reinterpret_cast<ChunkRing<E>>(x + 2);
    const ChunkRing<E> k_s = q_s + STAGES, v_s = k_s + STAGES;
    const int n = (int)cluster.num_blocks();
    const Share sh(hs, n, (int)cluster.block_rank(), blockIdx.y % per);
    const bool staged = per <= STAGES;
    const int h = blockIdx.y / per, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int q0 = blockIdx.x / n * TILE, row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE, items = ntiles * sh.cnt;

    auto fetch = [&](int it) {
        const int kt = it / sh.cnt, k = it % sh.cnt, buf = it % STAGES;
        const int d = sh.chunk(sh.index(k)), dcols = chunk_cols(hs, d);
        if (!staged)
            copy_rows(&q_s[buf][0][0], LDC<E>, CH, q_head + d * CH, stride, q0, T_len, dcols,
                      piece);
        copy_rows(&k_s[buf][0][0], LDC<E>, CH, q_head + C + d * CH, stride, kt * TILE, T_len,
                  dcols, piece);
        if (k == sh.cnt - 1 && sh.cols > 0)
            copy_rows(&v_s[buf][0][0], LDC<E>, CH, q_head + 2 * C + sh.c * CH, stride, kt * TILE,
                      T_len, sh.cols, piece);
    };
    if (staged)
        for (int i = 0; i < sh.cnt; ++i)
            copy_rows(&q_s[i][0][0], LDC<E>, CH, q_head + sh.chunk(i) * CH, stride, q0, T_len,
                      chunk_cols(hs, sh.chunk(i)), piece);
    fetch(0);
    cp_async_commit();

    float s[8][4], o[8][4];
    zero_acc(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        const int kt = it / sh.cnt, k = it % sh.cnt, buf = it % STAGES;
        const int i = sh.index(k), d = sh.chunk(i);
        // qs, this thread's pieces: the staged chunks once, a streamed one
        // as it arrives
        if (!staged)
            scale_rows(&q_s[buf][0][0], LDC<E>, CH, scale, piece);
        else if (it == 0)
            for (int j = 0; j < sh.cnt; ++j) scale_rows(&q_s[j][0][0], LDC<E>, CH, scale, piece);
        __syncthreads();

        if (k == 0) zero_acc(s);
        chunk_scores(s, &q_s[staged ? i : buf][0][0], LDC<E>, k_s[buf], chunk_cols(hs, d));
        if (k == sh.cnt - 1) {  // the block's partial of key tile kt
            put_partial(x, s);
            cluster.sync();
            reduce_slice(x, x + 1, sh.n, sh.r);
            cluster.sync();
            gather_sums(s, x + 1, sh.n);
            if (sh.cols > 0) {
                mask_keys<8>(s, kt * TILE, T_len);
                float mx[2] = {m[0], m[1]};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
                }
                float mL[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = quad_max(mx[r]);  // finite: key 0 of the first tile is real
                    const float corr = exp2_approx((m[r] - mx[r]) * LOG2E);  // 0 on the first tile
                    m[r] = mx[r];
                    mL[r] = mx[r] * LOG2E;
                    l[r] *= corr;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        o[j][2 * r] *= corr;
                        o[j][2 * r + 1] *= corr;
                    }
                }
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        s[j][e] = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));  // p
                        l[e >> 1] += s[j][e];
                    }
                chunk_pv(o, s, v_s[buf], sh.cols);
            }
        }
        __syncthreads();  // the tiles have been consumed before they are refilled
    }
    cluster.sync();  // no block leaves while a peer may still read its sums

    if (sh.cols > 0)
        store_acc<E, 8>(out + (size_t)b * T_len * C + (size_t)h * hs + sh.c * CH, C, row, T_len, o,
                        sh.cols, hs & 1, 1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// The backward kernels take each tile (of keys in the dq kernel, of
// queries in the dk/dv kernel) in 2 cnt items: cnt of the score product,
// over the block's chunks in `Share::index` order, then cnt of the dp
// product, so that only one of the two accumulators is live while the
// products run.  The two kinds of item have rings of their own, each
// counted apart (its a-th item in slot a % STAGES), so that the tiles of
// the score items' last chunk (chunk c) stay in their ring until the tile's
// output product, which needs them.
struct Item {
    int tile, k, slot, last_score_slot;
    bool dp;  // an item of the dp product
    __device__ Item(int it, int cnt) {
        tile = it / (2 * cnt);
        const int j = it % (2 * cnt);
        dp = j >= cnt;
        k = dp ? j - cnt : j;
        slot = (tile * cnt + k) % STAGES;
        last_score_slot = (tile * cnt + cnt - 1) % STAGES;
    }
};

// Backward, kernel 1: a cluster per (batch, head and group, TILE queries),
// two sweeps over the key tiles; each tile's score items (qs's and k's
// chunks) and dp items (dout's and v's), whose partial scores and dp the
// cluster adds at the tile's last item; there the first sweep takes each
// row's m, l and D, the second adds ds k to the block's chunk c of dq (k's
// chunk c is the last score item's tile).  The blocks of group 0 and rank 0
// write the rows' m, 1 / l and D.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dq_wide_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                 E* __restrict__ dqkv, float* __restrict__ stats, int T_len, int C,
                                 int NH, int hs, int piece, int per, float scale) {
    extern __shared__ __align__(128) unsigned char smem_wide[];
    cgrp::cluster_group cluster = cgrp::this_cluster();
    XTile* x = reinterpret_cast<XTile*>(smem_wide);  // partial scores, dp; their sums
    const ChunkRing<E> q_s = reinterpret_cast<ChunkRing<E>>(x + 4);
    const ChunkRing<E> o_s = q_s + STAGES, k_s = o_s + STAGES, v_s = k_s + STAGES;
    const int n = (int)cluster.num_blocks();
    const Share sh(hs, n, (int)cluster.block_rank(), blockIdx.y % per);
    const bool staged = per <= STAGES;
    const int h = blockIdx.y / per, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int q0 = blockIdx.x / n * TILE, row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE, items = 2 * ntiles * 2 * sh.cnt;

    auto fetch = [&](int it) {
        const Item item(it, sh.cnt);
        const int kt = item.tile % ntiles, d = sh.chunk(sh.index(item.k));
        const int dcols = chunk_cols(hs, d);
        if (!item.dp) {
            if (!staged)
                copy_rows(&q_s[item.slot][0][0], LDC<E>, CH, q_head + d * CH, stride, q0, T_len,
                          dcols, piece);
            copy_rows(&k_s[item.slot][0][0], LDC<E>, CH, q_head + C + d * CH, stride, kt * TILE,
                      T_len, dcols, piece);
        } else {
            if (!staged)
                copy_rows(&o_s[item.slot][0][0], LDC<E>, CH, o_head + d * CH, (size_t)C, q0,
                          T_len, dcols, piece);
            copy_rows(&v_s[item.slot][0][0], LDC<E>, CH, q_head + 2 * C + d * CH, stride,
                      kt * TILE, T_len, dcols, piece);
        }
    };
    if (staged)
        for (int i = 0; i < sh.cnt; ++i) {
            const int d = sh.chunk(i), dcols = chunk_cols(hs, d);
            copy_rows(&q_s[i][0][0], LDC<E>, CH, q_head + d * CH, stride, q0, T_len, dcols, piece);
            copy_rows(&o_s[i][0][0], LDC<E>, CH, o_head + d * CH, (size_t)C, q0, T_len, dcols,
                      piece);
        }
    fetch(0);
    cp_async_commit();

    float s[8][4], dp[8][4], dq[8][4];
    zero_acc(dq);
    // Each row's running maximum, sum and sum of p dp; after sweep 1, l and
    // dl hold 1 / l and D (fewer registers live through the products).
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        const Item item(it, sh.cnt);
        const int kt = item.tile % ntiles, i = sh.index(item.k), d = sh.chunk(i);
        const int own = staged ? i : item.slot;
        if (!staged) {
            if (!item.dp) scale_rows(&q_s[item.slot][0][0], LDC<E>, CH, scale, piece);
        } else if (it == 0) {
            for (int j = 0; j < sh.cnt; ++j) scale_rows(&q_s[j][0][0], LDC<E>, CH, scale, piece);
        }
        __syncthreads();

        if (!item.dp) {
            if (item.k == 0) zero_acc(s);
            chunk_scores(s, &q_s[own][0][0], LDC<E>, k_s[item.slot], chunk_cols(hs, d));
            if (item.k == sh.cnt - 1) put_partial(x, s);
        } else {
            if (item.k == 0) zero_acc(dp);
            chunk_scores(dp, &o_s[own][0][0], LDC<E>, v_s[item.slot], chunk_cols(hs, d));
        }
        if (item.dp && item.k == sh.cnt - 1) {  // the tile's partials are complete
            put_partial(x + 1, dp);
            cluster.sync();
            reduce_slice(x, x + 2, sh.n, sh.r);
            reduce_slice(x + 1, x + 3, sh.n, sh.r);
            cluster.sync();
            gather_sums(s, x + 2, sh.n);
            gather_sums(dp, x + 3, sh.n);
            mask_keys<8>(s, kt * TILE, T_len);
            if (item.tile < ntiles) {  // sweep 1
                float mx[2] = {m[0], m[1]};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
                }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = quad_max(mx[r]);
                    const float corr = exp2_approx((m[r] - mx[r]) * LOG2E);
                    m[r] = mx[r];
                    l[r] *= corr;
                    dl[r] *= corr;
                }
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -m[e >> 1] * LOG2E));
                        l[e >> 1] += p;
                        dl[e >> 1] = fmaf(p, dp[j][e], dl[e >> 1]);
                    }
                if (kt == ntiles - 1) {  // the rows' 1 / l and D, for sweep 2
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        l[r] = 1.f / quad_sum(l[r]);
                        dl[r] = quad_sum(dl[r]) * l[r];
                    }
                }
            } else if (sh.cols > 0) {  // sweep 2
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1;
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -m[r] * LOG2E)) * l[r];
                        s[j][e] = p * (dp[j][e] - dl[r]);  // ds
                    }
                chunk_pv(dq, s, k_s[item.last_score_slot], sh.cols);
            }
        }
        __syncthreads();
    }
    cluster.sync();  // no block leaves while a peer may still read its sums

    if (sh.cols > 0)
        store_acc<E, 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs + sh.c * CH, stride,
                        row, T_len, dq, sh.cols, hs & 1, scale, scale);
    if (sh.g == 0 && sh.r == 0 && t == 0) {
        const size_t plane = (size_t)gridDim.z * NH * T_len;
        float* st = stats + ((size_t)b * NH + h) * T_len;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = row + 8 * i;
            if (r >= T_len) continue;
            st[r] = m[i];
            st[plane + r] = l[i];
            st[2 * plane + r] = dl[i];
        }
    }
}

// Backward, kernel 2: a cluster per (batch, head and group, TILE keys).
// Each query tile's score items (qs's chunk, scaled as it arrives, and, if
// streamed, k's) and dp items (dout's and, streamed, v's; the tile's m, 1 /
// l and D with the last); at the last item the cluster adds the partial
// s^T and dp^T, and dv += p^T dout, dk += ds^T qs take dout's chunk c from
// that item's tile and qs's from the last score item's.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dkv_wide_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                  E* __restrict__ dqkv, const float* __restrict__ stats,
                                  int T_len, int C, int NH, int hs, int piece, int per,
                                  float scale) {
    extern __shared__ __align__(128) unsigned char smem_wide[];
    cgrp::cluster_group cluster = cgrp::this_cluster();
    XTile* x = reinterpret_cast<XTile*>(smem_wide);  // partial s^T, dp^T; their sums
    const ChunkRing<E> k_s = reinterpret_cast<ChunkRing<E>>(x + 4);
    const ChunkRing<E> v_s = k_s + STAGES, q_s = v_s + STAGES, o_s = q_s + STAGES;
    float (*st_s)[3][TILE] = reinterpret_cast<float (*)[3][TILE]>(o_s + STAGES);  // m, 1 / l, D
    const int n = (int)cluster.num_blocks();
    const Share sh(hs, n, (int)cluster.block_rank(), blockIdx.y % per);
    const bool staged = per <= STAGES;
    const int h = blockIdx.y / per, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int k0 = blockIdx.x / n * TILE, row = k0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE, items = ntiles * 2 * sh.cnt;

    auto fetch = [&](int it) {
        const Item item(it, sh.cnt);
        const int q0 = item.tile * TILE, d = sh.chunk(sh.index(item.k));
        const int dcols = chunk_cols(hs, d);
        if (!item.dp) {
            if (!staged)
                copy_rows(&k_s[item.slot][0][0], LDC<E>, CH, q_head + C + d * CH, stride, k0,
                          T_len, dcols, piece);
            copy_rows(&q_s[item.slot][0][0], LDC<E>, CH, q_head + d * CH, stride, q0, T_len,
                      dcols, piece);
        } else {
            if (!staged)
                copy_rows(&v_s[item.slot][0][0], LDC<E>, CH, q_head + 2 * C + d * CH, stride, k0,
                          T_len, dcols, piece);
            copy_rows(&o_s[item.slot][0][0], LDC<E>, CH, o_head + d * CH, (size_t)C, q0, T_len,
                      dcols, piece);
            if (item.k == sh.cnt - 1) {
                const size_t plane = (size_t)gridDim.z * NH * T_len;
                const float* st = stats + ((size_t)b * NH + h) * T_len;
                for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
                    const int kind = e / TILE, i = e % TILE;
                    const bool valid = q0 + i < T_len;
                    cp_async4(&st_s[item.slot][kind][i], st + kind * plane + (valid ? q0 + i : 0),
                              valid);
                }
            }
        }
    };
    if (staged)
        for (int i = 0; i < sh.cnt; ++i) {
            const int d = sh.chunk(i), dcols = chunk_cols(hs, d);
            copy_rows(&k_s[i][0][0], LDC<E>, CH, q_head + C + d * CH, stride, k0, T_len, dcols,
                      piece);
            copy_rows(&v_s[i][0][0], LDC<E>, CH, q_head + 2 * C + d * CH, stride, k0, T_len,
                      dcols, piece);
        }
    fetch(0);
    cp_async_commit();

    float s[8][4], dp[8][4], dk[8][4], dv[8][4];
    zero_acc(dk);
    zero_acc(dv);
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        const Item item(it, sh.cnt);
        const int q0 = item.tile * TILE, i = sh.index(item.k), d = sh.chunk(i);
        const int own = staged ? i : item.slot;
        // qs = round(q * scale), once per staged value: each thread scales
        // the pieces it copied itself; the barrier shows them to the block.
        if (!item.dp) scale_rows(&q_s[item.slot][0][0], LDC<E>, CH, scale, piece);
        __syncthreads();

        if (!item.dp) {
            if (item.k == 0) zero_acc(s);
            chunk_scores(s, &k_s[own][0][0], LDC<E>, q_s[item.slot], chunk_cols(hs, d));  // s^T
            if (item.k == sh.cnt - 1) put_partial(x, s);
        } else {
            if (item.k == 0) zero_acc(dp);
            chunk_scores(dp, &v_s[own][0][0], LDC<E>, o_s[item.slot], chunk_cols(hs, d));  // dp^T
        }
        if (item.dp && item.k == sh.cnt - 1) {  // the tile's partials are complete
            put_partial(x + 1, dp);
            cluster.sync();
            reduce_slice(x, x + 2, sh.n, sh.r);
            reduce_slice(x + 1, x + 3, sh.n, sh.r);
            cluster.sync();
            gather_sums(s, x + 2, sh.n);
            gather_sums(dp, x + 3, sh.n);
            if (sh.cols > 0) {
                const float (*st_t)[TILE] = st_s[item.slot];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int q = 8 * j + 2 * t;  // the tile's query columns q, q + 1
                    const float2 mm = *reinterpret_cast<const float2*>(&st_t[0][q]);
                    const float2 il = *reinterpret_cast<const float2*>(&st_t[1][q]);
                    const float2 dd2 = *reinterpret_cast<const float2*>(&st_t[2][q]);
                    const float mLq[2] = {mm.x * LOG2E, mm.y * LOG2E};
                    const float ilq[2] = {il.x, il.y}, Dq[2] = {dd2.x, dd2.y};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kk = e & 1;
                        const float p = q0 + q + kk < T_len
                                            ? exp2_approx(fmaf(s[j][e], LOG2E, -mLq[kk])) * ilq[kk]
                                            : 0.f;
                        dp[j][e] = p * (dp[j][e] - Dq[kk]);  // ds
                        s[j][e] = p;
                    }
                }
                chunk_pv(dv, s, o_s[item.slot], sh.cols);
                chunk_pv(dk, dp, q_s[item.last_score_slot], sh.cols);
            }
        }
        __syncthreads();
    }
    cluster.sync();  // no block leaves while a peer may still read its sums

    if (sh.cols > 0) {
        E* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs + sh.c * CH;
        store_acc<E, 8>(k_out, stride, row, T_len, dk, sh.cols, hs & 1, 1.f, 1.f);
        store_acc<E, 8>(k_out + C, stride, row, T_len, dv, sh.cols, hs & 1, 1.f, 1.f);
    }
}

// Dynamic shared memory of a wide kernel: `xtiles` exchange tiles, `rings`
// rings of STAGES chunk tiles (the own rows' among them, staged or
// streamed), and (dk/dv kernel) the query tiles' m, 1 / l and D.
template <typename E> constexpr int wide_smem_bytes(int xtiles, int rings, bool stats) {
    return xtiles * (int)sizeof(XTile) + rings * STAGES * TILE * LDC<E> * (int)sizeof(E) +
           (stats ? STAGES * 3 * TILE * (int)sizeof(float) : 0);
}
static_assert(wide_smem_bytes<float>(4, 4, true) <= 232448, "a block's shared memory");

// The cluster of a head of hs columns (ops/kernels/attention.py's
// `kernel_layout`): per = ceil(nd / MAX_CLUSTER) groups, each a cluster of
// n = ceil(nd / per) blocks.
struct WideLayout {
    int per, n;
};

inline WideLayout wide_layout(int hs) {
    const int nd = (hs + CH - 1) / CH, per = (nd + MAX_CLUSTER - 1) / MAX_CLUSTER;
    return {per, (nd + per - 1) / per};
}

// One launch of `kernel` on grid (tiles * n, NH * per, B) in clusters of
// (n, 1, 1), with `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_wide(void (*kernel)(Params...), int smem, WideLayout w, int T_len, int NH,
                        int B, cudaStream_t stream, Args... args) {
    const long long tiles = (T_len + TILE - 1) / TILE;
    if ((long long)NH * w.per > 65535 || tiles * w.n > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * w.n), (unsigned)(NH * w.per), (unsigned)B);
    cfg.blockDim = dim3(THREADS, 1, 1);
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

template <typename E>
int fwd_wide(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
             cudaStream_t stream) {
    const int hs = C / NH;
    const WideLayout w = wide_layout(hs);
    return (int)launch_wide(qkv_attention_fwd_wide_kernel<E>, wide_smem_bytes<E>(2, 3, false), w,
                            T_len, NH, B, stream, static_cast<const E*>(qkv), static_cast<E*>(out),
                            T_len, C, hs, piece_bytes(hs, sizeof(E)), w.per, scale);
}

template <typename E>
int bwd_wide(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int T_len, int C,
             int NH, float scale, cudaStream_t stream) {
    const int hs = C / NH, piece = piece_bytes(hs, sizeof(E));
    const WideLayout w = wide_layout(hs);
    const E* x = static_cast<const E*>(qkv);
    const E* dy = static_cast<const E*>(dout);
    E* dx = static_cast<E*>(dqkv);
    cudaError_t err = launch_wide(qkv_attention_bwd_dq_wide_kernel<E>,
                                  wide_smem_bytes<E>(4, 4, false), w, T_len, NH, B, stream, x, dy,
                                  dx, stats, T_len, C, NH, hs, piece, w.per, scale);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_wide(qkv_attention_bwd_dkv_wide_kernel<E>, wide_smem_bytes<E>(4, 4, true), w,
                            T_len, NH, B, stream, x, dy, dx, static_cast<const float*>(stats),
                            T_len, C, NH, hs, piece, w.per, scale);
}

}  // namespace

int attention_fwd_wide(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
                       int is_bf16, cudaStream_t stream) {
    return is_bf16 ? fwd_wide<bf16>(qkv, out, B, T_len, C, NH, scale, stream)
                   : fwd_wide<float>(qkv, out, B, T_len, C, NH, scale, stream);
}

int attention_bwd_wide(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                       int T_len, int C, int NH, float scale, int is_bf16, cudaStream_t stream) {
    return is_bf16 ? bwd_wide<bf16>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, stream)
                   : bwd_wide<float>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, stream);
}
