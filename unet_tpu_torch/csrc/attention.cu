// Non-causal multi-head attention straight from the packed QKV: forward and
// backward on the tensor cores, bfloat16 as bf16 products and float32 as
// three TF32 products each (3xTF32).
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
// only the benchmark's T = 1024 is bound by the tensor cores.  In float32
// (4-byte values) it is T/4 and 5T/14 against 49 (3xTF32's 165 TFLOP/s):
// device memory bounds T = 64, the operations T = 256 and up.
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
// products, summed in two k-steps of 16 in the same order (in float32: the
// three exact TF32 products of each of HS / 8 k-steps of 8, in the same
// order), but the PTX ISA does not promise that one k-step sums its
// products in an order that is independent of the operand they come from;
// so p in the two kernels is equal in value up to that order, and
// bit-equal only where the hardware makes it so.  Not measured; the
// tolerances do not depend on it.
//
// float32 design (the *_tf32_kernel kernels).  The JAX package's float32
// path is full float32 (Precision.HIGHEST), held to 2e-5: one TF32 product
// (a 10-bit mantissa) misses that by about 20x, three keep it (common.cuh):
// each operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a b
// is taken as a_hi b_lo + a_lo b_hi + a_hi b_hi by `mma.sync.m16n8k8` on
// TF32 operands with a float32 accumulator, which leaves out a_lo b_lo (at
// most 2^-22 of the product).  What is left is mostly the tensor core's own
// summation, which truncates: on the card the kernels are within 8e-6 of
// the plain versions at every shape chip_smoke.py checks (the FMA kernels
// they replace: 2.5e-6; an emulation with rounded float32 sums, 1.3e-6:
// tests/test_torch_tf32.py).  Three products at 495 TFLOP/s is 165, 2.5x
// the card's float32 FMAs.  Blocks, warps, rings and the online softmax are
// the bfloat16 kernels'.  The k-step is 8.  The warp's own rows stay floats
// in registers, split where they enter a product.  The other side passes
// through float32 tiles of 64 rows (HS + 4 floats a row, two rings of 68 KB
// of dynamic shared memory at HS = 64), split as it is read: by `ldmatrix`
// where the tile's rows are the product's n index (a float moves as two
// 16-bit halves), by 32-bit loads where they are its k index
// (`ldmatrix.trans` would cut floats in half).  The scores' accumulator
// holds columns 2t, 2t + 1 of its n-tile where the m16n8k8 A fragment holds
// k = t, t + 4, so the next product takes its k index in that order (k = t
// as row 2t, k = t + 4 as row 2t + 1) in A and B alike: p and ds become A
// fragments in registers with no shuffle.  At HS = 64 the backward kernels
// take a tile's scores half at a time (registers).
//
// Head sizes.  The JAX package takes any head size hs = C / NH; so do these
// kernels, by three designs.
//
// A head of up to 64 columns whose row is a multiple of 16 bytes (hs a
// multiple of 8 in bfloat16, of 4 in float32) takes the kernels here,
// templates on the tile width HS = 16, 32 or 64 (`with_head_size`): the
// first width at or above hs.  Its columns hs .. HS - 1 are zero in the
// staged tiles (the 16-byte copies fill them) and in the own rows'
// fragments, so they add exact zeros to every score; the outputs' columns
// past hs are never written.  In bfloat16, at HS = 16 a score's B fragment
// is one `ldmatrix.x2`; at 64 the products take four k-steps, and a tile
// row is 144 bytes (two 64-row tiles of k and v, 36 KB, stay static shared
// memory).
//
// Every other head (attention_chunked.cu: wider than 64, or a row of
// another length) is cut into nd = ceil(hs / 64) chunks of 64 columns
// (CH): kept in registers, the own rows and the outputs of a 256-wide head
// would take 255 registers a thread many times over.  One block per tile
// of rows holds nd groups of warps (a warpgroup on `wgmma` in bfloat16),
// group g the score products over chunk g and chunk g of the output; the
// groups add their partial scores in shared memory in group order, so each
// score is computed once (attention_chunked.cu's opening note).  Its
// copies take, once per launch, the widest piece of 16, 8, 4 or 2 bytes
// that every head's row starts on (the lowest set bit of hs * itemsize):
// 8- and 4-byte `cp.async`, or for an odd hs in bfloat16 plain 2-byte
// loads and stores; an odd hs stores its outputs one value at a time.
//
// A head wider than 256 columns (attention_wide.cu) is cut into the same
// chunks, and a thread-block cluster of up to MAX_CLUSTER such blocks
// shares a tile of rows: each block the score products over its run of
// chunks, its groups' partials summed in shared memory, then one partial a
// block added up through distributed shared memory in rank order (the
// cluster barrier split around the next stage's products), and each group
// its output chunk; up to 4 chunks a block in bfloat16 and 2 in float32,
// fewer where the launch would have fewer blocks than SMs; a head of more
// chunks than one cluster holds at one chunk a block in as many groups of
// clusters as that takes, each group recomputing the scores for its
// output chunks.

#include "attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.

// A shared tile row: HS values + 8 of padding (LD<HS> in all), so that the
// eight rows one `ldmatrix` phase reads start in eight different 16-byte
// bank groups (rows of 48, 80 and 144 bytes at HS = 16, 32, 64).
template <int HS> constexpr int LD = HS + 8;

// Keys and values [k0, k0 + TILE) of the head whose q starts at q_head, its
// hs columns in tiles HS wide.
template <int HS>
__device__ __forceinline__ void kv_tile_async(bf16 (*k_s)[LD<HS>], bf16 (*v_s)[LD<HS>],
                                              const bf16* q_head, int C, size_t stride, int k0,
                                              int T_len, int hs) {
    copy_rows_w<bf16, 16>(&k_s[0][0], LD<HS>, HS, q_head + C, stride, k0, T_len, hs);
    copy_rows_w<bf16, 16>(&v_s[0][0], LD<HS>, HS, q_head + 2 * C, stride, k0, T_len, hs);
}

// The A fragments of the warp's 16 rows (lane 4g + t: rows `row` = first +
// g and row + 8) over the head's hs columns, in HS / 16 k-steps of 16, read
// straight from device memory; rows at or past n and columns at or past hs
// are zero (hs is a multiple of 8).  With SCALE each value is multiplied by
// `scale` and rounded to bf16 (qs).
template <int HS, bool SCALE>
__device__ __forceinline__ void a_frags(uint32_t (&a)[HS / 16][4], const bf16* src,
                                        size_t stride, int row, int n, int hs, float scale) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
#pragma unroll
        for (int ks = 0; ks < HS / 16; ++ks) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int c = 16 * ks + 8 * half + 2 * t;
                uint32_t v = 0;
                if (r < n && c < hs) {
                    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                        src + (size_t)r * stride + c);
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

// Forward: one block per (batch, head, TILE queries).
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T_len,
                             int C, int hs, float scale) {
    __shared__ __align__(128) bf16 k_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 v_s[STAGES][TILE][LD<HS>];
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles)
            kv_tile_async<HS>(k_s[it], v_s[it], q_head, C, stride, it * TILE, T_len, hs);
        cp_async_commit();
    }

    uint32_t qf[HS / 16][4];
    a_frags<HS, true>(qf, q_head, stride, row, T_len, hs, scale);
    float o[HS / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, ahead = it + STAGES - 1;
        if (ahead < ntiles)
            kv_tile_async<HS>(k_s[ahead % STAGES], v_s[ahead % STAGES], q_head, C, stride,
                              ahead * TILE, T_len, hs);
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

    store_acc<bf16, HS / 8>(out + (size_t)b * T_len * C + (size_t)h * hs, C, row, T_len, o, hs,
                            false, 1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// Backward, kernel 1: one block per (batch, head, TILE queries).  Two
// sweeps over the key tiles, one pipeline: the first takes each row's m, l
// and D = sum p dp / l online, the second recomputes p and ds and
// accumulates dq.  Writes dq and the rows' m, 1 / l and D.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dq_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                bf16* __restrict__ dqkv, float* __restrict__ stats, int T_len,
                                int C, int NH, int hs, float scale) {
    __shared__ __align__(128) bf16 k_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 v_s[STAGES][TILE][LD<HS>];
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const bf16* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {  // iteration it sweeps tile it % ntiles
        if (it < 2 * ntiles)
            kv_tile_async<HS>(k_s[it], v_s[it], q_head, C, stride, it % ntiles * TILE, T_len, hs);
        cp_async_commit();
    }

    uint32_t qf[HS / 16][4], of[HS / 16][4];
    a_frags<HS, true>(qf, q_head, stride, row, T_len, hs, scale);
    a_frags<HS, false>(of, o_head, C, row, T_len, hs, 0.f);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2], inv_l[2], D[2];
    float dq[HS / 8][4] = {};

    for (int it = 0; it < 2 * ntiles; ++it) {
        const int buf = it % STAGES, tile = it % ntiles, ahead = it + STAGES - 1;
        if (ahead < 2 * ntiles)
            kv_tile_async<HS>(k_s[ahead % STAGES], v_s[ahead % STAGES], q_head, C, stride,
                              ahead % ntiles * TILE, T_len, hs);
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

    store_acc<bf16, HS / 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs, stride, row,
                            T_len, dq, hs, false, scale, scale);
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
                                             int C, size_t plane, int q0, int T_len, int hs) {
    copy_rows_w<bf16, 16>(&q_s[0][0], LD<HS>, HS, q_head, stride, q0, T_len, hs);
    copy_rows_w<bf16, 16>(&o_s[0][0], LD<HS>, HS, o_head, (size_t)C, q0, T_len, hs);
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
                                 int T_len, int C, int NH, int hs, float scale) {
    __shared__ __align__(128) bf16 q_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(128) bf16 o_s[STAGES][TILE][LD<HS>];
    __shared__ __align__(16) float st_s[STAGES][3][TILE];  // m, 1 / l, D of the tile's queries
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const bf16* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const bf16* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles)
            q_tile_async<HS>(q_s[it], o_s[it], st_s[it], q_head, o_head, st, stride, C, plane,
                             it * TILE, T_len, hs);
        cp_async_commit();
    }

    uint32_t kf[HS / 16][4], vf[HS / 16][4];
    a_frags<HS, false>(kf, q_head + C, stride, row, T_len, hs, 0.f);
    a_frags<HS, false>(vf, q_head + 2 * C, stride, row, T_len, hs, 0.f);
    float dk[HS / 8][4] = {}, dv[HS / 8][4] = {};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, q0 = it * TILE, ahead = it + STAGES - 1;
        if (ahead < ntiles)
            q_tile_async<HS>(q_s[ahead % STAGES], o_s[ahead % STAGES], st_s[ahead % STAGES],
                             q_head, o_head, st, stride, C, plane, ahead * TILE, T_len, hs);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        // qs = round(q * scale), once per staged value: each thread scales
        // the pieces it copied itself, which the wait made visible to it;
        // the barrier then shows them to the block.
        scale_rows_w<bf16, 16>(&q_s[buf][0][0], LD<HS>, HS, scale);
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

    bf16* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs;
    store_acc<bf16, HS / 8>(k_out, stride, row, T_len, dk, hs, false, 1.f, 1.f);
    store_acc<bf16, HS / 8>(k_out + C, stride, row, T_len, dv, hs, false, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores, in 3xTF32 (common.cuh: `split_tf32`,
// `mma_3xtf32`).  The blocks, warps, rings and the online softmax are the
// bfloat16 kernels'; what differs is the k-step of 8, the float32 tiles,
// and that each operand is split into a TF32 pair where it enters a product.

// A float32 tile row: HS values + 4 of padding (LDF<HS> in all).  A row is
// 16 bytes past a multiple of 128 at HS = 32 and 64 (80 bytes at HS = 16),
// so the eight rows one `ldmatrix` phase reads start in eight different
// 16-byte bank groups; and rows two apart are 8 banks apart, so the reads
// of `cols_step_f32` (lane 4g + t: rows 2t and 2t + 1, column g) fall in
// banks 8t + g.  Both without conflicts.
template <int HS> constexpr int LDF = HS + 4;

// Dynamic shared memory: the two rings of tiles (k and v, or qs and dout)
// and, in the dk/dv kernel, the query tiles' m, 1 / l and D.  At HS = 64 the
// rings alone are 68 KB, past the 48 KB a launch gets without asking.
template <int HS>
constexpr int F32_RING_BYTES = 2 * STAGES * TILE * LDF<HS> * (int)sizeof(float);
template <int HS>
constexpr int F32_DKV_BYTES = F32_RING_BYTES<HS> + STAGES * 3 * TILE * (int)sizeof(float);

// The backward kernels take a tile's scores in groups of GROUP<HS> n-tiles
// of 8: at HS = 64 half a tile, so that the dk/dv kernel's four row vectors
// (k, v, dk, dv: 128 registers a thread) and the group's s and dp fit.
template <int HS> constexpr int GROUP = HS < 64 ? 8 : 4;

// Copies rows [r0, r0 + TILE) of one head's hs columns (row r at src + r *
// stride; hs a multiple of 4) into a float32 tile HS wide; rows at or past
// n and columns at or past hs are zero-filled.
template <int HS>
__device__ __forceinline__ void tile_async_f32(float (*dst)[LDF<HS>], const float* src,
                                               size_t stride, int r0, int n, int hs) {
    copy_rows_w<float, 16>(&dst[0][0], LDF<HS>, HS, src, stride, r0, n, hs);
}

// The A fragments of the warp's 16 rows (lane 4g + t: rows `row` = first +
// g and row + 8) over the head's hs columns, in HS / 8 k-steps of 8, as
// floats times `mul`, read straight from device memory; rows at or past n
// and columns at or past hs are zero.  Each k-step is split into its TF32
// pair where it is used.
template <int HS>
__device__ __forceinline__ void a_frags_f32(float (&a)[HS / 8][4], const float* src,
                                            size_t stride, int row, int n, int hs, float mul) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        const float* p = src + (size_t)(r < n ? r : 0) * stride + t;
#pragma unroll
        for (int ks = 0; ks < HS / 8; ++ks)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int c = 8 * ks + 4 * half;
                a[ks][i + 2 * half] = r < n && c + t < hs ? p[c] * mul : 0.f;
            }
    }
}

// The warp's own k-step a, split into its TF32 pair.  The values do not
// change from tile to tile, so the compiler would hoist the split out of the
// loop over the tiles and keep the pairs of all HS / 8 k-steps in registers:
// at HS = 64 the backward kernels spilled, and at every head size the
// forward was slower (PERF.md, the float32 attention findings).  An empty
// `asm volatile` on each value keeps its split in the loop.
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        float x = a[e];
        asm volatile("" : "+f"(x));
        split_tf32(x, hi[e], lo[e]);
    }
}

// acc[j] = a b_{j0 + j}^T for NJ n-tiles of a 64-row tile whose rows are the
// product's n index (b_j: rows 8j .. 8j + 7): scores from k or qs, dp from v
// or dout.  Each k-step of a is split once; one `ldmatrix.x4` gives the B
// fragments of two n-tiles (on rows of floats it hands lane 4g + t the
// float at column t of row g of each 8 x 4 matrix: a float is two adjacent
// 16-bit halves).  The HS / 8 k-steps are summed in order.
template <int HS, int NJ>
__device__ __forceinline__ void rows_product_f32(float (&acc)[NJ][4], const float (&a)[HS / 8][4],
                                                 const float (*tile)[LDF<HS>], int j0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HS / 8; ++ks) {
        uint32_t ah[4], al[4];
        split_a(a[ks], ah, al);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            uint32_t b[4];
            ldsm_x4(b, &tile[8 * (j0 + j) + (lane & 7) + (lane >> 4) * 8]
                            [8 * ks + ((lane >> 3) & 1) * 4]);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                uint32_t bh[2], bl[2];
                split_tf32(__uint_as_float(b[2 * jj]), bh[0], bl[0]);
                split_tf32(__uint_as_float(b[2 * jj + 1]), bh[1], bl[1]);
                mma_3xtf32(acc[j + jj], ah, al, bh, bl);
            }
        }
    }
}

// acc += c tile[8kk .. 8kk + 7] for one k-step of 8 tile rows, where c is
// the accumulator fragment of n-tile kk of the product before (p or ds;
// lane 4g + t: rows g, g + 8, columns 2t, 2t + 1) and the tile's rows are
// this product's k index: out += p v, dq += ds k, dv += p^T dout, dk += ds^T
// qs.  The k index is taken in the order the fragment holds it, k = t as
// tile row 8kk + 2t and k = t + 4 as row 8kk + 2t + 1, in A (c0, c2 and c1,
// c3) and in B alike: c becomes the A fragment with no shuffle.  B is read
// with plain 32-bit loads (`ldmatrix.trans` moves 16-bit elements only).
template <int HS>
__device__ __forceinline__ void cols_step_f32(float (&acc)[HS / 8][4], const float (&c)[4],
                                              const float (*tile)[LDF<HS>], int kk) {
    const int lane = threadIdx.x & 31;
    uint32_t ah[4], al[4];
    split_tf32(c[0], ah[0], al[0]);
    split_tf32(c[2], ah[1], al[1]);
    split_tf32(c[1], ah[2], al[2]);
    split_tf32(c[3], ah[3], al[3]);
    const float* r = &tile[8 * kk + 2 * (lane & 3)][lane >> 2];
#pragma unroll
    for (int n = 0; n < HS / 8; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(r[8 * n], bh[0], bl[0]);
        split_tf32(r[LDF<HS> + 8 * n], bh[1], bl[1]);
        mma_3xtf32(acc[n], ah, al, bh, bl);
    }
}

// The two rings of float32 tiles in dynamic shared memory.
template <int HS> using F32Ring = float (*)[TILE][LDF<HS>];

// Forward: one block per (batch, head, TILE queries), as the bfloat16
// kernel, with p kept in float32 and split before p v.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_fwd_tf32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T_len,
                              int C, int hs, float scale) {
    extern __shared__ __align__(128) float smem_f32[];
    const F32Ring<HS> k_s = reinterpret_cast<F32Ring<HS>>(smem_f32);
    const F32Ring<HS> v_s = k_s + STAGES;
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const float* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles) {
            tile_async_f32<HS>(k_s[it], q_head + C, stride, it * TILE, T_len, hs);
            tile_async_f32<HS>(v_s[it], q_head + 2 * C, stride, it * TILE, T_len, hs);
        }
        cp_async_commit();
    }

    float qf[HS / 8][4];
    a_frags_f32<HS>(qf, q_head, stride, row, T_len, hs, scale);
    float o[HS / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, ahead = it + STAGES - 1;
        if (ahead < ntiles) {
            tile_async_f32<HS>(k_s[ahead % STAGES], q_head + C, stride, ahead * TILE, T_len, hs);
            tile_async_f32<HS>(v_s[ahead % STAGES], q_head + 2 * C, stride, ahead * TILE, T_len, hs);
        }
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncthreads();

        float s[8][4];
        rows_product_f32<HS, 8>(s, qf, k_s[buf], 0);
        mask_keys<8>(s, it * TILE, T_len);
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
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));  // p
                l[e >> 1] += s[j][e];
            }
            cols_step_f32<HS>(o, s[j], v_s[buf], j);
        }
        __syncthreads();  // the tile has been consumed before it is refilled
    }

    store_acc<float, HS / 8>(out + (size_t)b * T_len * C + (size_t)h * hs, C, row, T_len, o, hs,
                             false, 1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// Backward, kernel 1: one block per (batch, head, TILE queries), as the
// bfloat16 kernel (two sweeps over the key tiles, one pipeline), each tile
// taken in groups of GROUP<HS> n-tiles: the first sweep takes each row's m,
// l and D = sum p dp / l online, group by group; the second recomputes p and
// ds = p (dp - D) in float32 and accumulates dq.  Writes dq and the rows'
// m, 1 / l and D.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dq_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                 float* __restrict__ dqkv, float* __restrict__ stats, int T_len,
                                 int C, int NH, int hs, float scale) {
    constexpr int G = GROUP<HS>;
    extern __shared__ __align__(128) float smem_f32[];
    const F32Ring<HS> k_s = reinterpret_cast<F32Ring<HS>>(smem_f32);
    const F32Ring<HS> v_s = k_s + STAGES;
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const float* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const float* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE;

    for (int it = 0; it < STAGES - 1; ++it) {  // iteration it sweeps tile it % ntiles
        if (it < 2 * ntiles) {
            tile_async_f32<HS>(k_s[it], q_head + C, stride, it % ntiles * TILE, T_len, hs);
            tile_async_f32<HS>(v_s[it], q_head + 2 * C, stride, it % ntiles * TILE, T_len, hs);
        }
        cp_async_commit();
    }

    float qf[HS / 8][4], of[HS / 8][4];
    a_frags_f32<HS>(qf, q_head, stride, row, T_len, hs, scale);
    a_frags_f32<HS>(of, o_head, C, row, T_len, hs, 1.f);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2], inv_l[2], D[2];
    float dq[HS / 8][4] = {};

    for (int it = 0; it < 2 * ntiles; ++it) {
        const int buf = it % STAGES, tile = it % ntiles, ahead = it + STAGES - 1;
        if (ahead < 2 * ntiles) {
            const int k0 = ahead % ntiles * TILE;
            tile_async_f32<HS>(k_s[ahead % STAGES], q_head + C, stride, k0, T_len, hs);
            tile_async_f32<HS>(v_s[ahead % STAGES], q_head + 2 * C, stride, k0, T_len, hs);
        }
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncthreads();

#pragma unroll 1
        for (int j0 = 0; j0 < 8; j0 += G) {
            float s[G][4], dp[G][4];
            rows_product_f32<HS, G>(s, qf, k_s[buf], j0);
            rows_product_f32<HS, G>(dp, of, v_s[buf], j0);
            mask_keys<G>(s, tile * TILE + 8 * j0, T_len);
            if (it < ntiles) {  // sweep 1
                float mx[2] = {m[0], m[1]};
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    // finite once key 0 has been seen: a group wholly past
                    // T_len keeps m, and its corr is 1
                    mx[i] = quad_max(mx[i]);
                    const float corr = exp2_approx((m[i] - mx[i]) * LOG2E);
                    m[i] = mx[i];
                    mL[i] = mx[i] * LOG2E;
                    l[i] *= corr;
                    dl[i] *= corr;
                }
#pragma unroll
                for (int j = 0; j < G; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));
                        l[e >> 1] += p;
                        dl[e >> 1] = fmaf(p, dp[j][e], dl[e >> 1]);
                    }
            } else {  // sweep 2
#pragma unroll
                for (int j = 0; j < G; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e >> 1;
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[i])) * inv_l[i];
                        s[j][e] = p * (dp[j][e] - D[i]);  // ds
                    }
                    cols_step_f32<HS>(dq, s[j], k_s[buf], j0 + j);
                }
            }
        }
        if (it == ntiles - 1) {  // the rows' statistics, for sweep 2
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                inv_l[i] = 1.f / quad_sum(l[i]);
                D[i] = quad_sum(dl[i]) * inv_l[i];
            }
        }
        __syncthreads();
    }

    store_acc<float, HS / 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs, stride, row,
                             T_len, dq, hs, false, scale, scale);
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

// Backward, kernel 2: one block per (batch, head, TILE keys), as the
// bfloat16 kernel (a sweep over the query tiles, keys as the mma's rows),
// each tile taken in groups of GROUP<HS> n-tiles of queries: s^T and dp^T
// for the group, then for each n-tile p^T and ds^T in float32 and their
// products dv += p^T dout, dk += ds^T qs.
template <int HS>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dkv_tf32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                  float* __restrict__ dqkv, const float* __restrict__ stats,
                                  int T_len, int C, int NH, int hs, float scale) {
    constexpr int G = GROUP<HS>;
    extern __shared__ __align__(128) float smem_f32[];
    const F32Ring<HS> q_s = reinterpret_cast<F32Ring<HS>>(smem_f32);
    const F32Ring<HS> o_s = q_s + STAGES;
    float (*st_s)[3][TILE] = reinterpret_cast<float (*)[3][TILE]>(o_s + STAGES);  // m, 1 / l, D
    const int h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = blockIdx.x * TILE + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const float* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const float* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int ntiles = (T_len + TILE - 1) / TILE;

    // Query tile [q0, q0 + TILE): q, dout and the rows' m, 1 / l and D; rows
    // at or past T_len zero-filled.
    auto stage = [&](int buf, int q0) {
        tile_async_f32<HS>(q_s[buf], q_head, stride, q0, T_len, hs);
        tile_async_f32<HS>(o_s[buf], o_head, C, q0, T_len, hs);
        for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
            const int k = e / TILE, i = e % TILE;
            const bool valid = q0 + i < T_len;
            cp_async4(&st_s[buf][k][i], st + k * plane + (valid ? q0 + i : 0), valid);
        }
    };
    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < ntiles) stage(it, it * TILE);
        cp_async_commit();
    }

    float kf[HS / 8][4], vf[HS / 8][4];
    a_frags_f32<HS>(kf, q_head + C, stride, row, T_len, hs, 1.f);
    a_frags_f32<HS>(vf, q_head + 2 * C, stride, row, T_len, hs, 1.f);
    float dk[HS / 8][4] = {}, dv[HS / 8][4] = {};

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it % STAGES, q0 = it * TILE, ahead = it + STAGES - 1;
        if (ahead < ntiles) stage(ahead % STAGES, ahead * TILE);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        // qs = q * scale, once per staged value: each thread scales the
        // pieces it copied itself, which the wait made visible to it; the
        // barrier then shows them to the block.
        scale_rows_w<float, 16>(&q_s[buf][0][0], LDF<HS>, HS, scale);
        __syncthreads();

#pragma unroll 1
        for (int j0 = 0; j0 < 8; j0 += G) {
            float s[G][4], dp[G][4];
            rows_product_f32<HS, G>(s, kf, q_s[buf], j0);
            rows_product_f32<HS, G>(dp, vf, o_s[buf], j0);
#pragma unroll
            for (int j = 0; j < G; ++j) {
                const int c = 8 * (j0 + j) + 2 * t;  // the tile's query columns c, c + 1
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
                cols_step_f32<HS>(dv, p, o_s[buf], j0 + j);
                cols_step_f32<HS>(dk, ds, q_s[buf], j0 + j);
            }
        }
        __syncthreads();
    }

    float* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs;
    store_acc<float, HS / 8>(k_out, stride, row, T_len, dk, hs, false, 1.f, 1.f);
    store_acc<float, HS / 8>(k_out + C, stride, row, T_len, dv, hs, false, 1.f, 1.f);
}

// Calls f(std::integral_constant<int, HS>()) for the width HS of the
// kernels above that takes a head of hs <= NARROW_MAX columns: the first of
// their instantiations at or above hs (ops/kernels/attention.py's
// HEAD_SIZES), each a multiple of the mma's k-step of 16.
template <class F>
int with_head_size(int hs, F&& f) {
    if (hs <= 16) return f(std::integral_constant<int, 16>());
    if (hs <= 32) return f(std::integral_constant<int, 32>());
    if (hs <= 64) return f(std::integral_constant<int, 64>());
    return (int)cudaErrorInvalidValue;
}

// Heads of up to CH * MAX_CHUNKS the kernels above do not take: wider than
// NARROW_MAX, or a row that is no multiple of 16 bytes (their copies'
// piece).
bool chunked(int hs, int is_bf16) {
    return hs > NARROW_MAX || hs * (is_bf16 ? 2 : 4) % 16 != 0;
}

bool bad_shape(int B, int T_len, int C, int NH) {
    return B <= 0 || T_len <= 0 || NH <= 0 || C % NH != 0 || B > 65535 || NH > 65535;
}

}  // namespace

// qkv: (B, T, 3C) contiguous, out: (B, T, C) contiguous, both 16-byte
// aligned, C == NH * hs with hs >= 1 (up to 64 columns of a multiple of 16
// bytes the kernels of width `with_head_size`, any other head of up to 256
// the chunked ones, a wider head the
// cluster kernels, NH times the groups at most 65535), B and NH at most
// 65535; scale is 1 / sqrt(hs), given by the caller so that it is the same
// float the plain version multiplies by.  Returns the CUDA error code of
// the launch (0 = success).
extern "C" int unet_qkv_attention_fwd(const void* qkv, void* out, int B, int T_len, int C,
                                      int NH, float scale, int is_bf16, cudaStream_t stream) {
    if (bad_shape(B, T_len, C, NH)) return (int)cudaErrorInvalidValue;
    const int hs = C / NH;
    if (hs > CH * MAX_CHUNKS)
        return attention_fwd_wide(qkv, out, B, T_len, C, NH, scale, is_bf16, stream);
    if (chunked(hs, is_bf16))
        return attention_fwd_chunked(qkv, out, B, T_len, C, NH, scale, is_bf16, stream);
    return with_head_size(hs, [&](auto width) {
        constexpr int HS = decltype(width)::value;
        if (is_bf16) {
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            qkv_attention_fwd_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T_len, C, hs, scale);
        } else {
            const cudaError_t err =
                allow_smem(qkv_attention_fwd_tf32_kernel<HS>, F32_RING_BYTES<HS>);
            if (err != cudaSuccess) return (int)err;
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            qkv_attention_fwd_tf32_kernel<HS><<<grid, THREADS, F32_RING_BYTES<HS>, stream>>>(
                static_cast<const float*>(qkv), static_cast<float*>(out), T_len, C, hs, scale);
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
    const int hs = C / NH;
    if (hs > CH * MAX_CHUNKS)
        return attention_bwd_wide(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, is_bf16,
                                  stream);
    if (chunked(hs, is_bf16))
        return attention_bwd_chunked(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, is_bf16,
                                     stream);
    return with_head_size(hs, [&](auto width) {
        constexpr int HS = decltype(width)::value;
        cudaError_t err;
        if (is_bf16) {
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            const bf16* x = static_cast<const bf16*>(qkv);
            const bf16* dy = static_cast<const bf16*>(dout);
            bf16* dx = static_cast<bf16*>(dqkv);
            qkv_attention_bwd_dq_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, hs, scale);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            qkv_attention_bwd_dkv_mma_kernel<HS><<<grid, THREADS, 0, stream>>>(
                x, dy, dx, stats, T_len, C, NH, hs, scale);
        } else {
            const float* x = static_cast<const float*>(qkv);
            const float* dy = static_cast<const float*>(dout);
            float* dx = static_cast<float*>(dqkv);
            if ((err = allow_smem(qkv_attention_bwd_dq_tf32_kernel<HS>, F32_RING_BYTES<HS>)) !=
                    cudaSuccess ||
                (err = allow_smem(qkv_attention_bwd_dkv_tf32_kernel<HS>, F32_DKV_BYTES<HS>)) !=
                    cudaSuccess)
                return (int)err;
            const dim3 grid((T_len + TILE - 1) / TILE, NH, B);
            qkv_attention_bwd_dq_tf32_kernel<HS><<<grid, THREADS, F32_RING_BYTES<HS>, stream>>>(
                x, dy, dx, stats, T_len, C, NH, hs, scale);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
            qkv_attention_bwd_dkv_tf32_kernel<HS><<<grid, THREADS, F32_DKV_BYTES<HS>, stream>>>(
                x, dy, dx, stats, T_len, C, NH, hs, scale);
        }
        return (int)cudaGetLastError();
    });
}
