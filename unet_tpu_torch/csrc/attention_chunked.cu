// Attention forward and backward for the heads of up to 256 columns (CH *
// MAX_CHUNKS) that attention.cu's kernels do not take: wider than 64
// columns, or a row that is no multiple of 16 bytes (a bfloat16 head of 7,
// 12 or 36 columns).  The same two TPU kernels as attention.cu
// (`_fwd_kernel` and `_bwd_kernel` of unet_tpu/ops/pallas/attention.py, :41
// and :61), the same rounding points and the same two-kernel backward (dq
// and the rows' m, 1 / l and D; then dk and dv).
//
// Bound on an H100: as attention.cu says, device memory at the U-Net's T =
// 64 and 256 in bfloat16, the operations from T = 256 in float32 (3xTF32 at
// 165 TFLOP/s).  At DDPM CIFAR-10's (128, 256, 256, 1): forward 0.0200 ms
// bf16 (bytes), 0.0521 f32 (operations); backward 0.0350 bf16 (bytes),
// 0.1301 f32 (operations).  So the scores may be computed once: each
// repeat is work the bound has no room for.
//
// Design.  The head is cut into nd = ceil(hs / 64) chunks of CH columns.
// One block per (tile of ROWS own rows, head, batch element): grid (tiles,
// NH, B), nd groups of warps a block, group g the chunk g.  Group g takes
// the score product over its chunk only (own rows' chunk g against the
// other side's chunk g: a ROWS x KEYS partial of s, and of dp in the
// backward); the nd partials are added in shared memory in group order
// (`put_part`, `sum_part`, `get_part`), with the block's barrier
// (`__syncthreads`, bar.sync 0 over all 128 nd or 64 nd threads) where
// attention_wide.cu has cluster barriers: each warp's 16 rows are summed
// and put through the online softmax once, by that warp of one group
// (`reduces`), which hands p (or ds), and the rows' corrections, back
// through shared memory; every group gets the same bits, on every rerun,
// with no atomics.  Each group then takes its own output chunk: out += p
// v[:, g] in the forward, dq[:, g] += ds k[:, g] in the dq kernel's second
// sweep, dk[:, g] and dv[:, g] in the dk/dv kernel.  So each score is
// computed once (`work_ratio` 1.0 up to the k-step of a ragged last
// chunk).
//
//   bfloat16: ROWS = 64, a group is a warpgroup (128 threads, nd of them a
//   block: 512 at 256 columns, 128 registers a thread).  Both products on
//   `wgmma`: the scores m64n32k16 with A (own rows) and B (the other side)
//   K-major in shared memory; the output m64nNk16, N the chunk's columns
//   rounded up to 16, with A = p (or ds) from registers, packed straight
//   from the scores' accumulator (the m64 accumulator and the A fragment
//   share their layout, as `mma.sync`'s do), and B N-major (`wgmma`'s
//   transposed B, as conv3x3.cu's W tile).  Tiles are 64 columns = 128
//   bytes a row in conv3x3.cu's 128-byte swizzle (`swizzled`,
//   `wgmma_desc`), 1024-byte aligned.
//
//   float32: ROWS = 32, a group is two warps (64 threads, 256 a block at
//   256 columns: 255 registers a thread, which the 3xTF32 fragments need;
//   64 rows would put 512 threads on 128 registers, or halve the ring).
//   Products on `mma.sync.m16n8k8` in 3xTF32 as in attention.cu (the 2e-5
//   bar); tiles of 64 floats = 256 bytes a row with the same XOR of the
//   16-byte piece by row % 8 (no padding), read by `ldmatrix` where the
//   tile's rows are the product's n index and by 32-bit loads otherwise,
//   without bank conflicts.
//
// The other side (k and v; or qs and dout in the dk/dv kernel) streams in
// stages of KEYS rows of the whole head (nd chunk tiles each) through a
// ring of STAGES = 2: at the top of each step the thread waits for its
// copies of this stage, the block's barrier makes the stage visible (and
// says every group is done with the stage before it), and the copies of
// the next stage go out into the freed slot.  The own rows (qs; qs and
// dout; k and v) are staged once, whole.  qs is scaled and rounded
// once, by the thread that copied each piece, after its wait.  Copies are
// `cp.async` straight into the swizzled layout in the widest piece of 16,
// 8, 4 or 2 bytes that every head's row starts on (`piece_bytes`; 2-byte
// pieces are plain loads and stores), a piece past the head or past T
// zero-filled; `fence.proxy.async` before the barrier shows them to
// `wgmma`.
//
// Shared memory (`chunked_smem_bytes`; tests/test_torch_head_sizes.py reads
// these constants): sides x (nd own tiles + a partial a group) + 2 rings x
// STAGES x nd stage tiles + 1024 of alignment, sides = 1 forward, 2
// backward, and the dk/dv kernel's STAGES x 3 x KEYS floats of m, 1 / l, D
// (the forward's 2 x ROWS floats of the rows' corrections and 1 / l).  A
// chunk tile of own rows is ROWS x 64 values (8 KB in both types), a stage
// tile KEYS x 64 (4 KB bf16, 8 KB f32), a partial ROWS x KEYS floats (8 KB
// bf16, 4 KB f32).  At nd = 4: bfloat16 forward 132,608 bytes, dq kernel
// 197,632, dk/dv kernel 165,632 (two groups); float32 181,504, 230,400 and
// 231,168, within the 232,448 a block may have.
//
// Registers: 512 threads of bfloat16 at four chunks leave 128 a thread,
// which hold the forward's and the dq kernel's accumulators but not the
// dk/dv kernel's dk, dv, s^T and dp^T: there a block is two warpgroups of
// two chunks each (`dkv_chunks`, DKV_THREADS).

#include <type_traits>

#include "attention.cuh"

namespace {

// Dynamic shared memory of a chunked kernel (see the opening note).
template <typename T>
constexpr int chunked_smem_bytes(int nd, int groups, int sides, bool stats) {
    return ALIGN + sides * (nd * T::OWN + groups * T::PART) + 2 * STAGES * nd * T::STAGE +
           (stats ? STAGES * 3 * T::KEYS : sides == 1 ? 2 * T::ROWS : 0) * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// The exchange of the groups' partials, between two barriers of the block.
// A partial is the group's ROWS x KEYS floats in the warps' accumulator
// order (float4 v[j][gt]: a thread's acc[j][0..3]), so neighbouring threads
// touch neighbouring 16 bytes.  Each group puts its partial in its slot;
// after a barrier the rows of warp w (the same rows in every group) are
// summed, in group order, by warp w of group w % G (`reduces`), each thread
// at its own places, which then takes the softmax of those rows and puts
// its result (p, or ds) in slot 0 at the same places; after a second
// barrier every group reads it.  So each score is summed and exponentiated
// once, every group gets the same bits, and no atomics are needed.

// Whether the calling warp (warp w of group g) sums and exponentiates its
// rows for the block's G groups.
__device__ __forceinline__ bool reduces(int g, int gt, int groups) { return gt / 32 % groups == g; }

// acc into slot `slot`.
template <typename T>
__device__ __forceinline__ void put_part(float* x, int slot, int gt,
                                         const float (&acc)[T::NJ][4]) {
    float4* mine = reinterpret_cast<float4*>(x) + slot * T::XV;
#pragma unroll
    for (int j = 0; j < T::NJ; ++j)
        mine[j * T::GT + gt] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// acc = the sum of the G slots at the calling thread's places, in slot order.
template <typename T, int G>
__device__ __forceinline__ void sum_part(const float* x, int gt, float (&acc)[T::NJ][4]) {
    const float4* v = reinterpret_cast<const float4*>(x);
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
        float4 a = v[j * T::GT + gt];
#pragma unroll
        for (int q = 1; q < G; ++q) {
            const float4 b = v[q * T::XV + j * T::GT + gt];
            a.x += b.x;
            a.y += b.y;
            a.z += b.z;
            a.w += b.w;
        }
        acc[j][0] = a.x;
        acc[j][1] = a.y;
        acc[j][2] = a.z;
        acc[j][3] = a.w;
    }
}

// acc = slot 0 at the calling thread's places.
template <typename T>
__device__ __forceinline__ void get_part(const float* x, int gt, float (&acc)[T::NJ][4]) {
    sum_part<T, 1>(x, gt, acc);
}

// ---------------------------------------------------------------------------
// The kernels.  In each: g the thread's group (its chunk), gt its thread in
// the group, its rows `row` and row + 8 of the block's ROWS (lane 4g' + t of
// warp w of the group: w * 16 + g').

// Forward: a block per (ROWS queries, head, batch element).  Step kt takes
// key tile kt (KEYS keys): the scores' partials, their sum, the online
// softmax, and out[:, chunk g] += p v[:, chunk g].
template <typename E, int ND>
__global__ void __launch_bounds__(ND * Tiles<E>::GT)
qkv_attention_fwd_chunked_kernel(const E* __restrict__ qkv, E* __restrict__ out, int T_len, int C,
                                 int hs, int piece, float scale) {
    using T = Tiles<E>;
    constexpr int NT = ND * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_chunked[];
    unsigned char* q_s = aligned_smem(smem_chunked);  // ND own tiles
    unsigned char* k_s = q_s + ND * T::OWN;           // [STAGES][ND] stage tiles
    unsigned char* v_s = k_s + STAGES * ND * T::STAGE;
    float* x_s = reinterpret_cast<float*>(v_s + STAGES * ND * T::STAGE);  // ND partials
    float* r_s = x_s + ND * T::PART / 4;  // the rows' corrections, then 1 / l
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int r0 = gt / 32 * 16 + (lane >> 2);  // the thread's rows r0, r0 + 8 of the tile
    const int q0 = blockIdx.x * T::ROWS, row = q0 + r0;
    const bool mine = reduces(g, gt, ND);
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + T::KEYS - 1) / T::KEYS;
    const int cols = min(CH, hs - g * CH);  // the group's chunk's columns

    auto fetch = [&](int kt) {
        const int at = kt % STAGES * ND * T::STAGE;
        tiles<E, ND, T::KEYS, NT>(k_s + at, q_head + C, stride, kt * T::KEYS, T_len, hs, piece);
        tiles<E, ND, T::KEYS, NT>(v_s + at, q_head + 2 * C, stride, kt * T::KEYS, T_len, hs,
                                  piece);
    };
    tiles<E, ND, T::ROWS, NT>(q_s, q_head, stride, q0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], o[8][4];
    zero_acc(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // the rows this warp sums
    for (int kt = 0; kt < ntiles; ++kt) {
        stage_ready<E>([&] {
            if (kt == 0) tiles<E, ND, T::ROWS, NT, true>(q_s, qkv, 0, 0, 0, 0, piece, scale);
        });
        if (kt + 1 < ntiles) fetch(kt + 1);
        cp_async_commit();
        const int at = kt % STAGES * ND * T::STAGE;
        scores_start<T>(s, q_s, k_s + at, g, ND, ND, hs);
        scores_done<T>(s);
        if constexpr (ND > 1) {
            put_part<T>(x_s, g, gt, s);
            __syncthreads();
        }
        float corr[2];
        if (mine) {
            if constexpr (ND > 1) sum_part<T, ND>(x_s, gt, s);
            mask_keys<NJ>(s, kt * T::KEYS, T_len);
            float mx[2] = {m[0], m[1]};
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
            }
            float mL[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = quad_max(mx[i]);  // finite: key 0 of the first tile is real
                corr[i] = exp2_approx((m[i] - mx[i]) * LOG2E);  // 0 on the first tile
                m[i] = mx[i];
                mL[i] = mx[i] * LOG2E;
                l[i] *= corr[i];
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[j][e] = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));  // p
                    l[e >> 1] += s[j][e];
                }
            if constexpr (ND > 1) {
                put_part<T>(x_s, 0, gt, s);
                if ((lane & 3) == 0) {
                    r_s[r0] = corr[0];
                    r_s[r0 + 8] = corr[1];
                }
            }
        }
        if constexpr (ND > 1) {
            __syncthreads();
            get_part<T>(x_s, gt, s);
            corr[0] = r_s[r0];
            corr[1] = r_s[r0 + 8];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            o[j][0] *= corr[0];
            o[j][1] *= corr[0];
            o[j][2] *= corr[1];
            o[j][3] *= corr[1];
        }
        output_product<T>(o, s, v_s + at + g * T::STAGE, cols);
    }

    float il[2];
    if (mine) {
        il[0] = 1.f / quad_sum(l[0]);
        il[1] = 1.f / quad_sum(l[1]);
        if (ND > 1 && (lane & 3) == 0) {
            r_s[T::ROWS + r0] = il[0];
            r_s[T::ROWS + r0 + 8] = il[1];
        }
    }
    if constexpr (ND > 1) {
        __syncthreads();
        il[0] = r_s[T::ROWS + r0];
        il[1] = r_s[T::ROWS + r0 + 8];
    }
    store_acc<E, 8>(out + (size_t)b * T_len * C + (size_t)h * hs + g * CH, C, row, T_len, o, cols,
                    hs & 1, il[0], il[1]);
}

// Backward, kernel 1: a block per (ROWS queries, head, batch element), two
// sweeps over the key tiles in one ring as in attention.cu.  Each step
// takes the partials of s (qs k^T) and dp (dout v^T) over the group's
// chunk and their sums; the first sweep takes each row's m, l and D, the
// second adds ds k[:, chunk g] to dq[:, chunk g].  Writes dq's chunk g; group
// 0 writes the rows' m, 1 / l and D.
template <typename E, int ND>
__global__ void __launch_bounds__(ND * Tiles<E>::GT)
qkv_attention_bwd_dq_chunked_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                    E* __restrict__ dqkv, float* __restrict__ stats, int T_len,
                                    int C, int NH, int hs, int piece, float scale) {
    using T = Tiles<E>;
    constexpr int NT = ND * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_chunked[];
    unsigned char* q_s = aligned_smem(smem_chunked);  // ND own tiles of qs, then of dout
    unsigned char* o_s = q_s + ND * T::OWN;
    unsigned char* k_s = o_s + ND * T::OWN;  // [STAGES][ND] stage tiles of k, then of v
    unsigned char* v_s = k_s + STAGES * ND * T::STAGE;
    float* xs_s = reinterpret_cast<float*>(v_s + STAGES * ND * T::STAGE);  // ND partials of s
    float* xp_s = xs_s + ND * T::PART / 4;                                 // and of dp
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int q0 = blockIdx.x * T::ROWS, row = q0 + gt / 32 * 16 + (lane >> 2);
    const bool mine = reduces(g, gt, ND);
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int sweep = (T_len + T::KEYS - 1) / T::KEYS, items = 2 * sweep;
    const int cols = min(CH, hs - g * CH);

    auto fetch = [&](int it) {
        const int k0 = it % sweep * T::KEYS, at = it % STAGES * ND * T::STAGE;
        tiles<E, ND, T::KEYS, NT>(k_s + at, q_head + C, stride, k0, T_len, hs, piece);
        tiles<E, ND, T::KEYS, NT>(v_s + at, q_head + 2 * C, stride, k0, T_len, hs, piece);
    };
    tiles<E, ND, T::ROWS, NT>(q_s, q_head, stride, q0, T_len, hs, piece);
    tiles<E, ND, T::ROWS, NT>(o_s, o_head, (size_t)C, q0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], dp[NJ][4], dq[8][4];
    zero_acc(dq);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
    for (int it = 0; it < items; ++it) {
        stage_ready<E>([&] {
            if (it == 0) tiles<E, ND, T::ROWS, NT, true>(q_s, qkv, 0, 0, 0, 0, piece, scale);
        });
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        const int kt = it % sweep, at = it % STAGES * ND * T::STAGE;
        scores_start<T>(s, q_s, k_s + at, g, ND, ND, hs);
        scores_start<T>(dp, o_s, v_s + at, g, ND, ND, hs);
        scores_done<T>(s);
        scores_done<T>(dp);
        if constexpr (ND > 1) {
            put_part<T>(xs_s, g, gt, s);
            put_part<T>(xp_s, g, gt, dp);
            __syncthreads();
        }
        if (mine) {
            if constexpr (ND > 1) {
                sum_part<T, ND>(xs_s, gt, s);
                sum_part<T, ND>(xp_s, gt, dp);
            }
            mask_keys<NJ>(s, kt * T::KEYS, T_len);
            if (it < sweep) {  // sweep 1
                float mx[2] = {m[0], m[1]};
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
                    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
                }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = quad_max(mx[r]);
                    const float corr = exp2_approx((m[r] - mx[r]) * LOG2E);
                    m[r] = mx[r];
                    mL[r] = mx[r] * LOG2E;
                    l[r] *= corr;
                    dl[r] *= corr;
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));
                        l[e >> 1] += p;
                        dl[e >> 1] = fmaf(p, dp[j][e], dl[e >> 1]);
                    }
                if (kt == sweep - 1) {  // the rows' statistics, for sweep 2
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        inv_l[r] = 1.f / quad_sum(l[r]);
                        D[r] = quad_sum(dl[r]) * inv_l[r];
                    }
                }
            } else {  // sweep 2
#pragma unroll
                for (int j = 0; j < NJ; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1;
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[r])) * inv_l[r];
                        s[j][e] = p * (dp[j][e] - D[r]);  // ds
                    }
                if constexpr (ND > 1) put_part<T>(xs_s, 0, gt, s);
            }
        }
        if (it >= sweep) {  // the first sweep has no output: its sums need no second barrier
            if constexpr (ND > 1) {
                __syncthreads();
                get_part<T>(xs_s, gt, s);
            }
            output_product<T>(dq, s, k_s + at + g * T::STAGE, cols);
        }
    }

    store_acc<E, 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs + g * CH, stride, row,
                    T_len, dq, cols, hs & 1, scale, scale);
    if (mine && t == 0) {
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

// Backward, kernel 2: a block per (ROWS keys, head, batch element), one
// sweep over the query tiles (KEYS queries a stage, with their m, 1 / l
// and D; qs scaled as it arrives).  Group g takes chunks c = g + G i (G
// groups of CPW chunks, `dkv_chunks`).  Each step takes the partials of s^T
// (k qs^T) and dp^T (v dout^T) over the group's chunks and their sums, then
// dv += p^T dout and dk += ds^T qs on the group's chunks.

template <typename E, int ND>
__global__ void __launch_bounds__(dkv_threads<E>(ND))
qkv_attention_bwd_dkv_chunked_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                     E* __restrict__ dqkv, const float* __restrict__ stats,
                                     int T_len, int C, int NH, int hs, int piece, float scale) {
    using T = Tiles<E>;
    constexpr int CPW = dkv_chunks<E>(ND), G = (ND + CPW - 1) / CPW;
    constexpr int NT = G * T::GT, NJ = T::NJ;
    extern __shared__ unsigned char smem_chunked[];
    unsigned char* k_s = aligned_smem(smem_chunked);  // ND own tiles of k, then of v
    unsigned char* v_s = k_s + ND * T::OWN;
    unsigned char* q_s = v_s + ND * T::OWN;  // [STAGES][ND] stage tiles of qs, then of dout
    unsigned char* o_s = q_s + STAGES * ND * T::STAGE;
    float* xs_s = reinterpret_cast<float*>(o_s + STAGES * ND * T::STAGE);  // G partials of s^T
    float* xp_s = xs_s + G * T::PART / 4;                                 // and of dp^T
    float (*st_s)[3][T::KEYS] =
        reinterpret_cast<float (*)[3][T::KEYS]>(xp_s + G * T::PART / 4);  // m, 1 / l, D
    const int g = threadIdx.x / T::GT, gt = threadIdx.x % T::GT, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int k0 = blockIdx.x * T::ROWS, row = k0 + gt / 32 * 16 + (lane >> 2);
    const bool mine = reduces(g, gt, G);
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int items = (T_len + T::KEYS - 1) / T::KEYS;

    auto fetch = [&](int it) {
        const int q0 = it * T::KEYS, buf = it % STAGES, at = buf * ND * T::STAGE;
        tiles<E, ND, T::KEYS, NT>(q_s + at, q_head, stride, q0, T_len, hs, piece);
        tiles<E, ND, T::KEYS, NT>(o_s + at, o_head, (size_t)C, q0, T_len, hs, piece);
        for (int e = threadIdx.x; e < 3 * T::KEYS; e += NT) {
            const int k = e / T::KEYS, i = e % T::KEYS;
            const bool valid = q0 + i < T_len;
            cp_async4(&st_s[buf][k][i], st + k * plane + (valid ? q0 + i : 0), valid);
        }
    };
    tiles<E, ND, T::ROWS, NT>(k_s, q_head + C, stride, k0, T_len, hs, piece);
    tiles<E, ND, T::ROWS, NT>(v_s, q_head + 2 * C, stride, k0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[NJ][4], dp[NJ][4], dk[CPW][8][4], dv[CPW][8][4];
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
        zero_acc(dk[i]);
        zero_acc(dv[i]);
    }
    for (int it = 0; it < items; ++it) {
        const int q0 = it * T::KEYS, buf = it % STAGES, at = buf * ND * T::STAGE;
        // qs = round(q * scale), once per staged value: each thread scales
        // the pieces of the stage it copied itself.
        stage_ready<E>([&] {
            tiles<E, ND, T::KEYS, NT, true>(q_s + at, qkv, 0, 0, 0, 0, piece, scale);
        });
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        scores_start<T, CPW>(s, k_s, q_s + at, g, G, ND, hs);   // s^T
        scores_start<T, CPW>(dp, v_s, o_s + at, g, G, ND, hs);  // dp^T
        scores_done<T>(s);
        scores_done<T>(dp);
        if constexpr (G > 1) {
            put_part<T>(xs_s, g, gt, s);
            put_part<T>(xp_s, g, gt, dp);
            __syncthreads();
        }
        if (mine) {
            if constexpr (G > 1) {
                sum_part<T, G>(xs_s, gt, s);
                sum_part<T, G>(xp_s, gt, dp);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int q = 8 * j + 2 * t;  // the tile's query columns q, q + 1
                const float2 mm = *reinterpret_cast<const float2*>(&st_s[buf][0][q]);
                const float2 il = *reinterpret_cast<const float2*>(&st_s[buf][1][q]);
                const float2 dd = *reinterpret_cast<const float2*>(&st_s[buf][2][q]);
                const float mLq[2] = {mm.x * LOG2E, mm.y * LOG2E};
                const float ilq[2] = {il.x, il.y}, Dq[2] = {dd.x, dd.y};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int k = e & 1;
                    const float p = q0 + q + k < T_len
                                        ? exp2_approx(fmaf(s[j][e], LOG2E, -mLq[k])) * ilq[k]
                                        : 0.f;
                    dp[j][e] = p * (dp[j][e] - Dq[k]);  // ds
                    s[j][e] = p;
                }
            }
            if constexpr (G > 1) {
                put_part<T>(xs_s, 0, gt, s);
                put_part<T>(xp_s, 0, gt, dp);
            }
        }
        if constexpr (G > 1) {
            __syncthreads();
            get_part<T>(xs_s, gt, s);
            get_part<T>(xp_s, gt, dp);
        }
#pragma unroll
        for (int i = 0; i < CPW; ++i) {
            const int c = g + i * G;
            if (c >= ND) break;
            const int cols = min(CH, hs - c * CH);
            output_product<T>(dv[i], s, o_s + at + c * T::STAGE, cols);
            output_product<T>(dk[i], dp, q_s + at + c * T::STAGE, cols);
        }
    }

#pragma unroll
    for (int i = 0; i < CPW; ++i) {
        const int c = g + i * G, cols = min(CH, hs - c * CH);
        if (c >= ND) break;
        E* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs + c * CH;
        store_acc<E, 8>(k_out, stride, row, T_len, dk[i], cols, hs & 1, 1.f, 1.f);
        store_acc<E, 8>(k_out + C, stride, row, T_len, dv[i], cols, hs & 1, 1.f, 1.f);
    }
}

// Calls f(std::integral_constant<int, ND>()) for a head of nd chunks (1 ..
// MAX_CHUNKS).
template <typename F> int with_chunks(int nd, F&& f) {
    static_assert(MAX_CHUNKS == 4, "one case per chunk count");
    if (nd == 1) return f(std::integral_constant<int, 1>());
    if (nd == 2) return f(std::integral_constant<int, 2>());
    if (nd == 3) return f(std::integral_constant<int, 3>());
    return f(std::integral_constant<int, 4>());
}

template <typename E>
int fwd_chunked(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
                cudaStream_t stream) {
    const int hs = C / NH;
    return with_chunks((hs + CH - 1) / CH, [&](auto chunks) {
        constexpr int ND = decltype(chunks)::value;
        using T = Tiles<E>;
        constexpr int bytes = chunked_smem_bytes<T>(ND, ND, 1, false);
        const cudaError_t err = allow_smem(qkv_attention_fwd_chunked_kernel<E, ND>, bytes);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((T_len + Geo<E>::ROWS - 1) / Geo<E>::ROWS, NH, B);
        qkv_attention_fwd_chunked_kernel<E, ND><<<grid, ND * Tiles<E>::GT, bytes, stream>>>(
            static_cast<const E*>(qkv), static_cast<E*>(out), T_len, C, hs,
            piece_bytes(hs, sizeof(E)), scale);
        return (int)cudaGetLastError();
    });
}

template <typename E>
int bwd_chunked(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int T_len,
                int C, int NH, float scale, cudaStream_t stream) {
    const int hs = C / NH, piece = piece_bytes(hs, sizeof(E));
    return with_chunks((hs + CH - 1) / CH, [&](auto chunks) {
        constexpr int ND = decltype(chunks)::value;
        using T = Tiles<E>;
        constexpr int G = dkv_threads<E>(ND) / Tiles<E>::GT;  // the dk/dv kernel's groups
        constexpr int dq_bytes = chunked_smem_bytes<T>(ND, ND, 2, false);
        constexpr int dkv_bytes = chunked_smem_bytes<T>(ND, G, 2, true);
        cudaError_t err;
        if ((err = allow_smem(qkv_attention_bwd_dq_chunked_kernel<E, ND>, dq_bytes)) !=
                cudaSuccess ||
            (err = allow_smem(qkv_attention_bwd_dkv_chunked_kernel<E, ND>, dkv_bytes)) !=
                cudaSuccess)
            return (int)err;
        const dim3 grid((T_len + Geo<E>::ROWS - 1) / Geo<E>::ROWS, NH, B);
        const E* x = static_cast<const E*>(qkv);
        const E* dy = static_cast<const E*>(dout);
        E* dx = static_cast<E*>(dqkv);
        qkv_attention_bwd_dq_chunked_kernel<E, ND><<<grid, ND * Tiles<E>::GT, dq_bytes, stream>>>(
            x, dy, dx, stats, T_len, C, NH, hs, piece, scale);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        qkv_attention_bwd_dkv_chunked_kernel<E, ND>
            <<<grid, dkv_threads<E>(ND), dkv_bytes, stream>>>(x, dy, dx, stats, T_len, C, NH, hs,
                                                              piece, scale);
        return (int)cudaGetLastError();
    });
}

}  // namespace

int attention_fwd_chunked(const void* qkv, void* out, int B, int T_len, int C, int NH,
                          float scale, int is_bf16, cudaStream_t stream) {
    if (C / NH > CH * MAX_CHUNKS) return (int)cudaErrorInvalidValue;
    return is_bf16 ? fwd_chunked<bf16>(qkv, out, B, T_len, C, NH, scale, stream)
                   : fwd_chunked<float>(qkv, out, B, T_len, C, NH, scale, stream);
}

int attention_bwd_chunked(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                          int T_len, int C, int NH, float scale, int is_bf16,
                          cudaStream_t stream) {
    if (C / NH > CH * MAX_CHUNKS) return (int)cudaErrorInvalidValue;
    return is_bf16 ? bwd_chunked<bf16>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, stream)
                   : bwd_chunked<float>(qkv, dout, dqkv, stats, B, T_len, C, NH, scale, stream);
}
