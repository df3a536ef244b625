// Attention forward and backward for the heads of up to 256 columns (CH *
// MAX_CHUNKS) that attention.cu's kernels do not take: wider than 64
// columns, or a row that is no multiple of 16 bytes (a bfloat16 head of 7,
// 12 or 36 columns).  The head is cut into chunks of CH columns, the
// block's own rows whole in shared memory, the other side streamed a chunk
// tile at a time (attention.cu's opening note, "Head sizes").  Copies take
// the widest piece of 16, 8, 4 or 2 bytes that every head's row starts on.

#include "attention.cuh"

namespace {

// The own rows' tile takes nd chunks + the padding of a chunk tile: a row is
// 16 bytes past a multiple of 128 at every nd.
template <typename E> __host__ __device__ constexpr int own_ld(int nd) {
    return nd * CH + CPAD<E>;
}

// Dynamic shared memory of a chunked kernel: `own` tiles of the block's own
// rows, the two rings of STAGES chunk tiles, and (dk/dv kernel) the query
// tiles' m, 1 / l and D.  At 256 columns in float32 the dq kernel takes
// 202,752 bytes, the dk/dv kernel 204,288: within the 232,448 a block may.
template <typename E> constexpr int chunked_smem_bytes(int own, int nd, bool stats) {
    return (own * TILE * own_ld<E>(nd) + 2 * STAGES * TILE * LDC<E>) * (int)sizeof(E) +
           (stats ? STAGES * 3 * TILE * (int)sizeof(float) : 0);
}

// Forward: one block per (batch, head and chunk c, TILE queries).  The
// block's q rows are staged whole and scaled once (qs); item `it` of the
// ring is key tile it / nd, k's depth chunk (c + 1 + it % nd) % nd, and with
// the tile's last chunk (chunk c) v's chunk c: the scores are complete
// there, and the online softmax and out += p v run as in attention.cu.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_fwd_chunked_kernel(const E* __restrict__ qkv, E* __restrict__ out, int T_len, int C,
                                 int hs, int piece, float scale) {
    extern __shared__ __align__(128) unsigned char smem_chunked[];
    const int nd = (hs + CH - 1) / CH, ld = own_ld<E>(nd);
    E* q_s = reinterpret_cast<E*>(smem_chunked);
    const ChunkRing<E> k_s = reinterpret_cast<ChunkRing<E>>(q_s + TILE * ld);
    const ChunkRing<E> v_s = k_s + STAGES;
    const int h = blockIdx.y / nd, c = blockIdx.y % nd, b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * TILE, row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE, items = ntiles * nd;
    const int cols = min(CH, hs - c * CH);  // the block's output columns

    auto fetch = [&](int it) {
        const int kt = it / nd, dd = it % nd, d = (c + 1 + dd) % nd, buf = it % STAGES;
        copy_rows(&k_s[buf][0][0], LDC<E>, CH, q_head + C + d * CH, stride, kt * TILE, T_len,
                  min(CH, hs - d * CH), piece);
        if (dd == nd - 1)
            copy_rows(&v_s[buf][0][0], LDC<E>, CH, q_head + 2 * C + c * CH, stride, kt * TILE,
                      T_len, cols, piece);
    };
    copy_rows(q_s, ld, nd * CH, q_head, stride, q0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[8][4], o[8][4];
    zero_acc(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        if (it == 0) scale_rows(q_s, ld, nd * CH, scale, piece);  // qs, this thread's pieces
        __syncthreads();

        const int kt = it / nd, dd = it % nd, d = (c + 1 + dd) % nd, buf = it % STAGES;
        if (dd == 0) zero_acc(s);
        chunk_scores(s, q_s + d * CH, ld, k_s[buf], min(CH, hs - d * CH));
        if (dd == nd - 1) {
            mask_keys<8>(s, kt * TILE, T_len);
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
                for (int j = 0; j < 8; ++j) {
                    o[j][2 * i] *= corr;
                    o[j][2 * i + 1] *= corr;
                }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[j][e] = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));  // p
                    l[e >> 1] += s[j][e];
                }
            chunk_pv(o, s, v_s[buf], cols);
        }
        __syncthreads();  // the tiles have been consumed before they are refilled
    }

    store_acc<E, 8>(out + (size_t)b * T_len * C + (size_t)h * hs + c * CH, C, row, T_len, o, cols,
                    hs & 1, 1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
}

// Backward, kernel 1: one block per (batch, head and chunk c, TILE
// queries), two sweeps over the key tiles as in attention.cu, each key
// tile in nd items (k's and v's depth chunk (c + 1 + i) % nd) that add up
// the scores and dp; at the tile's last item the first sweep takes each
// row's m, l and D, the second adds ds k to the block's chunk of dq (k's
// chunk c is that item's tile).  Writes dq's chunk c; the blocks of chunk 0
// write the rows' m, 1 / l and D.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dq_chunked_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                    E* __restrict__ dqkv, float* __restrict__ stats, int T_len,
                                    int C, int NH, int hs, int piece, float scale) {
    extern __shared__ __align__(128) unsigned char smem_chunked[];
    const int nd = (hs + CH - 1) / CH, ld = own_ld<E>(nd);
    E* q_s = reinterpret_cast<E*>(smem_chunked);
    E* o_s = q_s + TILE * ld;
    const ChunkRing<E> k_s = reinterpret_cast<ChunkRing<E>>(o_s + TILE * ld);
    const ChunkRing<E> v_s = k_s + STAGES;
    const int h = blockIdx.y / nd, c = blockIdx.y % nd, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int q0 = blockIdx.x * TILE, row = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const int ntiles = (T_len + TILE - 1) / TILE, sweep = ntiles * nd, items = 2 * sweep;
    const int cols = min(CH, hs - c * CH);

    auto fetch = [&](int it) {
        const int i = it % sweep, kt = i / nd, d = (c + 1 + i % nd) % nd, buf = it % STAGES;
        const int dcols = min(CH, hs - d * CH);
        copy_rows(&k_s[buf][0][0], LDC<E>, CH, q_head + C + d * CH, stride, kt * TILE, T_len,
                  dcols, piece);
        copy_rows(&v_s[buf][0][0], LDC<E>, CH, q_head + 2 * C + d * CH, stride, kt * TILE, T_len,
                  dcols, piece);
    };
    copy_rows(q_s, ld, nd * CH, q_head, stride, q0, T_len, hs, piece);
    copy_rows(o_s, ld, nd * CH, o_head, (size_t)C, q0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[8][4], dp[8][4], dq[8][4];
    zero_acc(dq);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    float mL[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        if (it == 0) scale_rows(q_s, ld, nd * CH, scale, piece);  // qs, this thread's pieces
        __syncthreads();

        const int i = it % sweep, kt = i / nd, dd = i % nd, d = (c + 1 + dd) % nd;
        const int buf = it % STAGES, dcols = min(CH, hs - d * CH);
        if (dd == 0) {
            zero_acc(s);
            zero_acc(dp);
        }
        chunk_scores(s, q_s + d * CH, ld, k_s[buf], dcols);
        chunk_scores(dp, o_s + d * CH, ld, v_s[buf], dcols);
        if (dd == nd - 1) {
            mask_keys<8>(s, kt * TILE, T_len);
            if (it < sweep) {  // sweep 1
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
                    mL[r] = mx[r] * LOG2E;
                    l[r] *= corr;
                    dl[r] *= corr;
                }
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[e >> 1]));
                        l[e >> 1] += p;
                        dl[e >> 1] = fmaf(p, dp[j][e], dl[e >> 1]);
                    }
                if (kt == ntiles - 1) {  // the rows' statistics, for sweep 2
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        inv_l[r] = 1.f / quad_sum(l[r]);
                        D[r] = quad_sum(dl[r]) * inv_l[r];
                    }
                }
            } else {  // sweep 2
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1;
                        const float p = exp2_approx(fmaf(s[j][e], LOG2E, -mL[r])) * inv_l[r];
                        s[j][e] = p * (dp[j][e] - D[r]);  // ds
                    }
                chunk_pv(dq, s, k_s[buf], cols);
            }
        }
        __syncthreads();
    }

    store_acc<E, 8>(dqkv + (size_t)b * T_len * stride + (size_t)h * hs + c * CH, stride, row,
                    T_len, dq, cols, hs & 1, scale, scale);
    if (c == 0 && t == 0) {
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

// Backward, kernel 2: one block per (batch, head and chunk c, TILE keys).
// The block's k and v rows are staged whole; item `it` of the ring is query
// tile it / nd, qs's and dout's depth chunk (c + 1 + it % nd) % nd (qs
// scaled as it arrives), with the tile's m, 1 / l and D at its last chunk
// (chunk c): s^T and dp^T are complete there, and dv += p^T dout, dk += ds^T
// qs take dout's and qs's chunk c from that item's tiles.
template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_attention_bwd_dkv_chunked_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                                     E* __restrict__ dqkv, const float* __restrict__ stats,
                                     int T_len, int C, int NH, int hs, int piece, float scale) {
    extern __shared__ __align__(128) unsigned char smem_chunked[];
    const int nd = (hs + CH - 1) / CH, ld = own_ld<E>(nd);
    E* k_s = reinterpret_cast<E*>(smem_chunked);
    E* v_s = k_s + TILE * ld;
    const ChunkRing<E> q_s = reinterpret_cast<ChunkRing<E>>(v_s + TILE * ld);
    const ChunkRing<E> o_s = q_s + STAGES;
    float (*st_s)[3][TILE] = reinterpret_cast<float (*)[3][TILE]>(o_s + STAGES);  // m, 1 / l, D
    const int h = blockIdx.y / nd, c = blockIdx.y % nd, b = blockIdx.z;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int k0 = blockIdx.x * TILE, row = k0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
    const size_t stride = (size_t)3 * C;
    const size_t plane = (size_t)gridDim.z * NH * T_len;
    const E* q_head = qkv + (size_t)b * T_len * stride + (size_t)h * hs;
    const E* o_head = dout + (size_t)b * T_len * C + (size_t)h * hs;
    const float* st = stats + ((size_t)b * NH + h) * T_len;
    const int ntiles = (T_len + TILE - 1) / TILE, items = ntiles * nd;
    const int cols = min(CH, hs - c * CH);

    auto fetch = [&](int it) {
        const int q0 = it / nd * TILE, dd = it % nd, d = (c + 1 + dd) % nd, buf = it % STAGES;
        const int dcols = min(CH, hs - d * CH);
        copy_rows(&q_s[buf][0][0], LDC<E>, CH, q_head + d * CH, stride, q0, T_len, dcols, piece);
        copy_rows(&o_s[buf][0][0], LDC<E>, CH, o_head + d * CH, (size_t)C, q0, T_len, dcols,
                  piece);
        if (dd == nd - 1) {
            for (int e = threadIdx.x; e < 3 * TILE; e += THREADS) {
                const int k = e / TILE, i = e % TILE;
                const bool valid = q0 + i < T_len;
                cp_async4(&st_s[buf][k][i], st + k * plane + (valid ? q0 + i : 0), valid);
            }
        }
    };
    copy_rows(k_s, ld, nd * CH, q_head + C, stride, k0, T_len, hs, piece);
    copy_rows(v_s, ld, nd * CH, q_head + 2 * C, stride, k0, T_len, hs, piece);
    fetch(0);
    cp_async_commit();

    float s[8][4], dp[8][4], dk[8][4], dv[8][4];
    zero_acc(dk);
    zero_acc(dv);
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) fetch(it + 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        const int q0 = it / nd * TILE, dd = it % nd, d = (c + 1 + dd) % nd, buf = it % STAGES;
        const int dcols = min(CH, hs - d * CH);
        // qs = round(q * scale), once per staged value: each thread scales
        // the pieces it copied itself; the barrier shows them to the block.
        scale_rows(&q_s[buf][0][0], LDC<E>, CH, scale, piece);
        __syncthreads();

        if (dd == 0) {
            zero_acc(s);
            zero_acc(dp);
        }
        chunk_scores(s, k_s + d * CH, ld, q_s[buf], dcols);   // s^T
        chunk_scores(dp, v_s + d * CH, ld, o_s[buf], dcols);  // dp^T
        if (dd == nd - 1) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int q = 8 * j + 2 * t;  // the tile's query columns q, q + 1
                const float2 mm = *reinterpret_cast<const float2*>(&st_s[buf][0][q]);
                const float2 il = *reinterpret_cast<const float2*>(&st_s[buf][1][q]);
                const float2 dd2 = *reinterpret_cast<const float2*>(&st_s[buf][2][q]);
                const float mLq[2] = {mm.x * LOG2E, mm.y * LOG2E};
                const float ilq[2] = {il.x, il.y}, Dq[2] = {dd2.x, dd2.y};
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
            chunk_pv(dv, s, o_s[buf], cols);
            chunk_pv(dk, dp, q_s[buf], cols);
        }
        __syncthreads();
    }

    E* k_out = dqkv + (size_t)b * T_len * stride + C + (size_t)h * hs + c * CH;
    store_acc<E, 8>(k_out, stride, row, T_len, dk, cols, hs & 1, 1.f, 1.f);
    store_acc<E, 8>(k_out + C, stride, row, T_len, dv, cols, hs & 1, 1.f, 1.f);
}

template <typename E>
int fwd_chunked(const void* qkv, void* out, int B, int T_len, int C, int NH, float scale,
                cudaStream_t stream) {
    const int hs = C / NH, nd = (hs + CH - 1) / CH;
    if ((long long)NH * nd > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(qkv_attention_fwd_chunked_kernel<E>,
                                       chunked_smem_bytes<E>(1, MAX_CHUNKS, false));
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T_len + TILE - 1) / TILE, NH * nd, B);
    qkv_attention_fwd_chunked_kernel<E><<<grid, THREADS, chunked_smem_bytes<E>(1, nd, false),
                                          stream>>>(static_cast<const E*>(qkv),
                                                    static_cast<E*>(out), T_len, C, hs,
                                                    piece_bytes(hs, sizeof(E)), scale);
    return (int)cudaGetLastError();
}

template <typename E>
int bwd_chunked(const void* qkv, const void* dout, void* dqkv, float* stats, int B, int T_len,
                int C, int NH, float scale, cudaStream_t stream) {
    const int hs = C / NH, nd = (hs + CH - 1) / CH, piece = piece_bytes(hs, sizeof(E));
    if ((long long)NH * nd > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if ((err = allow_smem(qkv_attention_bwd_dq_chunked_kernel<E>,
                          chunked_smem_bytes<E>(2, MAX_CHUNKS, false))) != cudaSuccess ||
        (err = allow_smem(qkv_attention_bwd_dkv_chunked_kernel<E>,
                          chunked_smem_bytes<E>(2, MAX_CHUNKS, true))) != cudaSuccess)
        return (int)err;
    const dim3 grid((T_len + TILE - 1) / TILE, NH * nd, B);
    const E* x = static_cast<const E*>(qkv);
    const E* dy = static_cast<const E*>(dout);
    E* dx = static_cast<E*>(dqkv);
    qkv_attention_bwd_dq_chunked_kernel<E><<<grid, THREADS, chunked_smem_bytes<E>(2, nd, false),
                                             stream>>>(x, dy, dx, stats, T_len, C, NH, hs, piece,
                                                       scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    qkv_attention_bwd_dkv_chunked_kernel<E><<<grid, THREADS, chunked_smem_bytes<E>(2, nd, true),
                                              stream>>>(x, dy, dx, stats, T_len, C, NH, hs, piece,
                                                        scale);
    return (int)cudaGetLastError();
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
