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

// A block's geometry by type: ROWS own rows (a group's: 16 a warp), KEYS
// rows of the other side a stage, at most DKV_THREADS threads a block of
// the dk/dv kernel (`dkv_chunks`).
template <typename E> struct Geo;
template <> struct Geo<bf16> {
    static constexpr int ROWS = 64, KEYS = 32, DKV_THREADS = 384;
};
template <> struct Geo<float> {
    static constexpr int ROWS = 32, KEYS = 32, DKV_THREADS = 256;
};

constexpr int ALIGN = 1024;  // the swizzle's period: tiles start 1024-byte aligned

// The tiles of the chunked kernels of type E.
template <typename E> struct Tiles {
    using Elem = E;
    static constexpr int ROWS = Geo<E>::ROWS, KEYS = Geo<E>::KEYS;
    static constexpr int GT = ROWS / 16 * 32;             // threads of a group
    static constexpr int NJ = KEYS / 8;                   // n-tiles of a warp's scores
    static constexpr int RB = CH * (int)sizeof(E);        // bytes of a tile row
    static constexpr int OWN = ROWS * RB;                 // a chunk tile of own rows
    static constexpr int STAGE = KEYS * RB;               // a chunk tile of a stage
    static constexpr int PART = ROWS * KEYS * 4;          // a group's float32 partial
    static constexpr int XV = PART / 16;                  // its float4s
};

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have

// Dynamic shared memory of a chunked kernel (see the opening note).
template <typename T>
constexpr int chunked_smem_bytes(int nd, int groups, int sides, bool stats) {
    return ALIGN + sides * (nd * T::OWN + groups * T::PART) + 2 * STAGES * nd * T::STAGE +
           (stats ? STAGES * 3 * T::KEYS : sides == 1 ? 2 * T::ROWS : 0) * (int)sizeof(float);
}

// The chunks each group of the dk/dv kernel takes: one, or, where nd groups
// would pass DKV_THREADS, as many as keep the block within it (bfloat16 at
// four chunks: two warpgroups of two chunks, whose dk and dv take 128
// registers a thread, where four warpgroups would have 128 in all).
template <typename E> __host__ __device__ constexpr int dkv_chunks(int nd) {
    return (nd * Tiles<E>::GT + Geo<E>::DKV_THREADS - 1) / Geo<E>::DKV_THREADS;
}

// The byte offset of 16-byte piece c of row r in a chunk tile: conv3x3.cu's
// 128-byte swizzle, with rows of 256 bytes in float32.
template <typename E> __device__ __forceinline__ uint32_t tile_at(int r, int c) {
    if constexpr (sizeof(E) == 2) {
        return swizzled(r, c);
    } else {
        return (uint32_t)(r * CH * (int)sizeof(E) + ((c ^ (r & 7)) << 4));
    }
}

// ---------------------------------------------------------------------------
// Copies.

// Rows [r0, r0 + R) of the head's columns [0, hs) (row r at src + r *
// stride) into ND chunk tiles of R rows (tile d at dst + d * R * RB: columns
// 64 d ..), in pieces of W bytes by the block's NT threads; rows at or past
// n and columns at or past hs are zero.  With SCALE, the pieces this thread
// copied are multiplied by `scale` and rounded to E instead (qs; after the
// thread's wait, which shows it its own copies).
template <typename E, int ND, int R, int NT, int W, bool SCALE>
__device__ __forceinline__ void tiles_w(unsigned char* dst, const E* src, size_t stride, int r0,
                                        int n, int hs, float scale) {
    constexpr int V = W / (int)sizeof(E);  // values a piece
    constexpr int PR = CH / V;             // pieces a tile row
#pragma unroll 2
    for (int e = threadIdx.x; e < ND * R * PR; e += NT) {
        const int d = e / (R * PR), r = e / PR % R, p = e % PR;
        unsigned char* to = dst + d * R * CH * (int)sizeof(E) + tile_at<E>(r, p * W >> 4) +
                            (p * W & 15);
        if constexpr (SCALE) {
            Vec<E, V> v = *reinterpret_cast<Vec<E, V>*>(to);
#pragma unroll
            for (int k = 0; k < V; ++k) v.v[k] = from_float<E>(to_float<E>(v.v[k]) * scale);
            *reinterpret_cast<Vec<E, V>*>(to) = v;
        } else {
            const int c = d * CH + p * V;
            const bool valid = r0 + r < n && c < hs;
            const E* from = src + (valid ? (size_t)(r0 + r) * stride + c : 0);
            if constexpr (W == 2) {
                *reinterpret_cast<uint16_t*>(to) =
                    valid ? *reinterpret_cast<const uint16_t*>(from) : 0;
            } else {
                cp_async_w<W>(to, from, valid);
            }
        }
    }
}

// `tiles_w` with the piece the launcher chose for the launch (16, 8, 4 or,
// bfloat16 only, 2 bytes): the same branch in every thread.
template <typename E, int ND, int R, int NT, bool SCALE = false>
__device__ __forceinline__ void tiles(unsigned char* dst, const E* src, size_t stride, int r0,
                                      int n, int hs, int piece, float scale = 1.f) {
    if (piece == 16) {
        tiles_w<E, ND, R, NT, 16, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if (piece == 8) {
        tiles_w<E, ND, R, NT, 8, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if constexpr (sizeof(E) == 4) {
        tiles_w<E, ND, R, NT, 4, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else if (piece == 4) {
        tiles_w<E, ND, R, NT, 4, SCALE>(dst, src, stride, r0, n, hs, scale);
    } else {
        tiles_w<E, ND, R, NT, 2, SCALE>(dst, src, stride, r0, n, hs, scale);
    }
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
// bfloat16 products on `wgmma` (the group is one warpgroup; every thread of
// it calls them, with the same arguments).

// Keeps the compiler from moving the registers' reads and writes across the
// asynchronous products: before `wgmma_fence` and after `wgmma_wait`.
template <int N> __device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d += a b over k = 16, a 64-row A and an N-column B both K-major in
// shared memory (the scores).
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 8][4], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_scores<32>(float (&d)[4][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(a), "l"(b)
        : "memory");
}

// d[0 .. N/8) += a b over k = 16, A from registers (lane 4g + t of warp w:
// rows 16 w + g and + 8, as `mma_bf16`'s A fragment) and an N-column B
// N-major in shared memory (the output products).
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rows<16>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<32>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<48>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rows<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b)
        : "memory");
}

// acc = own tile (64 rows) x other tile (KEYS rows)^T over the chunk's
// first `cols` columns: k-steps of 16 at or past cols are skipped (both
// tiles are zero there).
template <typename T, int CPW>
__device__ __forceinline__ void scores_wgmma(float (&acc)[T::NJ][4], const unsigned char* own,
                                             const unsigned char* other, int c0, int step,
                                             int nd, int hs) {
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
        const int c = c0 + i * step, cols = hs - c * CH;
        if (c >= nd) break;
        const unsigned char* a = own + c * T::OWN;
        const unsigned char* b = other + c * T::STAGE;
#pragma unroll
        for (int ks = 0; ks < CH / 16; ++ks) {
            if (16 * ks >= cols) break;
            wgmma_scores<T::KEYS>(acc, wgmma_desc(a + 32 * ks, 16), wgmma_desc(b + 32 * ks, 16));
        }
    }
    wgmma_commit();
}

// acc += p tile over the tile's KEYS rows, for the scores' accumulator p
// (float32, rounded and packed into A fragments) and a tile whose rows are
// the product's k index, N = cols rounded up to 16 (the tile is zero past
// cols, and acc's columns past cols are never stored).
template <typename T>
__device__ __forceinline__ void output_wgmma(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                             const unsigned char* tile, int cols) {
    constexpr int KSTEPS = T::KEYS / 16;
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < T::NJ; ++j) {
        a[j >> 1][(j & 1) * 2] = pack_bf16(p[j][0], p[j][1]);
        a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
    }
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
    pin(acc);
    wgmma_fence();
    const int n16 = (cols + 15) >> 4;
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t b = wgmma_desc(tile + k * 16 * 128, T::KEYS * 128);
        if (n16 == 4) {
            wgmma_rows<64>(acc, a[k], b);
        } else if (n16 == 3) {
            wgmma_rows<48>(acc, a[k], b);
        } else if (n16 == 2) {
            wgmma_rows<32>(acc, a[k], b);
        } else {
            wgmma_rows<16>(acc, a[k], b);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
}

// ---------------------------------------------------------------------------
// float32 products in 3xTF32 on `mma.sync` (each warp its 16 rows).

// acc = own tile (the warp's rows 16 w ..) x other tile^T over the chunk's
// first `cols` columns in k-steps of 8: the own rows' A fragment by 32-bit
// loads (lane 4g + t: rows g, g + 8, columns t, t + 4), the other tile's B
// fragments by `ldmatrix` (a float as two 16-bit halves).
template <typename T, int CPW>
__device__ __forceinline__ void scores_tf32(float (&acc)[T::NJ][4], const unsigned char* own_base,
                                            const unsigned char* other_base, int c0, int step,
                                            int nd, int hs) {
    constexpr int NJ = T::NJ;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r = (threadIdx.x & (T::GT - 1)) / 32 * 16 + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
    const int c = c0 + i * step, cols = hs - c * CH;
    if (c >= nd) break;
    const unsigned char* own = own_base + c * T::OWN;
    const unsigned char* other = other_base + c * T::STAGE;
#pragma unroll
    for (int ks = 0; ks < CH / 8; ++ks) {
        if (8 * ks >= cols) break;
        auto at = [&](int row, int c) {  // column 8 ks + t (c = 0) or + 4 (c = 1)
            return *reinterpret_cast<const float*>(own + tile_at<float>(row, 2 * ks + c) + 4 * t);
        };
        uint32_t ah[4], al[4];
        split_tf32(at(r, 0), ah[0], al[0]);
        split_tf32(at(r + 8, 0), ah[1], al[1]);
        split_tf32(at(r, 1), ah[2], al[2]);
        split_tf32(at(r + 8, 1), ah[3], al[3]);
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
            const int row = 8 * j + (lane & 7) + (lane >> 4) * 8;
            uint32_t b[4];
            ldsm_x4(b, other + tile_at<float>(row, 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                split_tf32(__uint_as_float(b[2 * jj]), bh[j + jj][0], bl[j + jj][0]);
                split_tf32(__uint_as_float(b[2 * jj + 1]), bh[j + jj][1], bl[j + jj][1]);
            }
        }
        // the three products of each n-tile in turn over all n-tiles, so
        // that no product waits for the one before it on its accumulator
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
    }
    }
}

// acc += p tile over the tile's KEYS rows, n-tiles at or past cols skipped
// (the three products of each n-tile in turn over the n-tiles):
// p's accumulator holds keys 2t, 2t + 1 of its n-tile where the A fragment
// holds k = t, t + 4, so k = t is taken as tile row 2t and k = t + 4 as row
// 2t + 1, in A and B alike (attention.cu's float32 note).
template <typename T>
__device__ __forceinline__ void output_tf32(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                            const unsigned char* tile, int cols) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < T::NJ; ++kk) {
        uint32_t ah[4], al[4];
        split_tf32(p[kk][0], ah[0], al[0]);
        split_tf32(p[kk][2], ah[1], al[1]);
        split_tf32(p[kk][1], ah[2], al[2]);
        split_tf32(p[kk][3], ah[3], al[3]);
        const int r = 8 * kk + 2 * t, nn = (cols + 7) / 8;
        uint32_t bh[CH / 8][2], bl[CH / 8][2];
#pragma unroll
        for (int n = 0; n < CH / 8; ++n) {
            const int c = 2 * n + (g >> 2), w = 4 * (g & 3);  // column 8 n + g
            split_tf32(*reinterpret_cast<const float*>(tile + tile_at<float>(r, c) + w), bh[n][0],
                       bl[n][0]);
            split_tf32(*reinterpret_cast<const float*>(tile + tile_at<float>(r + 1, c) + w),
                       bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < CH / 8; ++n)
            if (n < nn) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
    }
}

// The group's score product over its chunks c = c0 + step i < nd (acc =
// the sum of own tile c x other tile c^T; the tiles of chunk c at own + c
// OWN and other + c STAGE), by type: in bfloat16 `scores_start` issues the
// products and `scores_done` waits for them (so the two products of the
// backward are in flight together), in float32 `scores_start` does them.
template <typename T, int CPW = 1>
__device__ __forceinline__ void scores_start(float (&acc)[T::NJ][4], const unsigned char* own,
                                             const unsigned char* other, int c0, int step,
                                             int nd, int hs) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        scores_wgmma<T, CPW>(acc, own, other, c0, step, nd, hs);
    } else {
        scores_tf32<T, CPW>(acc, own, other, c0, step, nd, hs);
    }
}

template <typename T> __device__ __forceinline__ void scores_done(float (&acc)[T::NJ][4]) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        wgmma_wait<0>();
        pin(acc);
    }
}

template <typename T>
__device__ __forceinline__ void output_product(float (&acc)[8][4], const float (&p)[T::NJ][4],
                                               const unsigned char* tile, int cols) {
    if constexpr (sizeof(typename T::Elem) == 2) {
        output_wgmma<T>(acc, p, tile, cols);
    } else {
        output_tf32<T>(acc, p, tile, cols);
    }
}

// ---------------------------------------------------------------------------
// The kernels.  In each: g the thread's group (its chunk), gt its thread in
// the group, its rows `row` and row + 8 of the block's ROWS (lane 4g' + t of
// warp w of the group: w * 16 + g').

// The start of the dynamic shared memory, aligned to ALIGN.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
    return raw + ((ALIGN - (smem_addr(raw) & (ALIGN - 1))) & (ALIGN - 1));
}

// The top of each step of a ring: this thread's copies of the stage have
// landed (and, first, the own rows, of which it then scales qs's pieces
// with `scale_own`), `wgmma` may see them, and the block's barrier shows
// them to every thread and says every group is done with the stage before.
template <typename E, typename F>
__device__ __forceinline__ void stage_ready(F&& scale_own) {
    cp_async_wait<0>();
    scale_own();
    if constexpr (sizeof(E) == 2) fence_proxy_async();
    __syncthreads();
}

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
template <typename E> __host__ __device__ constexpr int dkv_threads(int nd) {
    return (nd + dkv_chunks<E>(nd) - 1) / dkv_chunks<E>(nd) * Tiles<E>::GT;
}

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
