// 3x3 SAME convolution, stride 1, on the (H, W, B, C) view: an implicit GEMM.
//
// Replaces the Pallas kernel `_conv_kernel` of scripts/conv_proto.py
// (launched by `conv3x3_hwbc` there): out (H, W, B, O) = x (H, W, B, C)
// convolved with w (3, 3, C, O) HWIO plus b (O,), zero padding.  As a matrix
// product: M = H*W*B output rows ordered (h, w, b) with b fastest, N = O,
// K = 9*C ordered tap-major (ky, kx, c), the order of the TPU kernel's
// `w.reshape(9C, O)`.  Row (h, w, b) of the A operand for tap (ky, kx) is
// input pixel (h + ky - 1, w + kx - 1, b), or zeros where that lies outside
// the image: a one-pixel step in w is B rows, so both the h halo and the
// w edge are masked (without the w mask a row would read the neighbouring
// image row's edge pixel).  The TPU kernel's rounding points are kept: w
// arrives already in x's type (the wrapper casts it), the bias is widened to
// float32 and is the accumulator's initial value, products accumulate in
// float32, and the output is rounded to x's type once at the end.
//
// Bound on an H100.  2 * M*N*K operations against (|x| + |w| + |out|) *
// itemsize bytes: at the U-Net's shapes (C 64..320, O 64..128, B = 32) the
// operations set the bound, 10..40 us on the bf16 tensor cores.
//
// Three kernels; the launcher picks one by a plain rule (`route`, mirrored
// by ops/kernels/conv3x3.py::route): "wgmma" for bfloat16 and "tf32" for
// float32 where C and O are multiples of 8, "fma" for a ragged C or O in
// either type.
//
// bfloat16 with C and O multiples of 8: conv3x3_hwbc_wgmma_kernel, on the
// tensor cores with Hopper's warpgroup products.  In the (H, W, B, C)
// layout a tap (dy, dx) shifts the whole A operand by a constant (dy W + dx)
// B rows, so the A tile of a block (128 consecutive output rows) for one
// tap and one chunk of 64 channels is 128 consecutive input rows of 128
// bytes: eight 16-byte pieces each, copied by `cp.async` whose source size
// is 0 (a zero fill) where the row's pixel leaves the image for this tap
// (each thread keeps a 9-bit mask of the taps its rows may take) or the
// channel passes C.  The W tile (64 rows of the (9C, O) matrix x 64 or 128
// output channels) is copied the same way, zero past C and past O.  Both
// land in the 128-byte swizzled layout that `wgmma` reads from shared
// memory (piece c of row r at r * 128 + ((c ^ r % 8) << 4)): A K-major, W
// N-major (the instruction's transposed B, in 64-column atoms), so neither
// needs a transpose.  A ring of three stages in dynamic shared memory keeps
// the next stage's copies in flight while one stage is multiplied and the
// products of the previous one finish (`wgmma.wait_group 1`); one barrier
// per stage.  Each of the block's two warpgroups issues four
// `wgmma.m64nBNk16` (BN = 64 when O <= 64, else 128) a stage into a
// float32 accumulator of 64 rows x BN that starts at the bias; the products
// run over the taps and channels in one fixed order, are rounded to bf16
// once, and leave through shared memory as whole 16-byte row pieces.  No
// split-K and no atomics, so a rerun gives the same bits.
//
// float32 with C and O multiples of 8: conv3x3_hwbc_tf32_kernel, the same
// implicit GEMM on the TF32 tensor cores in 3xTF32 (common.cuh:
// `split_tf32`, `mma_3xtf32`; the float32 attention kernels' scheme).  A
// stage is one tap and 32 channels: the A tile is 128 shifted rows of 128
// bytes, copied and zero-filled exactly as the bf16 kernel's (the same
// swizzle, so `ldmatrix` reads the fragments without bank conflicts), and
// the W tile 32 rows x BN floats, each row padded by 8 floats so that the
// B fragments' 32-bit reads fall in 32 different banks.  A ring of three
// stages keeps two stages' copies in flight while one is multiplied.
// Eight warps a block, 4 x 2, each 32 rows x BN / 2 columns in
// `mma.sync.m16n8k8` tiles; each operand is split into its TF32 pair hi +
// lo as its fragment is read, and a b is taken as a_hi b_lo + a_lo b_hi +
// a_hi b_hi.  The accuracy trap of the float32 sum (below) is worse on
// the tensor cores, which truncate where IEEE rounds: a stage's products
// go into a partial sum of their own (12 products a fragment), which is
// added to the bias-initialised accumulator with a rounded float32 add
// once the stage is done, stage by stage in one fixed order.  Bound on an
// H100: the products, at 495 / 3 = 165 TFLOP/s effective.
//
// A ragged C or O (C = 3 at the U-Net's first convolution), in either
// type: conv3x3_hwbc_kernel, the plain implicit GEMM with float32
// FMAs.  A block computes a BM x BN tile of the output.  For each tap and
// each chunk of BK input channels it gathers the A tile (BM rows x BK
// channels, zero-filled at the padding and past C) and the matching W tile
// (BK x BN) into shared memory, converted to float32; each thread then keeps
// a TM x TN micro-tile of float32 accumulators in registers and runs plain
// FMAs over the chunk.  A tap's C products go into a partial sum of their
// own, which is added to the accumulator when the tap is done (as the TPU
// kernel adds one matrix product per tap row); with one running sum of all
// 9C products the float32 error at C = 192 exceeded the 2e-5 bar, with the
// partials it stays within 4e-6 of a float64 sum (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  Every output is summed by one thread in one fixed
// order (bias, then tap by tap, channel by channel), with no atomics.
//
// All three take any H, W, B: rows past M are masked, and offsets are 64-bit
// (the U-Net's largest input is 42 M elements and M*C*9 exceeds 2^31
// elsewhere).  The card's times of each are in PERF.md.

#include <stdint.h>

#include <mutex>
#include <set>

#include "common.cuh"

namespace {

constexpr int BM = 128;                 // output rows per block
constexpr int BN = 64;                  // output channels per block
constexpr int BK = 16;                  // input channels per shared-memory stage
constexpr int TM = 8;                   // output rows per thread
constexpr int TN = 4;                   // output channels per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int A_ROWS = NT / BK;         // rows one pass of the block loads: 16
constexpr int A_PER_THREAD = BM / A_ROWS;  // 8
constexpr int W_PER_THREAD = BK * BN / NT;  // 4
constexpr int A_PAD = 4;                // keeps the transposed stores off one bank

static_assert(BM % A_ROWS == 0 && (BK * BN) % NT == 0, "tile shapes");
static_assert(TM == 8 && TN == 4, "the inner loop reads two float4 of A, one of W");

template <typename T>
__global__ void __launch_bounds__(NT)
conv3x3_hwbc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out, int H, int W,
                    int B, int C, int O) {
    __shared__ __align__(16) float a_s[BK][BM + A_PAD];
    __shared__ __align__(16) float w_s[BK][BN];

    const int tid = threadIdx.x;
    const int64_t M = (int64_t)H * W * B;
    const int64_t m0 = (int64_t)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    // This thread's share of the A tile: channel a_c of rows a_r + i * A_ROWS
    // (16 neighbouring threads read 16 neighbouring channels of one pixel).
    // For each, the pixel's (h, w); a row past M gets an h that no tap can
    // bring into the image.  Row m's channel 0 is element m * C.
    const int a_c = tid % BK, a_r = tid / BK;
    const int64_t a_off = (m0 + a_r) * C;
    int hh[A_PER_THREAD], ww[A_PER_THREAD];
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
        const int64_t m = m0 + a_r + i * A_ROWS;
        if (m < M) {
            const int64_t p = m / B;
            ww[i] = (int)(p % W);
            hh[i] = (int)(p / W);
        } else {
            ww[i] = 0;
            hh[i] = -4;
        }
    }

    // This thread's outputs: rows ty * TM + i, channels tx * TN + j.
    const int tx = tid % (BN / TN), ty = tid / (BN / TN);
    float acc[TM][TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        const float bj = n < O ? bias[n] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = bj;
    }

    for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        // rows of the same b, one pixel step in h is W*B rows, in w B rows
        const int64_t shift = ((int64_t)dy * W + dx) * B * C;
        const T* w_tap = w + (int64_t)tap * C * O;
        float part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
        for (int c0 = 0; c0 < C; c0 += BK) {
            const int c = c0 + a_c;
#pragma unroll
            for (int i = 0; i < A_PER_THREAD; ++i) {
                const int h = hh[i] + dy, wp = ww[i] + dx;
                float v = 0.f;
                if (c < C && h >= 0 && h < H && wp >= 0 && wp < W)
                    v = to_float<T>(x[a_off + (int64_t)i * A_ROWS * C + shift + c]);
                a_s[a_c][a_r + i * A_ROWS] = v;
            }
#pragma unroll
            for (int i = 0; i < W_PER_THREAD; ++i) {
                const int e = tid + i * NT;
                const int k = e / BN, n = e % BN;
                float v = 0.f;
                if (c0 + k < C && n0 + n < O) v = to_float<T>(w_tap[(int64_t)(c0 + k) * O + n0 + n]);
                w_s[k][n] = v;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[k][ty * TM]);
                const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[k][ty * TM + 4]);
                const float4 wv = *reinterpret_cast<const float4*>(&w_s[k][tx * TN]);
                const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                                     a_hi.x, a_hi.y, a_hi.z, a_hi.w};
                const float b[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
            }
            __syncthreads();  // the tiles have been consumed
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int64_t m = m0 + ty * TM + i;
        if (m >= M) continue;
        T* op = out + m * O;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int n = n0 + tx * TN + j;
            if (n < O) op[n] = from_float<T>(acc[i][j]);
        }
    }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int WG_GROUPS = 2;   // warpgroups per block, 64 output rows each
constexpr int WG_BM = 64 * WG_GROUPS;
constexpr int WG_THREADS = 128 * WG_GROUPS;
constexpr int WG_BK = 64;      // input channels per stage: one 128-byte row
constexpr int WG_STAGES = 3;   // slots in the cp.async ring
constexpr int WG_AHEAD = 1;    // stages copied ahead of the one multiplied
constexpr int A_BYTES = WG_BM * WG_BK * 2;  // one A slot
// The copies of stage kit + WG_AHEAD refill the slot of stage kit - 2, whose
// products the wait at the end of iteration kit - 1 has finished.
static_assert(WG_STAGES == WG_AHEAD + 2, "ring depth");

// Dynamic shared memory of one block: the ring of A slots and W slots
// (WG_BK x BN: 8 or 16 KB), 1024-byte aligned for the 128-byte swizzle, and
// the slack that aligns its start.
template <int BN> __host__ __device__ constexpr size_t wg_smem_bytes() {
    return (size_t)WG_STAGES * (A_BYTES + WG_BK * BN * 2) + 1024;
}

// d += a b over k = 16 for a 64-row A (K-major) and an N-column B (N-major),
// both in shared memory; d is the warpgroup's 64 x N float32 accumulator.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
            "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
            "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
            "+f"(d[31])
          : "l"(a), "l"(b)
          : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
            "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
            "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
            "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
            "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
            "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
            "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
            "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
            "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
            "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b)
          : "memory");
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS)
conv3x3_hwbc_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                          int B, int C, int O) {
    constexpr int W_BYTES = WG_BK * BN * 2;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    unsigned char* a_ring = smem;                          // slot s at s * A_BYTES
    unsigned char* w_ring = smem + WG_STAGES * A_BYTES;    // slot s at s * W_BYTES

    const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;
    const int64_t M = (int64_t)H * W * B;
    const int64_t m0 = (int64_t)blockIdx.x * WG_BM;
    const int n0 = blockIdx.y * BN;

    // This thread's share of an A stage: 16-byte chunk `ac` (channels 8 ac
    // .. 8 ac + 7 of the stage) of rows ar + A_STEP i, read from x_row +
    // A_STEP i C plus the tap's shift.  Bit `tap` of taps_ok[i] says whether
    // the tap's input pixel lies in the image (none for a row past M).
    constexpr int A_STEP = WG_THREADS / 8, A_ITERS = WG_BM / A_STEP;
    const int ac = tid & 7, ar = tid >> 3;
    const bf16* x_row = x + (m0 + ar) * C + ac * 8;
    uint32_t taps_ok[A_ITERS];
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
        const int64_t m = m0 + ar + A_STEP * i;
        uint32_t ok = 0;
        if (m < M) {
            const int64_t p = m / B;
            const int wq = (int)(p % W), hq = (int)(p / W);
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int h = hq + tap / 3 - 1, wp = wq + tap % 3 - 1;
                if (h >= 0 && h < H && wp >= 0 && wp < W) ok |= 1u << tap;
            }
        }
        taps_ok[i] = ok;
    }
    // ... and of a W stage (WG_BK rows of the (9C, O) matrix x BN columns, as
    // BN / 64 atoms of 64 columns): chunk `wc` (8 columns) of rows wr + k_step j.
    constexpr int W_CHUNKS = BN / 8, W_STEP = WG_THREADS / W_CHUNKS, W_ITERS = WG_BK / W_STEP;
    static_assert(WG_BM % A_STEP == 0 && WG_BK % W_STEP == 0, "staging shapes");
    const int wc = tid % W_CHUNKS, wr = tid / W_CHUNKS;
    const bool w_col_ok = n0 + wc * 8 < O;
    const bf16* w_row = w + (int64_t)wr * O + n0 + wc * 8;
    const uint32_t w_atom = (uint32_t)(wc / 8) * (WG_BK * 128);

    const int chunks = (C + WG_BK - 1) / WG_BK;
    const int kiters = 9 * chunks;  // tap-major: tap, then chunk of WG_BK channels

    // Issues the copies of k-iteration `kit` into ring slot `slot`: for tap
    // (dy, dx) the A tile is WG_BM contiguous rows of x shifted by (dy W +
    // dx) B rows, zero where the pixel leaves the image or the channel
    // passes C; the W tile is rows tap C + c0 .. of the (9C, O) matrix,
    // zero past C and past O.  Both land in the swizzled layout.
    auto load_stage = [&](int slot, int kit) {
        const int tap = kit / chunks, c0 = (kit - tap * chunks) * WG_BK;
        const bf16* xa = x_row + ((int64_t)(tap / 3 - 1) * W + (tap % 3 - 1)) * B * C + c0;
        const bool c_ok = c0 + ac * 8 < C;
        unsigned char* a = a_ring + slot * A_BYTES;
#pragma unroll
        for (int i = 0; i < A_ITERS; ++i) {
            const bool valid = c_ok && ((taps_ok[i] >> tap) & 1u);
            cp_async16(a + swizzled(ar + A_STEP * i, ac),
                       valid ? xa + (int64_t)A_STEP * i * C : x, valid);
        }
        const bf16* wa = w_row + ((int64_t)tap * C + c0) * O;
        unsigned char* wt = w_ring + slot * W_BYTES + w_atom;
#pragma unroll
        for (int j = 0; j < W_ITERS; ++j) {
            const int k = wr + j * W_STEP;
            const bool valid = w_col_ok && c0 + k < C;
            cp_async16(wt + swizzled(k, wc % 8), valid ? wa + (int64_t)j * W_STEP * O : w, valid);
        }
    };

    // The warpgroup's 64 x BN accumulator starts at the bias: lane 4g + t
    // of warp q holds rows 16 q + g and + 8, columns 8 j + 2t and + 1.
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * (lane & 3);
        acc[4 * j] = acc[4 * j + 2] = col < O ? bias[col] : 0.f;
        acc[4 * j + 1] = acc[4 * j + 3] = col + 1 < O ? bias[col + 1] : 0.f;
    }

#pragma unroll
    for (int s = 0; s < WG_AHEAD; ++s) {
        if (s < kiters) load_stage(s, s);
        cp_async_commit();
    }
    for (int kit = 0; kit < kiters; ++kit) {
        // Stage kit has landed; after the barrier every warpgroup is also
        // done with the products of stage kit - 2, whose slot the next
        // copies refill.
        cp_async_wait<WG_AHEAD - 1>();
        fence_proxy_async();
        __syncthreads();
        const int next = kit + WG_AHEAD;
        if (next < kiters) load_stage(next % WG_STAGES, next);
        cp_async_commit();

        const int slot = kit % WG_STAGES;
        const unsigned char* a = a_ring + slot * A_BYTES + wg * 64 * 128;
        const unsigned char* b = w_ring + slot * W_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
            wgmma_bf16<BN>(acc, wgmma_desc(a + kk * 32, 16),
                           wgmma_desc(b + kk * 16 * 128, WG_BK * 128));
        wgmma_commit();
        wgmma_wait<1>();  // the products of stage kit - 1 are done
    }
    wgmma_wait<0>();
    cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)
    __syncthreads();     // every warpgroup is done with the ring, which now holds the output

    // The output tile through shared memory, so that every store to device
    // memory is a whole 16-byte piece of a row.
    constexpr int OL = BN + 8;
    bf16 (*o_s)[OL] = reinterpret_cast<bf16 (*)[OL]>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<uint32_t*>(&o_s[r][j * 8 + 2 * (lane & 3)]) =
                pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    __syncthreads();
    for (int e = tid; e < WG_BM * (BN / 8); e += WG_THREADS) {
        const int r = e / (BN / 8), c = e % (BN / 8) * 8;
        const int64_t m = m0 + r;
        if (m < M && n0 + c < O)  // O % 8 == 0: the whole piece
            *reinterpret_cast<uint4*>(out + m * O + n0 + c) =
                *reinterpret_cast<const uint4*>(&o_s[r][c]);
    }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores, in 3xTF32.

constexpr int TF_BM = 128;         // output rows per block
constexpr int TF_THREADS = 256;    // eight warps: 4 along the rows x 2 along the columns
constexpr int TF_BK = 32;          // input channels per stage: one 128-byte row
constexpr int TF_STAGES = 3;       // slots in the cp.async ring
constexpr int TF_AHEAD = TF_STAGES - 1;  // stages copied ahead of the one multiplied
constexpr int TF_A_BYTES = TF_BM * TF_BK * 4;  // one A slot

// A W slot's row: BN floats and 8 of padding (a row is 8 banks past a
// multiple of 32), so that a B fragment's reads (lane 4g + t: rows t and
// t + 4, column g) fall in banks 8t + g.  The output tile goes through
// shared memory in rows of the same width.
template <int BN> __host__ __device__ constexpr int tf_row() { return BN + 8; }

// Dynamic shared memory of one block: the ring of A and W slots.
template <int BN> __host__ __device__ constexpr size_t tf_smem_bytes() {
    return (size_t)TF_STAGES * (TF_A_BYTES + TF_BK * tf_row<BN>() * 4);
}

template <int BN>
__global__ void __launch_bounds__(TF_THREADS, BN == 64 ? 2 : 1)
conv3x3_hwbc_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                         int B, int C, int O) {
    constexpr int LDW = tf_row<BN>();
    constexpr int W_BYTES = TF_BK * LDW * 4;
    constexpr int WN = BN / 2;  // a warp's columns
    constexpr int NJ = WN / 8;  // its n-tiles
    static_assert((size_t)TF_BM * LDW * 4 <= tf_smem_bytes<BN>(), "output tile");
    extern __shared__ __align__(128) unsigned char tf_smem[];
    unsigned char* a_ring = tf_smem;                         // slot s at s * TF_A_BYTES
    unsigned char* w_ring = tf_smem + TF_STAGES * TF_A_BYTES;  // slot s at s * W_BYTES

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 1, wn = warp & 1;  // rows 32 wm .., columns WN wn ..
    const int g = lane >> 2, t = lane & 3;
    const int64_t M = (int64_t)H * W * B;
    const int64_t m0 = (int64_t)blockIdx.x * TF_BM;
    const int n0 = blockIdx.y * BN;

    // This thread's share of an A stage, as in the bf16 kernel: 16-byte
    // piece `ac` (channels 4 ac .. 4 ac + 3 of the stage) of rows ar +
    // A_STEP i, with the 9-bit mask of the taps whose pixel lies in the
    // image (none for a row past M).
    constexpr int A_STEP = TF_THREADS / 8, A_ITERS = TF_BM / A_STEP;
    const int ac = tid & 7, ar = tid >> 3;
    const float* x_row = x + (m0 + ar) * C + ac * 4;
    uint32_t taps_ok[A_ITERS];
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
        const int64_t m = m0 + ar + A_STEP * i;
        uint32_t ok = 0;
        if (m < M) {
            const int64_t p = m / B;
            const int wq = (int)(p % W), hq = (int)(p / W);
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int h = hq + tap / 3 - 1, wp = wq + tap % 3 - 1;
                if (h >= 0 && h < H && wp >= 0 && wp < W) ok |= 1u << tap;
            }
        }
        taps_ok[i] = ok;
    }
    // ... and of a W stage (TF_BK rows of the (9C, O) matrix x BN columns):
    // piece `wc` (4 columns) of rows wr + W_STEP j.
    constexpr int W_PIECES = BN / 4, W_STEP = TF_THREADS / W_PIECES, W_ITERS = TF_BK / W_STEP;
    static_assert(TF_BM % A_STEP == 0 && TF_BK % W_STEP == 0, "staging shapes");
    const int wc = tid % W_PIECES, wr = tid / W_PIECES;
    const bool w_col_ok = n0 + wc * 4 < O;
    const float* w_row = w + (int64_t)wr * O + n0 + wc * 4;

    const int chunks = (C + TF_BK - 1) / TF_BK;
    const int kiters = 9 * chunks;  // tap-major: tap, then chunk of TF_BK channels

    // Issues the copies of stage `kit` into ring slot `slot`: for tap (dy,
    // dx) the A tile is TF_BM contiguous rows of x shifted by (dy W + dx) B
    // rows, zero where the pixel leaves the image or the channel passes C,
    // in the swizzled layout; the W tile is rows tap C + c0 .. of the (9C,
    // O) matrix, zero past C and past O, in padded rows.
    auto load_stage = [&](int slot, int kit) {
        const int tap = kit / chunks, c0 = (kit - tap * chunks) * TF_BK;
        const float* xa = x_row + ((int64_t)(tap / 3 - 1) * W + (tap % 3 - 1)) * B * C + c0;
        const bool c_ok = c0 + ac * 4 < C;
        unsigned char* a = a_ring + slot * TF_A_BYTES;
#pragma unroll
        for (int i = 0; i < A_ITERS; ++i) {
            const bool valid = c_ok && ((taps_ok[i] >> tap) & 1u);
            cp_async16(a + swizzled(ar + A_STEP * i, ac),
                       valid ? xa + (int64_t)A_STEP * i * C : x, valid);
        }
        const float* wa = w_row + ((int64_t)tap * C + c0) * O;
        unsigned char* wt = w_ring + slot * W_BYTES;
#pragma unroll
        for (int j = 0; j < W_ITERS; ++j) {
            const int k = wr + j * W_STEP;
            const bool valid = w_col_ok && c0 + k < C;
            cp_async16(wt + (k * LDW + wc * 4) * 4, valid ? wa + (int64_t)j * W_STEP * O : w,
                       valid);
        }
    };

    // The warp's 32 x WN accumulator starts at the bias: m-tile i, n-tile j,
    // lane 4g + t holds rows 32 wm + 16 i + g and + 8, columns WN wn + 8 j +
    // 2t and + 1.
    float acc[2][NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int col = n0 + WN * wn + 8 * j + 2 * t;
        const float b0 = col < O ? bias[col] : 0.f, b1 = col + 1 < O ? bias[col + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            acc[i][j][0] = acc[i][j][2] = b0;
            acc[i][j][1] = acc[i][j][3] = b1;
        }
    }

    // A warp whose rows all lie past M, or whose columns all lie past O
    // (a small or ragged call), copies its share but multiplies nothing.
    const bool busy = m0 + 32 * wm < M && n0 + WN * wn < O;
#pragma unroll
    for (int s = 0; s < TF_AHEAD; ++s) {
        if (s < kiters) load_stage(s, s);
        cp_async_commit();
    }
    for (int kit = 0; kit < kiters; ++kit) {
        // Stage kit has landed; after the barrier every warp is also done
        // with stage kit - 1, whose slot the next copies refill.
        cp_async_wait<TF_AHEAD - 1>();
        __syncthreads();
        const int next = kit + TF_AHEAD;
        if (next < kiters) load_stage(next % TF_STAGES, next);
        cp_async_commit();

        if (!busy) continue;  // nothing of this warp's tile is in the output
        const int slot = kit % TF_STAGES;
        const unsigned char* a = a_ring + slot * TF_A_BYTES;
        const float* ws = reinterpret_cast<const float*>(w_ring + slot * W_BYTES) + WN * wn + g;
        float part[2][NJ][4] = {};
#pragma unroll
        for (int ks = 0; ks < TF_BK / 8; ++ks) {
            // A: one `ldmatrix.x4` an m-tile (lane l: row l % 8 + 8 (l / 8 %
            // 2), piece 2 ks + l / 16; on rows of floats it hands lane 4g + t
            // the float at column t of row g of each 8 x 4 matrix).
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                uint32_t f[4];
                ldsm_x4(f, a + swizzled(32 * wm + 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8,
                                        2 * ks + (lane >> 4)));
#pragma unroll
                for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(f[e]), ah[i][e], al[i][e]);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float* wb = ws + (8 * ks + t) * LDW + 8 * j;
                uint32_t bh[2], bl[2];
                split_tf32(wb[0], bh[0], bl[0]);
                split_tf32(wb[4 * LDW], bh[1], bl[1]);
#pragma unroll
                for (int i = 0; i < 2; ++i) mma_3xtf32(part[i][j], ah[i], al[i], bh, bl);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    cp_async_wait<0>();  // no copy outlives the block (the last groups are empty)
    __syncthreads();     // every warp is done with the ring, which now holds the output

    // The output tile through shared memory, so that every store to device
    // memory is a whole 16-byte piece of a row.
    float (*o_s)[LDW] = reinterpret_cast<float (*)[LDW]>(tf_smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 32 * wm + 16 * i + g + 8 * h;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                *reinterpret_cast<float2*>(&o_s[r][WN * wn + 8 * j + 2 * t]) =
                    make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    __syncthreads();
    for (int e = tid; e < TF_BM * (BN / 4); e += TF_THREADS) {
        const int r = e / (BN / 4), c = e % (BN / 4) * 4;
        const int64_t m = m0 + r;
        if (m < M && n0 + c < O)  // O % 8 == 0: the whole piece
            *reinterpret_cast<float4*>(out + m * O + n0 + c) =
                *reinterpret_cast<const float4*>(&o_s[r][c]);
    }
}

// Before a ring kernel's first launch on a device: allow it the dynamic
// shared memory its ring needs (beyond the default 48 KB).
template <int BN, bool TF32>
cudaError_t prepare_ring() {
    static std::mutex mutex;
    static std::set<int> prepared;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex);
    if (!prepared.count(device)) {
        err = TF32 ? cudaFuncSetAttribute(conv3x3_hwbc_tf32_kernel<BN>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)tf_smem_bytes<BN>())
                   : cudaFuncSetAttribute(conv3x3_hwbc_wgmma_kernel<BN>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)wg_smem_bytes<BN>());
        if (err != cudaSuccess) return err;
        prepared.insert(device);
    }
    return cudaSuccess;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const float* bias, void* out, int H, int W, int B,
                 int C, int O, int64_t M, cudaStream_t stream) {
    const int64_t blocks_m = (M + WG_BM - 1) / WG_BM;
    const int blocks_n = (O + BN - 1) / BN;
    if (blocks_m > INT32_MAX || blocks_n > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err = prepare_ring<BN, false>();
    if (err != cudaSuccess) return (int)err;
    conv3x3_hwbc_wgmma_kernel<BN><<<dim3((unsigned)blocks_m, blocks_n), WG_THREADS,
                                    wg_smem_bytes<BN>(), stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<bf16*>(out),
        H, W, B, C, O);
    return (int)cudaGetLastError();
}

template <int BN>
int launch_tf32(const void* x, const void* w, const float* bias, void* out, int H, int W, int B,
                int C, int O, int64_t M, cudaStream_t stream) {
    const int64_t blocks_m = (M + TF_BM - 1) / TF_BM;
    const int blocks_n = (O + BN - 1) / BN;
    if (blocks_m > INT32_MAX || blocks_n > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t err = prepare_ring<BN, true>();
    if (err != cudaSuccess) return (int)err;
    conv3x3_hwbc_tf32_kernel<BN><<<dim3((unsigned)blocks_m, blocks_n), TF_THREADS,
                                   tf_smem_bytes<BN>(), stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(out), H, W, B, C, O);
    return (int)cudaGetLastError();
}

// Which kernel a call goes to (ops/kernels/conv3x3.py::route mirrors it):
// the tensor-core kernels take C and O multiples of 8, so that every A and
// W row is whole 16-byte pieces for cp.async; bfloat16 goes to `wgmma`,
// float32 to 3xTF32 (whose products keep the 2e-5 bar, which bf16 products
// cannot); a ragged C or O goes to the FMA kernel.
enum class Route { fma, wgmma, tf32 };

Route route(int is_bf16, int C, int O) {
    if (C % 8 != 0 || O % 8 != 0) return Route::fma;
    return is_bf16 ? Route::wgmma : Route::tf32;
}

}  // namespace

// x: (H, W, B, C) contiguous; w: (3, 3, C, O) contiguous, of x's type;
// bias: (O,) float32; out: (H, W, B, O) contiguous, of x's type; on the
// tensor-core routes ("wgmma", "tf32") x, w and out 16-byte aligned.
// H*W*B / 128 blocks at most 2^31 - 1, O / 64 at most 65535.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int unet_conv3x3_hwbc(const void* x, const void* w, const float* bias, void* out,
                                 int H, int W, int B, int C, int O, int is_bf16,
                                 cudaStream_t stream) {
    if (H <= 0 || W <= 0 || B <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
    const int64_t M = (int64_t)H * W * B;
    switch (route(is_bf16, C, O)) {
        case Route::wgmma:
            return O > 64 ? launch_wgmma<128>(x, w, bias, out, H, W, B, C, O, M, stream)
                          : launch_wgmma<64>(x, w, bias, out, H, W, B, C, O, M, stream);
        case Route::tf32:
            return O > 64 ? launch_tf32<128>(x, w, bias, out, H, W, B, C, O, M, stream)
                          : launch_tf32<64>(x, w, bias, out, H, W, B, C, O, M, stream);
        case Route::fma:
            break;
    }
    const int64_t blocks_m = (M + BM - 1) / BM;
    const int blocks_n = (O + BN - 1) / BN;
    if (blocks_m > INT32_MAX || blocks_n > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks_m, blocks_n);
    if (is_bf16) {
        using T = __nv_bfloat16;
        conv3x3_hwbc_kernel<T><<<grid, NT, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(w), bias,
            static_cast<T*>(out), H, W, B, C, O);
    } else {
        conv3x3_hwbc_kernel<float><<<grid, NT, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), bias,
            static_cast<float*>(out), H, W, B, C, O);
    }
    return (int)cudaGetLastError();
}
