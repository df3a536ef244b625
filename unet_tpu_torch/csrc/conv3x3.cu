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
// Design.  A block computes a BM x BN tile of the output.  For each tap and
// each chunk of BK input channels it gathers the A tile (BM rows x BK
// channels, zero-filled at the padding and past C) and the matching W tile
// (BK x BN) into shared memory, converted to float32; each thread then keeps
// a TM x TN micro-tile of float32 accumulators in registers and runs plain
// FMAs over the chunk.  A tap's C products go into a partial sum of their
// own, which is added to the accumulator when the tap is done (as the TPU
// kernel adds one matrix product per tap row); with one running sum of all
// 9C products the float32 error at C = 192 exceeded the 2e-5 bar, with the
// partials it stays within 4e-6 of a float64 sum (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  Any H, W, B, C, O is taken: rows past M, channels
// past C and outputs past O are masked.  Every output is summed by one
// thread in one fixed order (bias, then tap by tap, channel by channel), with
// no atomics, so a rerun gives the same bits.  Offsets are 64-bit: the
// U-Net's largest input is 42 M elements and M*C*9 exceeds 2^31 elsewhere.
// Tensor-core products (mma.sync, wgmma) and TMA staging are left for a
// later change.

#include <stdint.h>

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

}  // namespace

// x: (H, W, B, C) contiguous; w: (3, 3, C, O) contiguous, of x's type;
// bias: (O,) float32; out: (H, W, B, O) contiguous, of x's type.  H*W*B / 128
// blocks at most 2^31 - 1, O / 64 at most 65535.  Returns the CUDA error code
// of the launch (0 = success).
extern "C" int unet_conv3x3_hwbc(const void* x, const void* w, const float* bias, void* out,
                                 int H, int W, int B, int C, int O, int is_bf16,
                                 cudaStream_t stream) {
    if (H <= 0 || W <= 0 || B <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
    const int64_t M = (int64_t)H * W * B;
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
