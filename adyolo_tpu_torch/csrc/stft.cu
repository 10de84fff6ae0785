// Fused framed STFT for Hopper (sm_90a), fp32 FFMA.
//
// Replaces the TPU kernel adyolo_tpu/ops/pallas_stft.py::_make_kernel /
// _pallas_stft_impl (the Pallas fused framed STFT).  It computes what that
// kernel computes -- the windowed real DFT of librosa center=True frames,
// re/im = sum over the frame of samples x window-folded DFT matrices -- for
// the DCASE geometry n_fft == 2*hop, straight from the hop-block audio
// (B, T, hop, 4) that the loaders produce.  Frames are never built.
//
// As a GEMM:  C[(b,t), k] = sum_n A[(b,t), n] * W[n, k],  n < n_fft,
//   * every A element is a float4: the 4 FOA channels travel together;
//   * n <  hop, t >= 1: A = chunks[b, t-1, n]
//   * n <  hop, t == 0: A = x_flat[b, hop - n]   (reflect block, from the
//                                                   index; no padded copy)
//   * n >= hop:         A = chunks[b, t, n-hop]
//   For t >= 1 both halves are the contiguous run x_flat[b, (t-1)*hop + n].
//   * W = [W_re | W_im], packed by the wrapper as (n_fft, 2*KP) with each
//     half zero-padded from K = 1 + n_fft/2 to KP, a multiple of BN.
//
// What bounds it on an H100: at B=16 and 20-s clips (T=800) the contraction
// is 2*(16*800*4)*1200*1202 = 1.48e11 FLOP against ~123 MB of audio in,
// ~246 MB of re/im out and 5.8 MB of W: ~390 FLOP/byte, compute-bound at
// fp32 (67 TFLOP/s FFMA peak vs 3.35 TB/s).  TF32 tensor cores would be
// faster but too coarse for the front-end's error budget, so the design is
// a plain shared-memory-tiled SGEMM with register blocking: a 64x64
// (frames x bins) block tile, a 16-deep k-step, a 4x4 (x4 channels, x re/im)
// register tile per thread -- 128 FFMA per 24 shared-memory words read --
// and the next k-step's global loads prefetched into registers while the
// current one is multiplied.  Channel-innermost layouts give 16-byte
// coalesced float4 loads of audio and stores of re/im.  wgmma/TMA
// (3xTF32) and fusing the power/mel/IV epilogue are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // frames per block tile
constexpr int BN = 64;        // frequency bins per block tile
constexpr int BK = 16;        // depth per k-step
constexpr int TM = 4;         // frames per thread (strided by 16)
constexpr int TN = 4;         // bins per thread (strided by 16)
constexpr int THREADS = 256;  // 16 x 16
constexpr int A_PER_THREAD = BM * BK / THREADS;   // 4 float4
constexpr int B_ROWS_PER_PASS = THREADS / (BN / 4);  // 16

__device__ __forceinline__ void fma4(float4& acc, const float4& a, float w) {
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
}

__global__ void __launch_bounds__(THREADS)
stft_hop_blocks_kernel(const float4* __restrict__ x, long long clip_stride,
                       int T, int M, int hop,
                       const float* __restrict__ w, int KP, int K,
                       float4* __restrict__ re, float4* __restrict__ im) {
    __shared__ float4 As[BK][BM + 1];  // +1: conflict-free transposed stores
    __shared__ __align__(16) float Bre[BK][BN];
    __shared__ __align__(16) float Bim[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int k0 = blockIdx.x * BN;
    const long long m0 = (long long)blockIdx.y * BM;
    const int n_fft = 2 * hop;

    // A loads: thread reads depth column ac of rows ar + 16*p
    const int ac = tid % BK;
    const int ar = tid / BK;
    // a_base: float4 index of x_flat[b, (t-1)*hop] for t >= 1, of
    // x_flat[b, 0] for t == 0 (reflect block)
    long long a_base[A_PER_THREAD];
    bool a_first[A_PER_THREAD];
    bool a_valid[A_PER_THREAD];
#pragma unroll
    for (int p = 0; p < A_PER_THREAD; ++p) {
        const long long m = m0 + ar + 16 * p;
        const long long b = m / T;
        const long long t = m - b * T;
        a_valid[p] = m < M;
        a_first[p] = (t == 0);
        a_base[p] = b * clip_stride + (t == 0 ? 0 : (t - 1) * hop);
    }
    // B loads: thread reads float4 columns bc..bc+3 of depth rows br + 16*q
    const int bc = (tid % (BN / 4)) * 4;
    const int br = tid / (BN / 4);
    const long long w_stride = 2LL * KP;

    float4 a_reg[A_PER_THREAD];
    float4 bre_reg[BK / B_ROWS_PER_PASS];
    float4 bim_reg[BK / B_ROWS_PER_PASS];

    auto load_global = [&](int kt) {
        const int n = kt + ac;
#pragma unroll
        for (int p = 0; p < A_PER_THREAD; ++p) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (a_valid[p]) {
                int off = n;
                if (a_first[p]) off = n < hop ? hop - n : n - hop;  // refl[n] = x_flat[hop - n]
                v = __ldg(x + a_base[p] + off);
            }
            a_reg[p] = v;
        }
#pragma unroll
        for (int q = 0; q < BK / B_ROWS_PER_PASS; ++q) {
            const float* row = w + (long long)(kt + br + q * B_ROWS_PER_PASS) * w_stride;
            bre_reg[q] = __ldg(reinterpret_cast<const float4*>(row + k0 + bc));
            bim_reg[q] = __ldg(reinterpret_cast<const float4*>(row + KP + k0 + bc));
        }
    };

    float4 acc_re[TM][TN];
    float4 acc_im[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            acc_re[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
            acc_im[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    load_global(0);
    for (int kt = 0; kt < n_fft; kt += BK) {
#pragma unroll
        for (int p = 0; p < A_PER_THREAD; ++p) As[ac][ar + 16 * p] = a_reg[p];
#pragma unroll
        for (int q = 0; q < BK / B_ROWS_PER_PASS; ++q) {
            *reinterpret_cast<float4*>(&Bre[br + q * B_ROWS_PER_PASS][bc]) = bre_reg[q];
            *reinterpret_cast<float4*>(&Bim[br + q * B_ROWS_PER_PASS][bc]) = bim_reg[q];
        }
        __syncthreads();
        if (kt + BK < n_fft) load_global(kt + BK);  // overlaps the FFMAs below

#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float4 a[TM];
            float wr[TN], wi[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                wr[j] = Bre[kk][tx + 16 * j];
                wi[j] = Bim[kk][tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    fma4(acc_re[i][j], a[i], wr[j]);
                    fma4(acc_im[i][j], a[i], wi[j]);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int k = k0 + tx + 16 * j;
            if (k < K) {
                re[m * K + k] = acc_re[i][j];
                im[m * K + k] = acc_im[i][j];
            }
        }
    }
}

}  // namespace

// C entry point (bound with ctypes).  x: (B, T, hop, 4) float32 hop-block
// audio, or flat (B, N, 4) with clip_stride = N (float4 units); w: packed
// (2*hop, 2*KP) float32; re, im: (B, T, K, 4) float32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int adyolo_stft_hop_blocks(const void* x, int clip_stride, int B,
                                      int T, int hop, const void* w, int KP,
                                      int K, void* re, void* im,
                                      void* stream) {
    const long long M = (long long)B * T;
    if (B < 1 || T < 2 || hop < 1 || (2 * hop) % BK != 0 || KP % BN != 0 ||
        K > KP || M > 0x7fffffffLL || (M + BM - 1) / BM > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    dim3 grid(KP / BN, (unsigned)((M + BM - 1) / BM));
    stft_hop_blocks_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const float4*>(x), (long long)clip_stride, T, (int)M, hop,
        static_cast<const float*>(w), KP, K, static_cast<float4*>(re),
        static_cast<float4*>(im));
    return (int)cudaGetLastError();
}
