// Framed STFT for Hopper (sm_90a): a mixed-radix Stockham FFT in shared
// memory, in two kernels: `stft_hop_blocks_fft_kernel` for the DCASE
// geometry n_fft = 2*hop (described first), and `stft_frames_fft_kernel`
// for flat audio at any hop (its own section below).
//
// Replaces the TPU kernel adyolo_tpu/ops/pallas_stft.py::_make_kernel /
// _pallas_stft_impl (the Pallas fused framed STFT).  It computes what that
// kernel computes -- the windowed real DFT of librosa center=True frames --
// for the DCASE geometry n = n_fft = 2*hop, straight from the hop-block
// audio (B, T, hop, 4) that the loaders produce (or flat (B, N, 4), read as
// its hop-block view):
//   re/im[b, t, k, c] = Re/Im sum_{m < n} frame_t[m, c] w[m] e^{-2 pi i k m / n},
//   k <= n/2, frame t = [block t-1, block t], and frame 0's left half the
//   reflect block refl[m] = x_flat[b, hop - m] (read from the index).
// The TPU kernel contracts the frames against window-folded DFT matrices
// on the MXU; this kernel runs an FFT instead, n log n work, no matrix.
//
// Design.  A block owns F = CAP / n consecutive frames of one clip (F = 2
// at n = 1200) and reads the F + 1 hop-blocks they span once, as float4
// (the 4 FOA channels), coalesced, each thread issuing all its loads
// before its first store, so that a block keeps ~29 KB in flight.  Each
// sample is windowed into the left half of one frame and the right half
// of the one before it, in shared memory.  A float4 is two complex sequences, z0 = c0 + i c1 and
// z1 = c2 + i c3, so one complex n-point FFT per float4 lane pair does two
// real channels; both share every twiddle.  The FFT is a Stockham autosort
// in passes of radix 4, 2, 3 and 5 (4, 4, 3, 5, 5 at n = 1200; the plan
// comes from ops/hopper_stft.py::fft_plan), between two shared-memory
// buffers, one barrier a pass; a thread holds one butterfly at a time, so
// nothing spills.  The twiddles e^{-2 pi i m / n} and the window come from
// a float32 table built in float64 on the host (no __sinf/__cosf), read
// through L1.  The last step splits the pairs,
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2,  X_b[k] = (Z[k] - conj Z[n-k]) / 2i,
// and writes bins 0..n/2 as float4 re and im, channel-last, coalesced.
//
// What bounds it on an H100: memory.  At B = 16, T = 800 it reads 123 MB
// of audio and writes 246 MB of re/im (0.110 ms at 3.35 TB/s) for 1.6
// GFLOP of FFT.  Inside the block, the passes move each frame through
// shared memory ~13 times (~3.2 GB in all, ~0.1 ms at the card's shared-
// memory rate); 77 KB of shared memory a block, 2 blocks per SM.

#include <cuda_runtime.h>

#include "errors.cuh"

using adyolo::check_launch;
using adyolo::enter;
using adyolo::fail;

namespace {

constexpr int THREADS = 256;
constexpr int CAP = 2400;        // float4 slots of each of a block's two buffers: the largest n
constexpr int MAX_PASSES = 16;
constexpr int MAX_N = 4096;      // the frames kernel's largest n
constexpr int FRAME_SLOTS = 2400;  // the frames kernel's float4 slots a buffer, at n <= 1200

struct Plan {
    int n_pass;
    int radix[MAX_PASSES];
};

__device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 sub(float4 a, float4 b) {
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float4 scale(float4 a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// a + s * b
__device__ __forceinline__ float4 axpy(float4 a, float s, float4 b) {
    return make_float4(fmaf(s, b.x, a.x), fmaf(s, b.y, a.y), fmaf(s, b.z, a.z),
                       fmaf(s, b.w, a.w));
}

// both complex numbers times -i: (x + iy)(-i) = y - ix
__device__ __forceinline__ float4 times_minus_i(float4 a) {
    return make_float4(a.y, -a.x, a.w, -a.z);
}

// both complex numbers times w
__device__ __forceinline__ float4 twiddle(float4 a, float2 w) {
    return make_float4(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x,
                       a.z * w.x - a.w * w.y, a.z * w.y + a.w * w.x);
}

// In-place forward DFT of radix R (e^{-2 pi i / R}) on v[0..R).
template <int R>
__device__ __forceinline__ void dft(float4* v);

template <>
__device__ __forceinline__ void dft<2>(float4* v) {
    const float4 a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
}

template <>
__device__ __forceinline__ void dft<3>(float4* v) {
    constexpr float S3 = 0.86602540378443865f;  // sin(2 pi / 3)
    const float4 t1 = add(v[1], v[2]);
    const float4 t2 = axpy(v[0], -0.5f, t1);
    const float4 t3 = times_minus_i(scale(sub(v[1], v[2]), S3));
    v[0] = add(v[0], t1);
    v[1] = add(t2, t3);
    v[2] = sub(t2, t3);
}

template <>
__device__ __forceinline__ void dft<4>(float4* v) {
    const float4 t0 = add(v[0], v[2]);
    const float4 t1 = sub(v[0], v[2]);
    const float4 t2 = add(v[1], v[3]);
    const float4 t3 = times_minus_i(sub(v[1], v[3]));
    v[0] = add(t0, t2);
    v[2] = sub(t0, t2);
    v[1] = add(t1, t3);
    v[3] = sub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<5>(float4* v) {
    constexpr float C1 = 0.30901699437494742f;   // cos(2 pi / 5)
    constexpr float C2 = -0.80901699437494742f;  // cos(4 pi / 5)
    constexpr float S1 = 0.95105651629515357f;   // sin(2 pi / 5)
    constexpr float S2 = 0.58778525229247314f;   // sin(4 pi / 5)
    const float4 a1 = add(v[1], v[4]), b1 = sub(v[1], v[4]);
    const float4 a2 = add(v[2], v[3]), b2 = sub(v[2], v[3]);
    const float4 m1 = axpy(axpy(v[0], C1, a1), C2, a2);
    const float4 m2 = axpy(axpy(v[0], C2, a1), C1, a2);
    const float4 n1 = times_minus_i(axpy(scale(b1, S1), S2, b2));
    const float4 n2 = times_minus_i(axpy(scale(b1, S2), -S1, b2));
    v[0] = add(v[0], add(a1, a2));
    v[1] = add(m1, n1);
    v[4] = sub(m1, n1);
    v[2] = add(m2, n2);
    v[3] = sub(m2, n2);
}

// floor(a / b) for 0 <= a < 2^20 and 0 < b <= 2 CAP, by a float reciprocal:
// (a + 0.5) / b lies at least 0.5 / b from an integer, far above the
// float rounding of the product.
__device__ __forceinline__ int div_small(int a, float inv_b) {
    return __float2int_rz((static_cast<float>(a) + 0.5f) * inv_b);
}

// One Stockham pass of radix R over `frames` frames of n points each, from
// `src` to `dst`.  Butterfly j < n/R of a frame reads x[j + r n/R], r < R,
// turns input r by e^{-2 pi i r k / (ns R)} (k = j mod ns), runs the
// R-point DFT and writes y[(j - k) R + k + r ns].
template <int R>
__device__ __forceinline__ void radix_pass(const float4* src, float4* dst,
                                           const float2* __restrict__ tw, int n, int frames,
                                           int ns) {
    const int m = n / R;
    const int stride = n / (ns * R);  // twiddle table step
    const float inv_m = 1.0f / static_cast<float>(m);
    const float inv_ns = 1.0f / static_cast<float>(ns);
    for (int g = threadIdx.x; g < frames * m; g += THREADS) {
        const int f = div_small(g, inv_m);
        const int j = g - f * m;
        const int k = j - div_small(j, inv_ns) * ns;
        const float4* in = src + f * n + j;
        float4 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = in[r * m];
        if (ns > 1) {
#pragma unroll
            for (int r = 1; r < R; ++r) v[r] = twiddle(v[r], __ldg(tw + r * k * stride));
        }
        dft<R>(v);
        float4* out = dst + f * n + (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) out[r * ns] = v[r];
    }
    __syncthreads();
}

// The plan's Stockham passes over `frames` transforms of n points that
// start in buf[0], ping-ponging with buf[1]; the buffer that ends with the
// transforms.
__device__ __forceinline__ const float4* fft_passes(float4* const* buf,
                                                    const float2* __restrict__ tw, int n,
                                                    int frames, const Plan& plan) {
    int ns = 1, cur = 0;
    for (int p = 0; p < plan.n_pass; ++p, cur ^= 1) {
        switch (plan.radix[p]) {
            case 2: radix_pass<2>(buf[cur], buf[cur ^ 1], tw, n, frames, ns); break;
            case 3: radix_pass<3>(buf[cur], buf[cur ^ 1], tw, n, frames, ns); break;
            case 4: radix_pass<4>(buf[cur], buf[cur ^ 1], tw, n, frames, ns); break;
            default: radix_pass<5>(buf[cur], buf[cur ^ 1], tw, n, frames, ns); break;
        }
        ns *= plan.radix[p];
    }
    return buf[cur];
}

// Splits the channel pairs of the `frames` transforms Z [frames][n] (z0 =
// (x, y) carries c0 + i c1, z1 = (z, w) c2 + i c3) and writes bins
// 0..n/2 of each as float4 re and im from element out0 on, channel-last.
__device__ __forceinline__ void split_pairs(const float4* Z, int n, int frames, long long out0,
                                            float4* __restrict__ re, float4* __restrict__ im) {
    const int K = n / 2 + 1;
    const float inv_k = 1.0f / static_cast<float>(K);
    for (int idx = threadIdx.x; idx < frames * K; idx += THREADS) {
        const int f = div_small(idx, inv_k);
        const int k = idx - f * K;
        const float4 z = Z[f * n + k];
        const float4 c = Z[f * n + (k == 0 ? 0 : n - k)];  // Z[n - k], conjugated below
        re[out0 + idx] = make_float4(0.5f * (z.x + c.x), 0.5f * (z.y + c.y),
                                     0.5f * (z.z + c.z), 0.5f * (z.w + c.w));
        im[out0 + idx] = make_float4(0.5f * (z.y - c.y), 0.5f * (c.x - z.x),
                                     0.5f * (z.w - c.w), 0.5f * (c.z - z.z));
    }
}

__global__ void __launch_bounds__(THREADS, 2)
stft_hop_blocks_fft_kernel(const float4* __restrict__ x, long long clip_stride, int T,
                           int hop, const float* __restrict__ table, Plan plan,
                           int frames, int blocks_per_clip, float4* __restrict__ re,
                           float4* __restrict__ im) {
    extern __shared__ __align__(16) float4 smem[];
    const int n = 2 * hop;
    const int K = hop + 1;
    float4* buf[2] = {smem, smem + CAP};  // ping-pong, [frames][n] each
    const float2* tw = reinterpret_cast<const float2*>(table);  // [n] e^{-2 pi i m / n}
    const float* win = table + 2 * n;                              // [n] the window

    const int tid = threadIdx.x;
    const int b = blockIdx.x / blocks_per_clip;
    const int t0 = (blockIdx.x - b * blocks_per_clip) * frames;

    // hop-blocks t0 - 1 .. t0 + frames - 1, each read once: sample s of
    // block t0 - 1 + u is the right half of local frame u - 1 and the left
    // half of local frame u.  Blocks past T are zeros (their frames are not
    // stored); block -1 is the reflect block.
    const float4* clip = x + (long long)b * clip_stride;
    const float inv_hop = 1.0f / static_cast<float>(hop);
    {
        // (frames + 1) hop <= CAP: every load is issued before any store
        constexpr int STAGE = (CAP + THREADS - 1) / THREADS;
        const int total = (frames + 1) * hop;
        float4 v[STAGE];
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
            const int idx = tid + i * THREADS;
            v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx < total) {
                const int u = div_small(idx, inv_hop);
                const int s = idx - u * hop;
                const int blk = t0 - 1 + u;
                if (blk < 0) {
                    v[i] = __ldg(clip + hop - s);
                } else if (blk < T) {
                    v[i] = __ldg(clip + (long long)blk * hop + s);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
            const int idx = tid + i * THREADS;
            if (idx < total) {
                const int u = div_small(idx, inv_hop);
                const int s = idx - u * hop;
                if (u >= 1) buf[0][(u - 1) * n + hop + s] = scale(v[i], __ldg(win + hop + s));
                if (u < frames) buf[0][u * n + s] = scale(v[i], __ldg(win + s));
            }
        }
    }
    __syncthreads();

    const float4* Z = fft_passes(buf, tw, n, frames, plan);
    split_pairs(Z, n, min(frames, T - t0), ((long long)b * T + t0) * K, re, im);
}

// ---------------------------------------------------------------------------
// Any hop: `stft_frames_fft_kernel` on flat (B, N, 4) audio.
//
// Frame t of a clip holds the librosa center=True samples
//   s = t hop + m - n/2,  m < n,
// of the flat clip x: the left edge reflected (s < 0 reads x[-s]), samples
// from N on zeros (JAX's right pad), T = N / hop frames, the window of
// win_length zero-padded to n in the table (counterpart of
// adyolo_tpu/ops/features.py::_stft_re_im on flat audio, which frames by
// reshaped slices when hop | n and by a gather otherwise).  It serves
// every n_fft other than 2*hop that the plan takes: n even, a product of
// 2, 3 and 5, up to MAX_N = 4096 (2400-sample windows of 48-kHz audio in
// 4096).
//
// Design: a block owns F = max(1, FRAME_SLOTS / n) consecutive frames (F =
// 1 at n >= 1201) and reads each frame's n samples straight from the clip,
// as float4 (the 4 FOA channels), coalesced, 8 loads in flight a thread;
// frames overlap by n - hop samples, and those rereads are left to L2.
// Then the same Stockham passes, table and pair split as the hop-block
// kernel, over buffers of F n float4: 64 KB a block at n = 2048 (3 blocks
// an SM), 128 KB at n = 4096 (1 block an SM, opted in above 48 KB).
//
// What bounds it on an H100: memory.  At B = 16 x 20 s of 24-kHz audio,
// (n, hop) = (2048, 600), it reads 123 MB of audio and writes 420 MB of
// re/im (0.162 ms at 3.35 TB/s) for 3.2 GFLOP of FFT.
__global__ void __launch_bounds__(THREADS, 2)
stft_frames_fft_kernel(const float4* __restrict__ x, long long clip_stride, long long N, int T,
                       int hop, int n, const float* __restrict__ table, Plan plan, int frames,
                       int blocks_per_clip, float4* __restrict__ re, float4* __restrict__ im) {
    extern __shared__ __align__(16) float4 smem[];
    const int half = n / 2;
    const int K = half + 1;
    float4* buf[2] = {smem, smem + frames * n};  // ping-pong, [frames][n] each
    const float2* tw = reinterpret_cast<const float2*>(table);  // [n] e^{-2 pi i m / n}
    const float* win = table + 2 * n;                              // [n] the window

    const int tid = threadIdx.x;
    const int b = blockIdx.x / blocks_per_clip;
    const int t0 = (blockIdx.x - b * blocks_per_clip) * frames;
    const int nf = min(frames, T - t0);
    const float4* clip = x + (long long)b * clip_stride;
    const float inv_n = 1.0f / static_cast<float>(n);

    constexpr int STAGE = 8;  // loads a thread issues before its stores
    const int total = nf * n;
    for (int base = 0; base < total; base += STAGE * THREADS) {
        float4 v[STAGE];
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
            const int idx = base + tid + i * THREADS;
            v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx < total) {
                const int f = div_small(idx, inv_n);
                const long long s = (long long)(t0 + f) * hop + (idx - f * n) - half;
                const long long src = s < 0 ? -s : s;  // the reflected left edge
                if (src < N) v[i] = __ldg(clip + src);  // zeros from N on
            }
        }
#pragma unroll
        for (int i = 0; i < STAGE; ++i) {
            const int idx = base + tid + i * THREADS;
            if (idx < total) {
                const int m = idx - div_small(idx, inv_n) * n;
                buf[0][idx] = scale(v[i], __ldg(win + m));
            }
        }
    }
    __syncthreads();

    const float4* Z = fft_passes(buf, tw, n, nf, plan);
    split_pairs(Z, n, nf, ((long long)b * T + t0) * K, re, im);
}

// The radix plan of a launch, checked against n: 0 or the failure.
int make_plan(const int* radices, int n_pass, int n, Plan* plan) {
    if (n_pass < 1 || n_pass > MAX_PASSES) {
        return fail((int)cudaErrorInvalidValue, "radix plan: %d passes (1..%d)", n_pass,
                    MAX_PASSES);
    }
    plan->n_pass = n_pass;
    long long prod = 1;
    for (int p = 0; p < n_pass; ++p) {
        if (radices[p] < 2 || radices[p] > 5) {
            return fail((int)cudaErrorInvalidValue, "radix plan: pass %d has radix %d (2..5)",
                        p, radices[p]);
        }
        plan->radix[p] = radices[p];
        prod *= radices[p];
    }
    if (prod != n) {
        return fail((int)cudaErrorInvalidValue, "radix plan: the radices multiply to %lld, "
                    "not n_fft %d", prod, n);
    }
    return 0;
}

// Frames a block of the frames kernel owns at this n.
int frames_per_block(int n) {
    return n >= FRAME_SLOTS ? 1 : FRAME_SLOTS / n;
}

}  // namespace

// Dynamic shared memory of a launch: the two frame buffers.
extern "C" long long adyolo_stft_smem_bytes() {
    return (long long)(2 * CAP * sizeof(float4));
}

// C entry point (bound with ctypes).  x: (B, T, hop, 4) float32 hop-block
// audio, or flat (B, N, 4) with clip_stride = N (float4 units); table:
// (3 * n,) float32, n = 2 * hop: the twiddles e^{-2 pi i m / n} as (re, im)
// pairs, then the window; radices: the n_pass radices of the plan (each
// 2, 3, 4 or 5, product n); re, im: (B, T, hop + 1, 4) float32.  Launches
// on `stream` and returns 0 on success, else the CUDA error of the site
// that failed, which adyolo_last_error (csrc/errors.cu) names.
extern "C" int adyolo_stft_fft(const void* x, long long clip_stride, int B, int T, int hop,
                               const void* table, const int* radices, int n_pass, void* re,
                               void* im, void* stream) {
    if (int rc = enter("adyolo_stft_fft")) return rc;
    const int n = 2 * hop;
    if (B < 1 || T < 2 || hop < 1 || n > CAP || clip_stride < (long long)T * hop) {
        return fail((int)cudaErrorInvalidValue, "arguments: B=%d T=%d hop=%d clip_stride=%lld "
                    "(B >= 1, T >= 2, 2 hop <= %d, clip_stride >= T hop)", B, T, hop,
                    clip_stride, CAP);
    }
    Plan plan;
    if (int rc = make_plan(radices, n_pass, n, &plan)) return rc;
    const int frames = CAP / n;
    const int blocks_per_clip = (T + frames - 1) / frames;
    if ((long long)B * blocks_per_clip > 0x7fffffffLL) {
        return fail((int)cudaErrorInvalidValue, "grid of %lld blocks",
                    (long long)B * blocks_per_clip);
    }
    const size_t smem = (size_t)adyolo_stft_smem_bytes();
    const cudaError_t e = cudaFuncSetAttribute(
        stft_hop_blocks_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        return fail((int)e, "cudaFuncSetAttribute(stft_hop_blocks_fft_kernel, max dynamic "
                    "shared memory %zu B)", smem);
    }
    stft_hop_blocks_fft_kernel<<<B * blocks_per_clip, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const float4*>(x), clip_stride, T, hop, static_cast<const float*>(table),
        plan, frames, blocks_per_clip, static_cast<float4*>(re), static_cast<float4*>(im));
    return check_launch("stft_hop_blocks_fft_kernel");
}

// Dynamic shared memory of a frames-kernel launch at n_fft `n`.
extern "C" long long adyolo_stft_frames_smem_bytes(int n) {
    return n < 2 ? -1LL : (long long)(2 * frames_per_block(n) * n * sizeof(float4));
}

// C entry point of the frames kernel.  x: flat (B, N, 4) float32 audio,
// clip b at x + b * clip_stride (float4 units), 16-byte aligned; T = N /
// hop frames; table: (3 * n,) float32, as above; radices as above, product
// n; re, im: (B, T, n / 2 + 1, 4) float32.  Needs n even, n <= 4096 and N
// > n / 2 (the reflection of frame 0 stays inside the clip).  Launches on
// `stream`; returns as adyolo_stft_fft.
extern "C" int adyolo_stft_frames_fft(const void* x, long long clip_stride, long long N, int B,
                                      int T, int hop, int n, const void* table,
                                      const int* radices, int n_pass, void* re, void* im,
                                      void* stream) {
    if (int rc = enter("adyolo_stft_frames_fft")) return rc;
    if (B < 1 || hop < 1 || n < 2 || n % 2 != 0 || n > MAX_N || N <= n / 2 || T < 1 ||
        T != N / hop || clip_stride < N) {
        return fail((int)cudaErrorInvalidValue, "arguments: B=%d N=%lld T=%d hop=%d n_fft=%d "
                    "clip_stride=%lld (B, hop, T >= 1, T == N / hop, n_fft even <= %d, N > "
                    "n_fft / 2, clip_stride >= N)", B, N, T, hop, n, clip_stride, MAX_N);
    }
    if (reinterpret_cast<unsigned long long>(x) % 16 != 0) {
        return fail((int)cudaErrorInvalidValue, "audio address %p is not 16-byte aligned", x);
    }
    Plan plan;
    if (int rc = make_plan(radices, n_pass, n, &plan)) return rc;
    const int frames = frames_per_block(n);
    const int blocks_per_clip = (T + frames - 1) / frames;
    if ((long long)B * blocks_per_clip > 0x7fffffffLL) {
        return fail((int)cudaErrorInvalidValue, "grid of %lld blocks",
                    (long long)B * blocks_per_clip);
    }
    const size_t smem = (size_t)adyolo_stft_frames_smem_bytes(n);
    const cudaError_t e = cudaFuncSetAttribute(
        stft_frames_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        return fail((int)e, "cudaFuncSetAttribute(stft_frames_fft_kernel, max dynamic shared "
                    "memory %zu B)", smem);
    }
    stft_frames_fft_kernel<<<B * blocks_per_clip, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const float4*>(x), clip_stride, N, T, hop, n,
        static_cast<const float*>(table), plan, frames, blocks_per_clip,
        static_cast<float4*>(re), static_cast<float4*>(im));
    return check_launch("stft_frames_fft_kernel");
}
