// Framed STFT for Hopper (sm_90a): mixed-radix Stockham FFTs in shared
// memory, in two kernels: `stft_hop_blocks_fft_kernel` for the DCASE
// geometry n_fft = 2*hop <= 2400 with radices 2..5 (described first), and
// `stft_frames_fft_kernel` for flat audio at every other geometry (its own
// section below, with the global-memory passes it runs above its
// shared-memory limit).
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

// In-place forward DFTs (e^{-2 pi i / R}) on v[0..R) of float4 (two
// complex numbers).
__device__ __forceinline__ void dft2(float4* v) {
    const float4 a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
}

__device__ __forceinline__ void dft3(float4* v) {
    constexpr float S3 = 0.86602540378443865f;  // sin(2 pi / 3)
    const float4 t1 = add(v[1], v[2]);
    const float4 t2 = axpy(v[0], -0.5f, t1);
    const float4 t3 = times_minus_i(scale(sub(v[1], v[2]), S3));
    v[0] = add(v[0], t1);
    v[1] = add(t2, t3);
    v[2] = sub(t2, t3);
}

__device__ __forceinline__ void dft4(float4* v) {
    const float4 t0 = add(v[0], v[2]);
    const float4 t1 = sub(v[0], v[2]);
    const float4 t2 = add(v[1], v[3]);
    const float4 t3 = times_minus_i(sub(v[1], v[3]));
    v[0] = add(t0, t2);
    v[2] = sub(t0, t2);
    v[1] = add(t1, t3);
    v[3] = sub(t1, t3);
}

__device__ __forceinline__ void dft5(float4* v) {
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

// Radix 8 as 4 x 2: the 4-point DFTs of the even and of the odd inputs,
// the odd ones turned by e^{-2 pi i k / 8}, then 2-point DFTs.
__device__ __forceinline__ void dft8(float4* v) {
    constexpr float H = 0.70710678118654752f;  // 1 / sqrt 2
    float4 e[4] = {v[0], v[2], v[4], v[6]};
    float4 o[4] = {v[1], v[3], v[5], v[7]};
    dft4(e);
    dft4(o);
    o[1] = twiddle(o[1], make_float2(H, -H));
    o[2] = times_minus_i(o[2]);
    o[3] = twiddle(o[3], make_float2(-H, -H));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = add(e[k], o[k]);
        v[k + 4] = sub(e[k], o[k]);
    }
}

// Radix 16 as 4 x 4: X[k1 + 4 k2] = sum_n2 W4^(n2 k2) W16^(n2 k1)
// DFT4_n1(x[4 n1 + n2])[k1], W_N = e^{-2 pi i / N}.
__device__ __forceinline__ void dft16(float4* v) {
    constexpr float C1 = 0.92387953251128676f;  // cos(pi / 8)
    constexpr float S1 = 0.38268343236508977f;  // sin(pi / 8)
    constexpr float H = 0.70710678118654752f;   // 1 / sqrt 2
    float4 a[4][4];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
        float4 t[4] = {v[n2], v[n2 + 4], v[n2 + 8], v[n2 + 12]};
        dft4(t);
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) a[n2][k1] = t[k1];
    }
    // W16^(n2 k1): ^1 (C1, -S1), ^2 (H, -H), ^3 (S1, -C1), ^4 -i, ^6 (-H, -H), ^9 (-C1, S1)
    a[1][1] = twiddle(a[1][1], make_float2(C1, -S1));
    a[1][2] = twiddle(a[1][2], make_float2(H, -H));
    a[1][3] = twiddle(a[1][3], make_float2(S1, -C1));
    a[2][1] = twiddle(a[2][1], make_float2(H, -H));
    a[2][2] = times_minus_i(a[2][2]);
    a[2][3] = twiddle(a[2][3], make_float2(-H, -H));
    a[3][1] = twiddle(a[3][1], make_float2(S1, -C1));
    a[3][2] = twiddle(a[3][2], make_float2(-H, -H));
    a[3][3] = twiddle(a[3][3], make_float2(-C1, S1));
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
        float4 t[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
        dft4(t);
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = t[k2];
    }
}

template <int R>
__device__ __forceinline__ void dft(float4* v) {
    if constexpr (R == 2) {
        dft2(v);
    } else if constexpr (R == 3) {
        dft3(v);
    } else if constexpr (R == 4) {
        dft4(v);
    } else if constexpr (R == 5) {
        dft5(v);
    } else if constexpr (R == 8) {
        dft8(v);
    } else {
        static_assert(R == 16, "register radices are 2, 3, 4, 5, 8 and 16");
        dft16(v);
    }
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
// Every other geometry: `stft_frames_fft_kernel` on flat (B, N, 4) audio.
//
// Frame t of a clip holds the librosa center=True samples
//   s = t hop + m - floor(n/2),  m < n,
// of the flat clip x: the left edge reflected (s < 0 reads x[-s]), samples
// from N on zeros (JAX's right pad), T = N / hop frames, the window of
// win_length zero-padded to n in the table (counterpart of
// adyolo_tpu/ops/features.py::_stft_re_im on flat audio, which frames by
// reshaped slices when hop | n and by a gather otherwise).  It serves every
// geometry the hop-block kernel does not: any hop, odd n (K = n/2 + 1
// bins; the pair split above holds for any n), any prime factor, any n.
//
// What bounds it on an H100: memory.  At B = 16 x 20 s of 24-kHz audio,
// (n, hop, win) = (2048, 600, 1200), it must read 123 MB of audio and write
// 420 MB of re/im (0.162 ms at 3.35 TB/s) for 3.2 GFLOP of FFT.  Inside an
// SM the scarce resource is shared memory's bandwidth: each Stockham pass
// reads and writes every frame once (32 KB at n 2048 in float4), and the
// design before this one made six such passes, a windowed copy and two
// split reads a frame, and fetched each frame's n samples from L2 (3.4x
// the audio at hop 600).
//
// Design (route "shared": both channel pairs a block, float4).  A
// persistent block of 256 threads, one an SM, walks over tiles of F
// consecutive frames of one clip.  A tile's span, the (F - 1) hop + n
// samples its frames cover, comes into shared memory once, by cp.async (16
// B a sample, zero-filled from N on; the reflected left edge is index
// arithmetic, and frame 0's reflected samples x[1..n/2] lie inside tile
// 0's span), into a ring of two slots: tile i + 1's span arrives while
// tile i is transformed and stored.  The slot then holds its tile's F
// transforms in place, element i at i + i/16 (a spare float4 every 16, so
// that the first pass's stores at stride R fall in distinct banks).  Every
// pass is register-staged: a thread reads all of its butterflies (at most
// 16 float4) into registers, the block synchronises, and the thread
// writes its outputs to the same buffer; the first pass reads the span,
// windowed on the read, so there is no windowed copy.  Radices 16 and 8
// first (2048 = 16 x 16 x 8: three passes), then 4 or 2, 3 and 5 as
// register butterflies, and any other prime p as a generic pass: each
// output the direct p-point sum of its inputs, pairs r, p - r sharing
// their root e^{-2 pi i r s / p}, read from the float64-built table at the
// exact integer index r s mod p (O(n sum p) work).  The register passes'
// twiddles are gathered once a block into a shared table laid out pass by
// pass as [r - 1][k], so that a warp reads them contiguously.  The pair
// split writes re/im as float4, coalesced.  At (2048, 600): F = 2, two
// slots of 4352 float4 and the 16-KB twiddle table, 152 KB.  Each pass is
// a function of its own (__noinline__): inlined into the kernel's radix
// switch they spilled ~1.5 KB a thread at any register budget.
//
// Where no such tile fits the registers, route "shared_wide" holds 32
// float4 a thread (4800 = 16 x 4 x 3 x 5 x 5 in one tile: 300 radix-16
// butterflies over 256 threads), with one slot where two do not fit
// (8192).  Every n up to 5,642 runs in shared memory, and every n up to
// 8192 whose passes fit 32 values a thread (frames_choose says which
// route and tile each geometry takes).  Route "global": elsewhere,
// `stft_frames_pass_kernel` runs the same passes through a global scratch
// buffer that the wrapper allocates, one launch a pass, and
// `stft_frames_split_kernel` splits: simple, slow and right.  (A block of
// one channel pair, float2 and 64 values a thread, took every n up to
// 11,274 in shared memory, but ran slower than the global route on the
// card at 9600 and 11274, PERF.md §6.)
//
// What bounds it at (2048, 600) (measured on the card, PERF.md §6): the
// 8 warps an SM that 16 float4 a thread at 255 registers leave.  The span
// and first pass, the other passes and the split (whose re/im stores are
// 0.125 ms of HBM writes for the whole batch) each take about a third;
// two blocks of 128 threads an SM, whose phases interleave, read the same
// as one of 256.  Bulk (TMA) stores of a staged split ran slower, and so
// did more threads an SM at 128 or 168 registers.

constexpr int FR_THREADS = 256;
constexpr int FR_MAX_FRAMES = 8;  // frames a tile
constexpr int FR_MAX_PASSES = 32;
constexpr int SMEM_OPTIN = 232448;  // an H100 block's largest dynamic shared memory
constexpr int GLOBAL_THREADS = 256;
// The routes: shared memory with 16 or 32 values (float4) a thread
// through a pass; global memory.
constexpr int ROUTE_SHARED = 0, ROUTE_SHARED_WIDE = 1, ROUTE_GLOBAL = 2;
constexpr int ROUTE_VALUES[2] = {16, 32};

struct FramesPlan {
    int n_pass;
    int radix[FR_MAX_PASSES];
    int tw_off[FR_MAX_PASSES];  // the pass's first entry in the shared twiddle table
};

__host__ __device__ __forceinline__ bool register_radix(int r) {
    return r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 16;
}

// The shared-memory place of element i of a tile's transforms.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// floor(a / b) for 0 <= a < 2^21 and 1 <= b < 2^24, inv_b = 1.0f / b
// (correctly rounded): (a + 0.5) / b lies at least 0.5 / b from an
// integer, and the product's relative error, at most ~2^-23 with inv_b's
// own rounding, moves it by less than (a + 0.5) 2^-23 / b < 0.25 / b.
__device__ __forceinline__ int div_exact(int a, float inv_b) {
    return __float2int_rz((static_cast<float>(a) + 0.5f) * inv_b);
}

// 16 bytes from global to shared memory, asynchronously; zeros where not
// `valid`.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int src_bytes = valid ? 16 : 0;  // 0: the slot is zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One register-staged Stockham pass of radix R over the nf transforms of
// n points in `buf` (element i at padded(i)): butterfly j < n/R of a frame
// reads x[j + r n/R], turns input r by e^{-2 pi i r k / (ns R)} (k = j mod
// ns; `twp` holds them as [r - 1][k]), runs the R-point DFT and writes
// y[(j - k) R + k + r ns].  `first` (ns == 1): the inputs are the tile's
// span in `buf`, frame f's sample m at f hop + m, times the window.
template <int EPT, int R>
__device__ __noinline__ void reg_pass(float4* buf, bool first, int hop,
                                      const float* __restrict__ win, const float2* twp, int n,
                                      int nf, int ns) {
    constexpr int NB = EPT / R;  // butterflies a thread
    const int m = n / R;
    const int total = nf * m;
    const float inv_m = 1.0f / static_cast<float>(m);
    const float inv_ns = 1.0f / static_cast<float>(ns);
    float4 v[NB][R];
    int out[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int g = threadIdx.x + i * FR_THREADS;
        out[i] = -1;
        if (g >= total) continue;
        const int f = div_exact(g, inv_m);
        const int j = g - f * m;
        if (first) {
            const float4* in = buf + f * hop + j;
#pragma unroll
            for (int r = 0; r < R; ++r) v[i][r] = scale(in[r * m], __ldg(win + j + r * m));
            out[i] = f * n + j * R;
        } else {
            const int k = j - div_exact(j, inv_ns) * ns;
            const int src = f * n + j;
#pragma unroll
            for (int r = 0; r < R; ++r) v[i][r] = buf[padded(src + r * m)];
#pragma unroll
            for (int r = 1; r < R; ++r) v[i][r] = twiddle(v[i][r], twp[(r - 1) * ns + k]);
            out[i] = f * n + (j - k) * R + k;
        }
        dft<R>(v[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        if (out[i] < 0) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) buf[padded(out[i] + r * ns)] = v[i][r];
    }
    __syncthreads();
}

// acc + a c + i d t for w = (c, t), both complex numbers: the pair r, p - r
// of a generic pass's sum (root_sums)
__device__ __forceinline__ float4 mac_pair(float4 acc, float4 a, float4 d, float2 w) {
    return make_float4(fmaf(a.x, w.x, fmaf(-d.y, w.y, acc.x)),
                       fmaf(a.y, w.x, fmaf(d.x, w.y, acc.y)),
                       fmaf(a.z, w.x, fmaf(-d.w, w.y, acc.z)),
                       fmaf(a.w, w.x, fmaf(d.z, w.y, acc.w)));
}

// Outputs s0 .. s0 + S - 1 (those below p) of butterfly j of a generic
// radix-p pass, p odd: with x_r = in(j + r m) w^{r k} (the pass's twiddle,
// table[r k stride], k = j mod ns) and e^{-2 pi i r s / p} = (c, t) =
// table[(r s mod p) m], output s is x_0 + sum over r = 1 .. (p - 1) / 2 of
// (x_r + x_{p-r}) c + i (x_r - x_{p-r}) t: the pair r, p - r shares its
// root, so each input is read once for S outputs and half the products of
// a direct sum remain.  r s mod p is kept exact by integer steps; the
// roots' index is the same on every lane of a warp that works on one
// chunk s0, so their loads are broadcasts.
template <int S, typename L>
__device__ __forceinline__ void root_sums(L in, const float2* __restrict__ tw, int j, int k,
                                          int m, int stride, int p, int s0, float4* acc) {
    const float4 x0 = in(j);
    int at[S], step[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        acc[s] = x0;
        step[s] = s0 + s < p ? s0 + s : s0 + s - p;  // s0 + s < 2p
        at[s] = step[s];                              // r = 1
    }
    const int kt = k * stride;
    for (int r = 1; 2 * r < p; ++r) {
        const float4 u = twiddle(in(j + r * m), __ldg(tw + r * kt));
        const float4 v = twiddle(in(j + (p - r) * m), __ldg(tw + (p - r) * kt));
        const float4 a = add(u, v), d = sub(u, v);
#pragma unroll
        for (int s = 0; s < S; ++s) {
            acc[s] = mac_pair(acc[s], a, d, __ldg(tw + at[s] * m));
            at[s] += step[s];
            if (at[s] >= p) at[s] -= p;
        }
    }
}

// A generic pass of odd radix p over the nf transforms in `buf`, in
// work items of GEN_S outputs of one butterfly (root_sums): item c F m + g
// is chunk c of butterfly g (frame g / m, j = g mod m), so that a warp's
// lanes share c.  Register-staged as reg_pass; `first` as there.
constexpr int GEN_S = 8;

template <int EPT>
__device__ __noinline__ void gen_pass(float4* buf, bool first, int hop,
                                      const float* __restrict__ win,
                                      const float2* __restrict__ tw, int n, int nf, int ns,
                                      int p) {
    constexpr int NI = EPT / GEN_S;  // items a thread
    const int m = n / p;
    const int fm = nf * m;
    const int items = fm * ((p + GEN_S - 1) / GEN_S);
    const int stride = n / (ns * p);
    const float inv_m = 1.0f / static_cast<float>(m);
    const float inv_fm = 1.0f / static_cast<float>(fm);
    const float inv_ns = 1.0f / static_cast<float>(ns);
    float4 y[NI][GEN_S];
    int out[NI], s0[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int item = threadIdx.x + i * FR_THREADS;
        out[i] = -1;
        if (item >= items) continue;
        const int c = div_exact(item, inv_fm);
        const int g = item - c * fm;
        const int f = div_exact(g, inv_m);
        const int j = g - f * m;
        const int k = j - div_exact(j, inv_ns) * ns;
        s0[i] = c * GEN_S;
        const float4* frame = first ? buf + f * hop : buf;
        const int at0 = first ? 0 : f * n;
        root_sums<GEN_S>(
            [&](int at) {
                return first ? scale(frame[at], __ldg(win + at)) : frame[padded(at0 + at)];
            },
            tw, j, k, m, stride, p, s0[i], y[i]);
        out[i] = f * n + (j - k) * p + k;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        if (out[i] < 0) continue;
#pragma unroll
        for (int s = 0; s < GEN_S; ++s) {
            if (s0[i] + s < p) buf[padded(out[i] + (s0[i] + s) * ns)] = y[i][s];
        }
    }
    __syncthreads();
}

// The pair split of Z (z0 = (x, y) carries c0 + i c1, z1 = (z, w) c2 + i
// c3) for bin k: re and im of element e, all four channels.
__device__ __forceinline__ void store_split(float4 z, float4 c, float* __restrict__ re,
                                            float* __restrict__ im, long long e) {
    reinterpret_cast<float4*>(re)[e] = make_float4(0.5f * (z.x + c.x), 0.5f * (z.y + c.y),
                                                   0.5f * (z.z + c.z), 0.5f * (z.w + c.w));
    reinterpret_cast<float4*>(im)[e] = make_float4(0.5f * (z.y - c.y), 0.5f * (c.x - z.x),
                                                   0.5f * (z.w - c.w), 0.5f * (c.z - z.z));
}

// Bins 0..n/2 of the nf transforms in `buf` (Z[n - k] read at k > 0), from
// output element out0 on.
__device__ __forceinline__ void split_tile(const float4* buf, int n, int nf, long long out0,
                                           float* __restrict__ re, float* __restrict__ im) {
    const int K = n / 2 + 1;
    const float inv_k = 1.0f / static_cast<float>(K);
    for (int idx = threadIdx.x; idx < nf * K; idx += FR_THREADS) {
        const int f = div_exact(idx, inv_k);
        const int k = idx - f * K;
        const float4 z = buf[padded(f * n + k)];
        const float4 c = buf[padded(f * n + (k == 0 ? 0 : n - k))];
        store_split(z, c, re, im, out0 + idx);
    }
}

// The shared routes.  Work unit u: tile u (F frames of one clip).  Shared
// memory: `ring` slots of `slot` float4 each, then the twiddle table (n
// float2 at most).
template <int EPT>
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_fft_kernel(const float* __restrict__ x, long long clip_stride, long long N, int T,
                       int hop, int n, const float* __restrict__ table, FramesPlan plan,
                       int frames, int ring, int slot, int tiles_per_clip, int units,
                       float* __restrict__ re, float* __restrict__ im) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const slots = reinterpret_cast<float4*>(smem_raw);
    float2* const tws =
        reinterpret_cast<float2*>(smem_raw + (size_t)ring * slot * sizeof(float4));
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);  // e^{-2 pi i m / n}
    const float* __restrict__ win = table + 2 * n;
    const int tid = threadIdx.x;
    const int K = n / 2 + 1;

    // the register passes' twiddles after the first: [r - 1][k] of a pass =
    // e^{-2 pi i r k / (ns R)} = table[r k n / (ns R)]
    {
        int ns = plan.radix[0];
        for (int p = 1; p < plan.n_pass; ns *= plan.radix[p], ++p) {
            const int R = plan.radix[p];
            if (!register_radix(R)) continue;
            const int stride = n / (ns * R);
            for (int e = tid; e < (R - 1) * ns; e += FR_THREADS) {
                const int r = e / ns + 1;
                tws[plan.tw_off[p] + e] = tw[r * (e - (r - 1) * ns) * stride];
            }
        }
    }

    // the span of unit u into `dst`: padded position i of its tile, signal
    // sample t0 hop + i - n/2, reflected left of 0, zeros from N on
    auto stage = [&](int u, float4* dst) {
        const int b = u / tiles_per_clip;
        const int t0 = (u - b * tiles_per_clip) * frames;
        const int span = (min(frames, T - t0) - 1) * hop + n;
        const long long s0 = (long long)t0 * hop - n / 2;
        const float4* clip = reinterpret_cast<const float4*>(x) + (long long)b * clip_stride;
        for (int i = tid; i < span; i += FR_THREADS) {
            const long long s = s0 + i;
            const long long src = s < 0 ? -s : s;
            const bool ok = src < N;
            cp_async(dst + i, clip + (ok ? src : 0), ok);
        }
    };

    int u = blockIdx.x;
    if (u < units) stage(u, slots);
    cp_async_commit();
    for (int it = 0; u < units; ++it, u += gridDim.x) {
        float4* const buf = slots + (size_t)(it & (ring - 1)) * slot;
        const int next = u + gridDim.x;
        if (ring == 2) {  // the next tile's span arrives during this one
            __syncthreads();  // into the slot of the tile before, once it is read
            if (next < units) stage(next, slots + (size_t)((it + 1) & 1) * slot);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int b = u / tiles_per_clip;
        const int t0 = (u - b * tiles_per_clip) * frames;
        const int nf = min(frames, T - t0);
        int ns = 1;
        for (int p = 0; p < plan.n_pass; ++p) {
            const int R = plan.radix[p];
            const float2* twp = tws + plan.tw_off[p];
            switch (R) {
                case 16: reg_pass<EPT, 16>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                case 8: reg_pass<EPT, 8>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                case 5: reg_pass<EPT, 5>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                case 4: reg_pass<EPT, 4>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                case 3: reg_pass<EPT, 3>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                case 2: reg_pass<EPT, 2>(buf, p == 0, hop, win, twp, n, nf, ns); break;
                default: gen_pass<EPT>(buf, p == 0, hop, win, tw, n, nf, ns, R); break;
            }
            ns *= R;
        }
        split_tile(buf, n, nf, ((long long)b * T + t0) * K, re, im);
        if (ring == 1 && next < units) {  // the next span into this slot, once it is read
            __syncthreads();
            stage(next, buf);
            cp_async_commit();
        }
    }
    cp_async_wait<0>();
}

// The global route.  One Stockham pass of the plan over every frame of
// the batch, [frame][n] float4 in global memory from `src` to `dst`; the
// first pass (src null) reads its frames from the audio, windowed.  Work
// item w of a frame: butterfly w of a register radix R, else output w of
// a generic pass (both as in reg_pass / gen_pass, the twiddles read from
// the table).  Frames over blockIdx.y, items over blockIdx.x.
template <int R, typename L>
__device__ __forceinline__ void global_butterfly(L load, float4* out,
                                                 const float2* __restrict__ tw, int n, int ns,
                                                 int j) {
    const int m = n / R;
    const int k = j % ns;
    const int stride = n / (ns * R);
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(j + r * m);
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = twiddle(v[r], __ldg(tw + r * k * stride));
    dft<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) out[(j - k) * R + k + r * ns] = v[r];
}

template <typename L>
__device__ __forceinline__ void global_outputs(L load, float4* out,
                                               const float2* __restrict__ tw, int n, int ns,
                                               int p, int item) {
    const int m = n / p;
    const int c = item / m;
    const int j = item - c * m;
    const int k = j % ns;
    float4 acc[GEN_S];
    root_sums<GEN_S>(load, tw, j, k, m, n / (ns * p), p, c * GEN_S, acc);
#pragma unroll
    for (int s = 0; s < GEN_S; ++s) {
        if (c * GEN_S + s < p) out[(j - k) * p + k + (c * GEN_S + s) * ns] = acc[s];
    }
}

__global__ void __launch_bounds__(GLOBAL_THREADS)
stft_frames_pass_kernel(const float4* __restrict__ x, long long clip_stride, long long N, int T,
                        int hop, int n, const float* __restrict__ table, const float4* src,
                        float4* dst, long long n_frames, int R, int ns) {
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);
    const float* __restrict__ win = table + 2 * n;
    const int items = register_radix(R) ? n / R : n / R * ((R + GEN_S - 1) / GEN_S);
    for (long long fr = blockIdx.y; fr < n_frames; fr += gridDim.y) {
        const long long b = fr / T;
        const long long s0 = (fr - b * T) * hop - n / 2;
        const float4* clip = x + b * clip_stride;
        const float4* in = src == nullptr ? nullptr : src + fr * n;
        float4* out = dst + fr * n;
        auto load = [&](int at) {
            if (in != nullptr) return in[at];
            const long long s = s0 + at;
            const long long i = s < 0 ? -s : s;
            return i < N ? scale(__ldg(clip + i), __ldg(win + at)) : make_float4(0.f, 0.f, 0.f, 0.f);
        };
        for (int w = blockIdx.x * GLOBAL_THREADS + threadIdx.x; w < items;
             w += gridDim.x * GLOBAL_THREADS) {
            switch (R) {
                case 16: global_butterfly<16>(load, out, tw, n, ns, w); break;
                case 8: global_butterfly<8>(load, out, tw, n, ns, w); break;
                case 5: global_butterfly<5>(load, out, tw, n, ns, w); break;
                case 4: global_butterfly<4>(load, out, tw, n, ns, w); break;
                case 3: global_butterfly<3>(load, out, tw, n, ns, w); break;
                case 2: global_butterfly<2>(load, out, tw, n, ns, w); break;
                default: global_outputs(load, out, tw, n, ns, R, w); break;
            }
        }
    }
}

// The global route's pair split of the last pass's output Z, [frame][n].
__global__ void __launch_bounds__(GLOBAL_THREADS)
stft_frames_split_kernel(const float4* __restrict__ Z, int n, long long n_frames,
                         float* __restrict__ re, float* __restrict__ im) {
    const int K = n / 2 + 1;
    for (long long fr = blockIdx.y; fr < n_frames; fr += gridDim.y) {
        const float4* z = Z + fr * n;
        for (int k = blockIdx.x * GLOBAL_THREADS + threadIdx.x; k < K;
             k += gridDim.x * GLOBAL_THREADS) {
            store_split(z[k], z[k == 0 ? 0 : n - k], re, im, fr * K + k);
        }
    }
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

// The frames kernel's plan, checked against n: the radices (any, each >= 2;
// 2, 3, 4, 5, 8 and 16 run as register butterflies, others as a generic
// pass) and each register pass's offset in the shared twiddle table.
int make_frames_plan(const int* radices, int n_pass, int n, FramesPlan* plan) {
    if (n_pass < 1 || n_pass > FR_MAX_PASSES) {
        return fail((int)cudaErrorInvalidValue, "frames plan: %d passes (1..%d)", n_pass,
                    FR_MAX_PASSES);
    }
    plan->n_pass = n_pass;
    long long prod = 1;
    int off = 0;
    for (int p = 0; p < n_pass; ++p) {
        const int r = radices[p];
        if (r < 2 || prod * r > n) {
            return fail((int)cudaErrorInvalidValue, "frames plan: pass %d has radix %d (>= 2, "
                        "product <= n_fft %d)", p, r, n);
        }
        if (!register_radix(r) && r % 2 == 0) {
            return fail((int)cudaErrorInvalidValue, "frames plan: pass %d has radix %d (a "
                        "generic pass takes an odd radix)", p, r);
        }
        plan->radix[p] = r;
        plan->tw_off[p] = off;
        if (p > 0 && register_radix(r)) off += (r - 1) * (int)prod;
        prod *= r;
    }
    if (prod != n) {
        return fail((int)cudaErrorInvalidValue, "frames plan: the radices multiply to %lld, "
                    "not n_fft %d", prod, n);
    }
    return 0;
}

// A shared route's slot, in elements: the span of `frames` frames or their
// padded transforms, whichever is longer.
long long frames_slot(int n, int hop, int frames) {
    const long long span = (long long)(frames - 1) * hop + n;
    const long long fn = (long long)frames * n;
    const long long transforms = fn + (fn - 1) / 16 + 1;
    return span > transforms ? span : transforms;
}

// A shared route's dynamic shared memory: the slots, then the twiddle table.
long long frames_smem(int n, int hop, int frames, int ring) {
    return ring * frames_slot(n, hop, frames) * (long long)sizeof(float4) + 8LL * n;
}

// Whether every pass of `plan` over `frames` transforms fits the
// registers of the block's threads (ept values a thread).
bool frames_fit(const FramesPlan& plan, int n, int frames, int ept) {
    const long long points = (long long)frames * n;
    if (points >= (1LL << 21)) return false;  // div_exact's range
    for (int p = 0; p < plan.n_pass; ++p) {
        const int r = plan.radix[p];
        const long long items = register_radix(r) ? points / r  // butterflies, or chunks
                                                  : points / r * ((r + GEN_S - 1) / GEN_S);
        const long long per_thread = (items + FR_THREADS - 1) / FR_THREADS;
        if (per_thread > (register_radix(r) ? ept / r : ept / GEN_S)) return false;
    }
    return true;
}

// The route, frames a tile and ring of span slots that a launch at (n,
// hop) takes (ops/hopper_stft.py::frames_config is the wrapper's copy):
// the first shared route where a tile fits the registers and 227 KB, a
// ring of two slots before one, the most frames a tile; else the global
// route.  Returns the block's dynamic shared memory (0 on the global
// route).
long long frames_choose(const FramesPlan& plan, int n, int hop, int* config) {
    for (int route = ROUTE_SHARED; route <= ROUTE_SHARED_WIDE; ++route) {
        for (int ring = 2; ring >= 1; --ring) {
            for (int frames = FR_MAX_FRAMES; frames >= 1; --frames) {
                const long long smem = frames_smem(n, hop, frames, ring);
                if (smem <= SMEM_OPTIN && frames_fit(plan, n, frames, ROUTE_VALUES[route])) {
                    config[0] = route;
                    config[1] = frames;
                    config[2] = ring;
                    return smem;
                }
            }
        }
    }
    config[0] = ROUTE_GLOBAL;
    config[1] = config[2] = 0;
    return 0;
}

// Blocks of `kernel` resident on the current device at once (SMs x blocks
// an SM), after its shared-memory opt-in, or -cudaError, recorded.
template <typename K>
long long resident_blocks(K kernel, size_t smem, const char* name) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e) return -(long long)fail((int)e, "resident_blocks(%s): cudaGetDevice", name);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e) {
        return -(long long)fail((int)e, "resident_blocks(%s): cudaDeviceGetAttribute"
                                "(multiprocessor count, device %d)", name, dev);
    }
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) {
        return -(long long)fail((int)e, "cudaFuncSetAttribute(%s, max dynamic shared memory "
                                "%zu B)", name, smem);
    }
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FR_THREADS, smem);
    if (e) {
        return -(long long)fail((int)e, "resident_blocks(%s): cudaOccupancyMaxActiveBlocks"
                                "PerMultiprocessor(%d threads, %zu B)", name, FR_THREADS, smem);
    }
    if (per_sm < 1) {
        return -(long long)fail((int)cudaErrorInvalidConfiguration, "resident_blocks(%s): no "
                                "block of %d threads and %zu B fits an SM", name, FR_THREADS,
                                smem);
    }
    return (long long)sms * per_sm;
}

// A shared route's persistent launch over `units` work units.
template <int EPT>
int launch_frames(const void* x, long long clip_stride, long long N, int T, int hop, int n,
                  const void* table, const FramesPlan& plan, int frames, int ring, int units,
                  int tiles_per_clip, size_t smem, void* re, void* im, cudaStream_t stream) {
    const long long resident = resident_blocks(stft_frames_fft_kernel<EPT>, smem,
                                               "stft_frames_fft_kernel");
    if (resident < 0) return (int)-resident;
    const int grid = (int)(resident < units ? resident : units);
    stft_frames_fft_kernel<EPT><<<grid, FR_THREADS, smem, stream>>>(
        static_cast<const float*>(x), clip_stride, N, T, hop, n,
        static_cast<const float*>(table), plan, frames, ring,
        (int)frames_slot(n, hop, frames), tiles_per_clip, units, static_cast<float*>(re),
        static_cast<float*>(im));
    return check_launch("stft_frames_fft_kernel");
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

// The frames kernel's configuration at n_fft `n` and `hop` for the n_pass
// `radices` of its plan (frames_choose): route, frames a tile and ring
// into config[0..2]; returns the block's dynamic shared memory, or -1 for
// arguments no launch takes.  No device work: it lets the wrapper's copy
// of the rule be checked against this one.
extern "C" long long adyolo_stft_frames_config(int n, int hop, const int* radices, int n_pass,
                                               int* config) {
    FramesPlan plan;
    if (n < 2 || n > (1 << 30) || hop < 1 || make_frames_plan(radices, n_pass, n, &plan) != 0) {
        return -1LL;
    }
    return frames_choose(plan, n, hop, config);
}

// C entry point of the frames kernel.  x: flat (B, N, 4) float32 audio,
// clip b at x + b * clip_stride (float4 units), 16-byte aligned; T = N /
// hop frames; table: (3 * n,) float32, as above; radices: the n_pass
// radices of the frames plan (ops/hopper_stft.py::frames_radix_plan),
// product n; route, frames, ring: ops/hopper_stft.py::frames_config's
// choice, which this checks (route 2, global: `scratch` holds 2 B T n
// float4, and frames and ring are not read); re, im: (B, T, n / 2 + 1, 4)
// float32.  Needs N > n / 2 (the reflection of frame 0 stays inside the
// clip).  Launches on `stream` (route 2: n_pass + 1 launches); returns as
// adyolo_stft_fft.
extern "C" int adyolo_stft_frames_fft(const void* x, long long clip_stride, long long N, int B,
                                      int T, int hop, int n, const void* table,
                                      const int* radices, int n_pass, int route, int frames,
                                      int ring, void* scratch, long long scratch_bytes, void* re,
                                      void* im, void* stream) {
    if (int rc = enter("adyolo_stft_frames_fft")) return rc;
    if (B < 1 || hop < 1 || n < 2 || n > (1 << 30) || N <= n / 2 || T < 1 || T != N / hop ||
        clip_stride < N) {
        return fail((int)cudaErrorInvalidValue, "arguments: B=%d N=%lld T=%d hop=%d n_fft=%d "
                    "clip_stride=%lld (B, hop, T >= 1, T == N / hop, 2 <= n_fft <= 2^30, N > "
                    "n_fft / 2, clip_stride >= N)", B, N, T, hop, n, clip_stride);
    }
    if (reinterpret_cast<unsigned long long>(x) % 16 != 0) {
        return fail((int)cudaErrorInvalidValue, "audio address %p is not 16-byte aligned", x);
    }
    FramesPlan plan;
    if (int rc = make_frames_plan(radices, n_pass, n, &plan)) return rc;
    const cudaStream_t st = (cudaStream_t)stream;
    if (route == ROUTE_GLOBAL) {
        const long long n_frames = (long long)B * T;
        if (scratch == nullptr || scratch_bytes < 2 * n_frames * n * (long long)sizeof(float4) ||
            reinterpret_cast<unsigned long long>(scratch) % 16 != 0) {
            return fail((int)cudaErrorInvalidValue, "global route: scratch %p of %lld B (2 B T "
                        "n_fft float4 = %lld B, 16-byte aligned)", scratch, scratch_bytes,
                        2 * n_frames * n * (long long)sizeof(float4));
        }
        float4* buf[2] = {static_cast<float4*>(scratch),
                          static_cast<float4*>(scratch) + n_frames * n};
        const unsigned gy = (unsigned)(n_frames < 65535 ? n_frames : 65535);
        int ns = 1;
        for (int p = 0; p < plan.n_pass; ++p) {
            const int R = plan.radix[p];
            const int items = register_radix(R) ? n / R : n / R * ((R + GEN_S - 1) / GEN_S);
            const dim3 grid((unsigned)((items + GLOBAL_THREADS - 1) / GLOBAL_THREADS), gy);
            stft_frames_pass_kernel<<<grid, GLOBAL_THREADS, 0, st>>>(
                static_cast<const float4*>(x), clip_stride, N, T, hop, n,
                static_cast<const float*>(table), p == 0 ? nullptr : buf[(p - 1) & 1],
                buf[p & 1], n_frames, R, ns);
            if (int rc = check_launch("stft_frames_pass_kernel")) return rc;
            ns *= R;
        }
        const dim3 grid((unsigned)((n / 2 + GLOBAL_THREADS) / GLOBAL_THREADS), gy);
        stft_frames_split_kernel<<<grid, GLOBAL_THREADS, 0, st>>>(
            buf[(plan.n_pass - 1) & 1], n, n_frames, static_cast<float*>(re),
            static_cast<float*>(im));
        return check_launch("stft_frames_split_kernel");
    }
    if (route < ROUTE_SHARED || route > ROUTE_SHARED_WIDE) {
        return fail((int)cudaErrorInvalidValue, "route %d (0, 1 shared, 2 global)", route);
    }
    const int ept = ROUTE_VALUES[route];
    const long long smem = frames >= 1 && (ring == 1 || ring == 2)
        ? frames_smem(n, hop, frames, ring) : -1;
    if (frames < 1 || frames > FR_MAX_FRAMES || smem < 0 || smem > SMEM_OPTIN ||
        !frames_fit(plan, n, frames, ept)) {
        return fail((int)cudaErrorInvalidValue, "route %d: %d frames a tile, ring %d at n_fft "
                    "%d, hop %d: %lld B of shared memory (<= %d), or passes beyond %d values "
                    "a thread", route, frames, ring, n, hop, smem, SMEM_OPTIN, ept);
    }
    const int tiles_per_clip = (T + frames - 1) / frames;
    const long long units = (long long)B * tiles_per_clip;
    if (units > 0x7fffffffLL) {
        return fail((int)cudaErrorInvalidValue, "%lld work units", units);
    }
    if (route == ROUTE_SHARED) {
        return launch_frames<16>(x, clip_stride, N, T, hop, n, table, plan, frames, ring,
                                 (int)units, tiles_per_clip, (size_t)smem, re, im, st);
    }
    return launch_frames<32>(x, clip_stride, N, T, hop, n, table, plan, frames, ring, (int)units,
                             tiles_per_clip, (size_t)smem, re, im, st);
}
