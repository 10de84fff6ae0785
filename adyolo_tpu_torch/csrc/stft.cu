// Framed STFT for Hopper (sm_90a): mixed-radix Stockham FFTs in shared
// memory, in two kernels: `stft_hop_blocks_fft_kernel` for the DCASE
// geometry n_fft = 2*hop <= 2400 with radices 2..5 (described first), and
// `stft_frames_fft_kernel` for flat audio at every other geometry (its own
// section below, with the routes it takes where no tile of frames fits:
// `stft_frames_4step_kernel`, one frame a block, and the two-launch global
// route, `stft_frames_cols_kernel` and `stft_frames_rows_kernel`, or
// `stft_frames_chirp_in_kernel` and `stft_frames_chirp_out_kernel` where no
// split of n fits the tiles).
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
// bins; the pair split above holds for any n), any prime factor.
//
// What bounds it on an H100: memory.  At B = 16 x 20 s of 24-kHz audio,
// (n, hop, win) = (2048, 600, 1200), it must read 123 MB of audio and write
// 420 MB of re/im (0.162 ms at 3.35 TB/s) for 3.2 GFLOP of FFT.  Inside an
// SM the scarce resource is shared memory's bandwidth: each Stockham pass
// reads and writes every frame once (32 KB at n 2048 in float4).
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
// register butterflies, then the primes 7 to 31 as prime passes
// (prime_pass: work items of 5 output pairs of one butterfly, every root
// a register loaded once a pass from the shared table and picked at a
// compile-time index, the outputs written out of place into a second tile
// buffer; no root comes from device memory and no output sums over device
// loads).
// Every pass's twiddles, and each prime pass's roots, are gathered once a
// block into a shared table laid out pass by pass as [r - 1][k], so that a
// warp reads them contiguously.  The pair split writes re/im as float4,
// coalesced.  At (2048, 600): F = 2, two slots of 4352 float4 and the
// 16-KB twiddle table, 152 KB.  Each pass is a function of its own
// (__noinline__): inlined into the kernel's radix switch they spilled
// ~1.5 KB a thread at any register budget.
//
// Where no such tile fits the registers, route "shared_wide" holds 32
// float4 a thread (4800 = 16 x 4 x 3 x 5 x 5 in one tile: 300 radix-16
// butterflies over 256 threads), with one slot where two do not fit
// (8192).  Every n up to 5,543 whose primes are at most 31 runs in shared
// memory, and every such n up to 8192 whose passes fit 32 values a thread
// (frames_choose says which route and tile each geometry takes).
//
// Where no tile fits but one frame of register radices does (9600, 12000),
// route "four_step" runs the four-step FFT below in one block a frame
// (`stft_frames_4step_kernel`, one launch): the columns in place at their
// stride, the twiddles W_n^(b c), the rows (then contiguous), the split.
//
// Route "global", everywhere else (a prime factor above 31, or no block
// that holds a frame): a four-step FFT in two launches through one
// scratch buffer of B T n float4.  n = n1 n2 (n1 the product of the primes
// above 31 where there are any, else the divisor of fewest passes near the
// square root); frame sample m = n2 a + b (a < n1, b < n2), bin k = c + n1 d
// (c < n1, d < n2):
//   X[c + n1 d] = sum_b W_n2^(b d) [W_n^(b c) sum_a W_n1^(a c) x[n2 a + b]].
// `stft_frames_cols_kernel` reads each frame from the clip (window,
// reflection and zeros as above), runs the n2 transforms over a (the
// columns b, in groups that fit a tile) on the register and prime passes,
// multiplies by W_n^(b c) (a product of two entries of a shared table of
// 128 + n / 128) and writes the scratch as [frame][c][b].
// `stft_frames_rows_kernel` reads rows c, runs their n2-point transforms,
// and splits the pairs in its epilogue: Z[n - k] of bin k = c + n1 d lies
// in row n1 - c (row 0 for c = 0), so a unit holds rows c in [c0, c1) of
// the lower half and their mirrors n1 - c, and writes those rows' bins.
//
// A column of n1 = q points with a prime above 31 runs Bluestein's
// chirp-z: with b_r = e^{i pi r^2 / q} (the index r^2 mod 2q exact in 64
// bits on the host), X_s = conj(b_s) sum_r (x_r conj b_r) b_{s - r}, a
// cyclic convolution of length M (2^a 3^b 5^c) computed by an in-place
// decimation-in-frequency FFT (its output in digit-reversed order), a
// product with the filter's transform (built in float64 on the host in the
// same order, 1/M folded in), and an in-place decimation-in-time FFT of the
// conjugate (digit-reversed in, natural out): no permutation, and no pass
// holds more than one butterfly in registers, so M is bounded by shared
// memory alone.  Where M >= 2q - 1 does not fit (q above ~6,800), J output
// blocks of S = ceil(q / J) bins each take their own unit and filter, M >=
// q + S - 1 (q up to 12,703).  The chirp, M's twiddles and the filters are a second table
// (ops/hopper_stft.py::chirp_table), built once a geometry in float64.
//
// Where no split fits the tiles (a product of primes above 31 past 12,703,
// as the prime 14087, or rows of n2 points that fit no tile), the global
// route runs Bluestein over the whole frame in blocks, in two launches
// through a scratch of B T P M float4 (chirp_choose): M = 8192, S = M / 2;
// the frame's samples in P = ceil(n / S) input blocks, bins 0..n/2 in
// ceil((n/2 + 1) / S) lower output blocks, each with its mirror block of
// bins n - k.  Output block K..K+S-1 is the sum over input blocks i of the
// cyclic convolutions (M >= 2S - 1 points) of block i with the filter g_d
// = b_{K - iS + d}, d in (-S, S), summed in the frequency domain.
// `stft_frames_chirp_in_kernel` writes each input block's M-point
// transform (x w conj b, zeros from S on; in-place DIF);
// `stft_frames_chirp_out_kernel` sums each output block's products with
// its filters (a lower block's filter depends on s - i, a mirror's on
// s + i: 2 (P + O - 1) filters in the chirp table, O the lower blocks),
// runs one in-place DIT of the conjugate a block, and splits the pairs of
// a lower block and its mirror.  Work a frame grows as n^2 / S, where the split routes' grows as
// n log n.
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
constexpr int PRIME_MAX = 31;       // the largest prime with a prime pass
constexpr int WIDE = 16;            // values a thread on the global route's tiles
constexpr int MAX_BLUESTEIN_BLOCKS = 16;
constexpr int TW_SPLIT = 128;  // W_n^e = W_n^(128 floor(e / 128)) W_n^(e mod 128)
constexpr int CHIRP_M = 8192;  // the whole-frame Bluestein's transform length
// The routes: shared memory with 16 or 32 values (float4) a thread
// through a pass; global memory; one frame a block.
constexpr int ROUTE_SHARED = 0, ROUTE_SHARED_WIDE = 1, ROUTE_GLOBAL = 2, ROUTE_FOUR_STEP = 3;
constexpr int ROUTE_VALUES[2] = {16, 32};

struct FramesPlan {
    int n_pass;
    int radix[FR_MAX_PASSES];
    int tw_off[FR_MAX_PASSES];    // the pass's twiddles [r - 1][k] in the shared table
    int root_off[FR_MAX_PASSES];  // a prime pass's roots e^{-2 pi i j / p}, j = 1..(p-1)/2
    int entries;                  // the shared table's float2 entries
};

// Route four_step's plan (four_step_choose): n = n1 n2, columns and rows
// a group, and the block's shared memory.
struct FourStepPlan {
    int n1, n2, cols, rows;
    long long smem;
    FramesPlan p1, p2;
};

// The global route's plan (global_choose).
struct GlobalPlan {
    int n1, n2;             // n = n1 n2: the columns' points, the rows' points
    int cols, col_groups;   // columns a unit of stft_frames_cols_kernel, units a frame
    int rows, row_groups;   // lower rows a unit of stft_frames_rows_kernel, units a frame
    int ring_cols, ring_rows;  // each kernel's input slots (2, or 1 where 2 do not fit)
    int q;                  // 0, or n1 by Bluestein
    int m_len, blocks, outs;  // Bluestein: M, J output blocks of `outs` bins
    // > 0: the whole frame by Bluestein (chirp_choose), `blocks` input and
    // `segments` lower output blocks of `outs` points
    int segments;
    int filters;            // the chirp table's filters of M points
    int m_pass;
    int m_radix[FR_MAX_PASSES];  // M's radices, decimation in frequency
    // float2 offsets in the chirp table: conj b_r, M's twiddles, the filters
    long long cc_off, twm_off, h_off;
    long long smem_cols, smem_rows;
    FramesPlan p1, p2;      // the passes of n1 (q == 0) and of n2
};

__host__ __device__ __forceinline__ bool register_radix(int r) {
    return r == 2 || r == 3 || r == 4 || r == 5 || r == 8 || r == 16;
}

__host__ __device__ __forceinline__ bool prime_radix(int r) {
    return r == 7 || r == 11 || r == 13 || r == 17 || r == 19 || r == 23 || r == 29 || r == 31;
}

// The shared-memory place of element i of a tile's transforms.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// Float4 slots that elements 0..len-1 take at their padded places.
__host__ __device__ __forceinline__ long long padded_len(long long len) {
    return len + (len - 1) / 16 + 1;
}

// floor(a / b) for 0 <= a < 2^21 and 1 <= b < 2^24, inv_b = 1.0f / b
// (correctly rounded): (a + 0.5) / b lies at least 0.5 / b from an
// integer, and the product's relative error, at most ~2^-23 with inv_b's
// own rounding, moves it by less than (a + 0.5) 2^-23 / b < 0.25 / b.
__device__ __forceinline__ int div_exact(int a, float inv_b) {
    return __float2int_rz((static_cast<float>(a) + 0.5f) * inv_b);
}

__device__ __forceinline__ float4 conj4(float4 a) { return make_float4(a.x, -a.y, a.z, -a.w); }

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

// store(i, load(i)) for i < total, each thread issuing BATCH loads before
// its stores.
template <typename Load, typename Store>
__device__ __forceinline__ void batched_copy(int total, Load load, Store store) {
    constexpr int BATCH = 8;
    for (int base = threadIdx.x; base < total; base += FR_THREADS * BATCH) {
        float4 v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int idx = base + i * FR_THREADS;
            if (idx < total) v[i] = load(idx);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int idx = base + i * FR_THREADS;
            if (idx < total) store(idx, v[i]);
        }
    }
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

// An index whose value is part of its type (decltype(i)::value).
template <int I>
struct Index {
    static constexpr int value = I;
    __host__ __device__ constexpr operator int() const { return I; }
};

// Entries of the global route's two-level table of W_n^e, e < n.
__host__ __device__ constexpr long long four_step_entries(long long n) {
    return TW_SPLIT + (n + TW_SPLIT - 1) / TW_SPLIT;
}

// W_n^e for 0 <= e < n from the two-level table `w4` (gather_four_step).
__device__ __forceinline__ float2 four_step_twiddle(const float2* w4, int e) {
    const float2 lo = w4[e & (TW_SPLIT - 1)], hi = w4[TW_SPLIT + (e >> 7)];
    return make_float2(lo.x * hi.x - lo.y * hi.y, lo.x * hi.y + lo.y * hi.x);
}

// The two-level table of W_n^e into `w4`: W_n^j (j < 128), then W_n^(128 j)
// (128 j < n), from the table's twiddles at exact indices.
__device__ __forceinline__ void gather_four_step(int n, const float2* __restrict__ tw,
                                                 float2* w4) {
    for (int e = threadIdx.x; e < four_step_entries(n); e += FR_THREADS) {
        const long long at = e < TW_SPLIT ? e : (long long)(e - TW_SPLIT) * TW_SPLIT;
        w4[e] = at < n ? tw[at] : make_float2(1.f, 0.f);
    }
}

// f(Index<I>) for I = B .. N - 1, unrolled: the index is a constant
// expression in f, so arrays indexed by it stay in registers.
template <int B, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (B < N) {
        f(Index<B>{});
        static_for<B + 1, N>(f);
    }
}

// Output pairs a work item of a prime pass computes.
constexpr int PRIME_PAIRS = 5;

// Chunk CH of the P-point DFT (P an odd prime) of in(0..P-1): with the
// pair r, P - r as a_r = x_r + x_{P-r} and d_r = x_r - x_{P-r}, output
// pair s = CH Q + 1 + q (q < Q, s <= H = (P - 1)/2) is y_s = x_0 + A_s + i
// B_s and y_{P-s} = x_0 + A_s - i B_s, A_s = sum_r a_r c_{rs}, B_s = sum_r
// d_r t_{rs}, (c_j, t_j) = e^{-2 pi i j / P} = w[j] for j <= H and its
// conjugate's mirror above.  y[1 + 2q] and y[2 + 2q] take the pair, y[0]
// the sum y_0 (chunk 0).  r, s and rs mod P are constant expressions, so
// every root is a register.
template <int P, int CH, typename In>
__device__ __forceinline__ void prime_chunk(In in, const float2* w, float4* y) {
    constexpr int H = (P - 1) / 2;
    constexpr int Q = PRIME_PAIRS;
    constexpr int NQ = H - CH * Q < Q ? H - CH * Q : Q;  // pairs of this chunk
    const float4 x0 = in(0);
    y[0] = x0;
    static_for<0, NQ>([&](auto qi) {
        constexpr int q = decltype(qi)::value;
        y[1 + 2 * q] = x0;
        y[2 + 2 * q] = make_float4(0.f, 0.f, 0.f, 0.f);
    });
    static_for<1, H + 1>([&](auto ri) {
        constexpr int r = decltype(ri)::value;
        const float4 u = in(r), v = in(P - r);
        const float4 a = add(u, v), d = sub(u, v);
        if constexpr (CH == 0) y[0] = add(y[0], a);
        static_for<0, NQ>([&](auto qi) {
            constexpr int q = decltype(qi)::value;
            constexpr int j = (r * (CH * Q + 1 + q)) % P;
            const float c = j <= H ? w[j].x : w[P - j].x;
            const float t = j <= H ? w[j].y : -w[P - j].y;
            y[1 + 2 * q] = axpy(y[1 + 2 * q], c, a);
            y[2 + 2 * q] = axpy(y[2 + 2 * q], t, d);
        });
    });
    static_for<0, NQ>([&](auto qi) {
        constexpr int q = decltype(qi)::value;
        const float4 A = y[1 + 2 * q], B = y[2 + 2 * q];
        y[1 + 2 * q] = make_float4(A.x - B.y, A.y + B.x, A.z - B.w, A.w + B.z);  // A + i B
        y[2 + 2 * q] = make_float4(A.x + B.y, A.y - B.x, A.z + B.w, A.w - B.z);  // A - i B
    });
}

// prime_chunk for the run-time chunk `ch`.
template <int P, int CH, typename In>
__device__ __forceinline__ void prime_chunk_at(int ch, In in, const float2* w, float4* y) {
    if constexpr (CH * PRIME_PAIRS < (P - 1) / 2) {
        if (ch == CH) {
            prime_chunk<P, CH>(in, w, y);
        } else {
            prime_chunk_at<P, CH + 1>(ch, in, w, y);
        }
    }
}

// A prime pass of radix P (7 to 31) over the nf transforms in `src`, in
// the Stockham order of reg_pass (not `first`), into `dst` (another
// buffer, element i at padded(i)).  Work item (c, g): chunk c of butterfly
// g's output pairs (PRIME_PAIRS of them, prime_chunk), the items of one
// chunk adjacent so that a warp runs one chunk's code; a thread computes
// its items one after another from inputs read from `src` and turned by
// the pass's twiddles, and stores each item's outputs as it finishes.  The
// (P - 1)/2 roots come from the shared table `roots` into registers once a
// pass.  A function of its own: inlined, the unrolled sums ran slower.
template <int P>
__device__ __noinline__ void prime_pass(const float4* src, float4* dst, const float2* twp,
                                        const float2* roots, int n, int nf, int ns) {
    constexpr int H = (P - 1) / 2;
    const int m = n / P;
    const int fm = nf * m;
    const int items = fm * ((H + PRIME_PAIRS - 1) / PRIME_PAIRS);
    const float inv_m = 1.0f / static_cast<float>(m);
    const float inv_fm = 1.0f / static_cast<float>(fm);
    const float inv_ns = 1.0f / static_cast<float>(ns);
    float2 w[H + 1];
    w[0] = make_float2(1.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) w[j] = roots[j - 1];
    for (int item = threadIdx.x; item < items; item += FR_THREADS) {
        const int c = div_exact(item, inv_fm);
        const int g = item - c * fm;
        const int f = div_exact(g, inv_m);
        const int j = g - f * m;
        const int k = j - div_exact(j, inv_ns) * ns;
        const int at = f * n + j;
        float4 y[2 * PRIME_PAIRS + 1];
        prime_chunk_at<P, 0>(c, [&](int r) {
            const float4 x = src[padded(at + r * m)];
            return r == 0 ? x : twiddle(x, twp[(r - 1) * ns + k]);
        }, w, y);
        const int o = f * n + (j - k) * P + k;
        if (c == 0) dst[padded(o)] = y[0];
#pragma unroll
        for (int q = 0; q < PRIME_PAIRS; ++q) {
            const int sq = c * PRIME_PAIRS + 1 + q;
            if (sq <= H) {
                dst[padded(o + sq * ns)] = y[1 + 2 * q];
                dst[padded(o + (P - sq) * ns)] = y[2 + 2 * q];
            }
        }
    }
    __syncthreads();
}

// The plan's passes over the nf transforms of n points in `buf`; `span`:
// the first pass reads the tile's span (reg_pass's `first`).  `tws`: the
// shared table of gather_tables.  Register passes run in place; a prime
// pass moves the transforms between `buf` and `alt`.  PRIMES: whether the
// instance holds the prime passes 7..31; a plan of register radices ran
// slower in an instance that also held them, so it takes the one without.
// Returns the buffer that holds the transforms.
template <int EPT, bool PRIMES>
__device__ __forceinline__ float4* tile_passes(float4* buf, float4* alt, bool span, int hop,
                                               const float* __restrict__ win,
                                               const float2* tws, const FramesPlan& plan,
                                               int n, int nf) {
    int ns = 1;
    for (int p = 0; p < plan.n_pass; ++p) {
        const int R = plan.radix[p];
        const bool first = span && p == 0;
        const float2* twp = tws + plan.tw_off[p];
        if (!PRIMES || register_radix(R)) {
            switch (R) {
                case 16: reg_pass<EPT, 16>(buf, first, hop, win, twp, n, nf, ns); break;
                case 8: reg_pass<EPT, 8>(buf, first, hop, win, twp, n, nf, ns); break;
                case 5: reg_pass<EPT, 5>(buf, first, hop, win, twp, n, nf, ns); break;
                case 4: reg_pass<EPT, 4>(buf, first, hop, win, twp, n, nf, ns); break;
                case 3: reg_pass<EPT, 3>(buf, first, hop, win, twp, n, nf, ns); break;
                default: reg_pass<EPT, 2>(buf, first, hop, win, twp, n, nf, ns); break;
            }
        } else {
            const float2* rt = tws + plan.root_off[p];
            float4* src = buf;
            float4* dst = alt;
            if (first) {  // the span's frames, windowed, into alt; the pass back into buf
                batched_copy(nf * n, [&](int i) {
                    const int f = i / n;
                    return scale(buf[f * hop + i - f * n], __ldg(win + i - f * n));
                }, [&](int i, float4 v) { alt[padded(i)] = v; });
                __syncthreads();
                src = alt;
                dst = buf;
            }
            switch (R) {
                case 7: prime_pass<7>(src, dst, twp, rt, n, nf, ns); break;
                case 11: prime_pass<11>(src, dst, twp, rt, n, nf, ns); break;
                case 13: prime_pass<13>(src, dst, twp, rt, n, nf, ns); break;
                case 17: prime_pass<17>(src, dst, twp, rt, n, nf, ns); break;
                case 19: prime_pass<19>(src, dst, twp, rt, n, nf, ns); break;
                case 23: prime_pass<23>(src, dst, twp, rt, n, nf, ns); break;
                case 29: prime_pass<29>(src, dst, twp, rt, n, nf, ns); break;
                default: prime_pass<31>(src, dst, twp, rt, n, nf, ns); break;
            }
            if (!first) {
                buf = dst;
                alt = src;
            }
        }
        ns *= R;
    }
    return buf;
}

// The twiddles and roots of `plan` (transforms of L points; the table's
// e^{-2 pi i e / n} at e = step x, step = n / L) into the shared table
// `tws`: [r - 1][k] of pass p = e^{-2 pi i r k / (ns R)}, and a prime
// pass's roots e^{-2 pi i j / p}, j = 1..(p - 1)/2, all at exact integer
// indices below n.
__device__ __forceinline__ void gather_tables(const FramesPlan& plan, int L, int step,
                                              const float2* __restrict__ tw, float2* tws) {
    int ns = 1;
    for (int p = 0; p < plan.n_pass; ns *= plan.radix[p], ++p) {
        const int R = plan.radix[p];
        const int stride = L / (ns * R) * step;
        for (int e = threadIdx.x; e < (R - 1) * ns; e += FR_THREADS) {
            const int r = e / ns + 1;
            tws[plan.tw_off[p] + e] = tw[r * (e - (r - 1) * ns) * stride];
        }
        if (prime_radix(R)) {
            for (int e = threadIdx.x; e < (R - 1) / 2; e += FR_THREADS) {
                tws[plan.root_off[p] + e] = tw[(e + 1) * (L / R) * step];
            }
        }
    }
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
// memory: `ring` slots of `slot` float4 each, a prime pass's other buffer
// (PRIMES), then the table of twiddles and roots (plan.entries float2).
template <int EPT, bool PRIMES>
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_fft_kernel(const float* __restrict__ x, long long clip_stride, long long N, int T,
                       int hop, int n, const float* __restrict__ table, FramesPlan plan,
                       int frames, int ring, int slot, int tiles_per_clip, int units,
                       float* __restrict__ re, float* __restrict__ im) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const slots = reinterpret_cast<float4*>(smem_raw);
    float4* const alt = slots + (size_t)ring * slot;  // a prime pass's other buffer
    float2* const tws = reinterpret_cast<float2*>(
        alt + (PRIMES ? padded_len((long long)frames * n) : 0));
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);  // e^{-2 pi i m / n}
    const float* __restrict__ win = table + 2 * n;
    const int tid = threadIdx.x;
    const int K = n / 2 + 1;

    gather_tables(plan, n, 1, tw, tws);

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
        const float4* z = tile_passes<EPT, PRIMES>(buf, alt, true, hop, win, tws, plan, n, nf);
        split_tile(z, n, nf, ((long long)b * T + t0) * K, re, im);
        if (ring == 1 && next < units) {  // the next span into this slot, once it is read
            __syncthreads();
            stage(next, buf);
            cp_async_commit();
        }
    }
    cp_async_wait<0>();
}

// One register-staged Stockham pass of radix R over `nt` transforms of L
// points laid out in one frame of `buf`: element e of transform t0 + t at
// padded((t0 + t) tstride + e estride).  Columns (COLS: tstride 1, estride
// n2) take consecutive transforms on consecutive lanes, rows (tstride n2,
// estride 1) consecutive elements, so that a warp's accesses are
// contiguous either way.  Otherwise as reg_pass (not `first`).  A first
// pass also turns its inputs: by the window at their frame position
// (`win`, the columns), or by W_n^((t0 + t) e) from the two-level table
// (`w4`, the rows).
template <int EPT, int R, bool COLS>
__device__ __noinline__ void stride_pass(float4* buf, const float2* twp, int L, int nt, int t0,
                                         int tstride, int estride, int ns,
                                         const float* __restrict__ win, const float2* w4) {
    constexpr int NB = EPT / R;  // butterflies a thread
    const int m = L / R;
    const int total = nt * m;
    const float inv_m = 1.0f / static_cast<float>(m);
    const float inv_nt = 1.0f / static_cast<float>(nt);
    const float inv_ns = 1.0f / static_cast<float>(ns);
    float4 v[NB][R];
    int base[NB], out[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        const int g = threadIdx.x + i * FR_THREADS;
        out[i] = -1;
        if (g >= total) continue;
        int t, j;
        if (COLS) {
            j = div_exact(g, inv_nt);
            t = g - j * nt;
        } else {
            t = div_exact(g, inv_m);
            j = g - t * m;
        }
        const int k = j - div_exact(j, inv_ns) * ns;
        base[i] = (t0 + t) * tstride;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int at = base[i] + (j + r * m) * estride;
            v[i][r] = buf[padded(at)];
            if (win != nullptr) v[i][r] = scale(v[i][r], __ldg(win + at));
            if (w4 != nullptr) {
                v[i][r] = twiddle(v[i][r], four_step_twiddle(w4, (t0 + t) * (j + r * m)));
            }
        }
#pragma unroll
        for (int r = 1; r < R; ++r) v[i][r] = twiddle(v[i][r], twp[(r - 1) * ns + k]);
        out[i] = (j - k) * R + k;
        dft<R>(v[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NB; ++i) {
        if (out[i] < 0) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) buf[padded(base[i] + (out[i] + r * ns) * estride)] = v[i][r];
    }
    __syncthreads();
}

// The passes of `plan` (register radices) over transforms t0 .. t0 + nt -
// 1 laid out as stride_pass says; `win` and `w4` turn the first pass's
// inputs (nullptr: not).
template <bool COLS>
__device__ __forceinline__ void stride_passes(float4* buf, const float2* tws,
                                              const FramesPlan& plan, int L, int nt, int t0,
                                              int tstride, int estride,
                                              const float* __restrict__ win, const float2* w4) {
    int ns = 1;
    for (int p = 0; p < plan.n_pass; ++p) {
        const float2* twp = tws + plan.tw_off[p];
        const float* w = p == 0 ? win : nullptr;
        const float2* f = p == 0 ? w4 : nullptr;
        switch (plan.radix[p]) {
            case 16: stride_pass<16, 16, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
            case 8: stride_pass<16, 8, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
            case 5: stride_pass<16, 5, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
            case 4: stride_pass<16, 4, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
            case 3: stride_pass<16, 3, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
            default: stride_pass<16, 2, COLS>(buf, twp, L, nt, t0, tstride, estride, ns, w, f);
                break;
        }
        ns *= plan.radix[p];
    }
}

// Route "four_step": one frame a block, all in shared memory, for n whose
// radices are register radices and whose frame fits a block but no
// register tile (9600).  n = n1 n2 as on the global route: the frame's n
// samples arrive by cp.async at their padded places; the n2 columns
// (sample n2 a + b, windowed as the first pass reads them) transformed in
// place, `cols` at a time; the n1 rows (then contiguous, b + n2 c, turned
// by W_n^(b c) as their first pass reads them) transformed in place,
// `rows` at a time; the pair split (bin c + n1 d at c n2 + d).  No
// scratch, one launch.
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_4step_kernel(const float4* __restrict__ x, long long clip_stride, long long N,
                         int T, int hop, int n, const float* __restrict__ table,
                         FourStepPlan fp, long long units, float* __restrict__ re,
                         float* __restrict__ im) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const buf = reinterpret_cast<float4*>(smem_raw);
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);
    const float* __restrict__ win = table + 2 * n;
    const int n1 = fp.n1, n2 = fp.n2;
    float2* const w4 = reinterpret_cast<float2*>(buf + padded_len(n));
    float2* const tw1 = w4 + four_step_entries(n);
    float2* const tw2 = tw1 + fp.p1.entries;
    gather_four_step(n, tw, w4);
    gather_tables(fp.p1, n1, n2, tw, tw1);
    gather_tables(fp.p2, n2, n1, tw, tw2);
    const int K = n / 2 + 1;
    const float inv_n1 = 1.0f / static_cast<float>(n1);
    auto stage = [&](long long fr) {
        const long long clip_b = fr / T;
        const long long s0 = (fr - clip_b * T) * hop - n / 2;
        const float4* clip = x + clip_b * clip_stride;
        for (int i = threadIdx.x; i < n; i += FR_THREADS) {
            const long long s = s0 + i;
            const long long src = s < 0 ? -s : s;
            const bool ok = src < N;
            cp_async(buf + padded(i), clip + (ok ? src : 0), ok);
        }
        cp_async_commit();
    };
    long long u = blockIdx.x;
    if (u < units) stage(u);
    for (; u < units; u += gridDim.x) {
        cp_async_wait<0>();
        __syncthreads();
        for (int b0 = 0; b0 < n2; b0 += fp.cols) {  // windowed as they are read
            stride_passes<true>(buf, tw1, fp.p1, n1, min(fp.cols, n2 - b0), b0, 1, n2, win,
                                nullptr);
        }
        for (int c0 = 0; c0 < n1; c0 += fp.rows) {  // turned by W_n^(b c) as they are read
            stride_passes<false>(buf, tw2, fp.p2, n2, min(fp.rows, n1 - c0), c0, n2, 1, nullptr,
                                 w4);
        }
        const long long out0 = u * K;
        for (int k = threadIdx.x; k < K; k += FR_THREADS) {
            const int d = div_exact(k, inv_n1), c = k - d * n1;
            const int kk = k == 0 ? 0 : n - k;
            const int dd = div_exact(kk, inv_n1), cc = kk - dd * n1;
            store_split(buf[padded(c * n2 + d)], buf[padded(cc * n2 + dd)], re, im, out0 + k);
        }
        if (u + gridDim.x < units) {
            __syncthreads();
            stage(u + gridDim.x);
        }
    }
    cp_async_wait<0>();
}

// One in-place pass of Bluestein's FFTs over `count` transforms of M
// points in `buf` (element i at padded(i)), at sub-transform length L:
// element j + r m of each sub-transform (m = L / R).  Decimation in
// frequency (DIT false): the R-point DFT, then output s turned by W_L^{j
// s}; decimation in time (DIT true): input s turned by W_L^{j s}, then the
// DFT.  A butterfly's R elements are read and written by one thread, so a
// pass needs one barrier and no more registers than one butterfly.
// W_L^e = twm[e M / L], twm the table's e^{-2 pi i e / M}.
template <int R, bool DIT>
__device__ __noinline__ void chirp_pass(float4* buf, int count, int M, int L,
                                        const float2* __restrict__ twm) {
    const int m = L / R;
    const int per = M / R;
    const int total = count * per;
    const int stride = M / L;
    const float inv_per = 1.0f / static_cast<float>(per);
    const float inv_m = 1.0f / static_cast<float>(m);
    for (int g = threadIdx.x; g < total; g += FR_THREADS) {
        const int t = div_exact(g, inv_per);
        const int rem = g - t * per;
        const int blk = div_exact(rem, inv_m);
        const int j = rem - blk * m;
        const int base = t * M + blk * L + j;
        float4 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = buf[padded(base + r * m)];
        if (DIT) {
#pragma unroll
            for (int s = 1; s < R; ++s) v[s] = twiddle(v[s], __ldg(twm + j * s * stride));
        }
        dft<R>(v);
        if (!DIT) {
#pragma unroll
            for (int s = 1; s < R; ++s) v[s] = twiddle(v[s], __ldg(twm + j * s * stride));
        }
#pragma unroll
        for (int r = 0; r < R; ++r) buf[padded(base + r * m)] = v[r];
    }
    __syncthreads();
}

template <bool DIT>
__device__ __forceinline__ void chirp_fft_pass(int R, float4* buf, int count, int M, int L,
                                               const float2* __restrict__ twm) {
    switch (R) {
        case 16: chirp_pass<16, DIT>(buf, count, M, L, twm); break;
        case 8: chirp_pass<8, DIT>(buf, count, M, L, twm); break;
        case 5: chirp_pass<5, DIT>(buf, count, M, L, twm); break;
        case 4: chirp_pass<4, DIT>(buf, count, M, L, twm); break;
        case 3: chirp_pass<3, DIT>(buf, count, M, L, twm); break;
        default: chirp_pass<2, DIT>(buf, count, M, L, twm); break;
    }
}

// The ring of `ring` (1 or 2) input slots of the global route's kernels,
// as the shared route's: unit u's inputs arrive by `stage(u, slot)`
// (cp.async), with two slots while the unit before is transformed;
// `work(u, slot)` then runs on them.
template <typename Stage, typename Work>
__device__ __forceinline__ void unit_ring(long long units, float4* slots, long long slot,
                                          int ring, Stage stage, Work work) {
    long long u = blockIdx.x;
    if (u < units) stage(u, slots);
    cp_async_commit();
    for (int it = 0; u < units; ++it, u += gridDim.x) {
        float4* const buf = slots + (it & (ring - 1)) * slot;
        const long long next = u + gridDim.x;
        if (ring == 2) {
            __syncthreads();  // the other slot's unit has been read
            if (next < units) stage(next, slots + ((it + 1) & 1) * slot);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        work(u, buf);
        if (ring == 1 && next < units) {
            __syncthreads();
            stage(next, buf);
            cp_async_commit();
        }
    }
    cp_async_wait<0>();
}

// Launch A of the global route.  Work unit u: (frame, column group,
// Bluestein output block).  Its columns b0..b0 + nc - 1 of the frame
// (column b: samples n2 a + b) arrive by cp.async at their padded places
// (nc columns of n1 float4, or of M by Bluestein, CHIRP) in a ring of two
// slots; a sweep applies the window (and conj b_r, zeros from q on); the
// columns are transformed over a, times W_n^(b c), into
// scratch[frame][c][b].  Shared memory: two slots, then the table of n1's
// twiddles and roots.
template <bool PRIMES, bool CHIRP>
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_cols_kernel(const float4* __restrict__ x, long long clip_stride, long long N, int T,
                        int hop, int n, const float* __restrict__ table,
                        const float2* __restrict__ chirps, GlobalPlan g, long long units,
                        float4* __restrict__ scratch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const slots = reinterpret_cast<float4*>(smem_raw);
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);
    const float* __restrict__ win = table + 2 * n;
    const int n1 = g.n1, n2 = g.n2;
    const int len = CHIRP ? g.m_len : n1;  // a column's slots
    const int q = CHIRP ? g.q : n1;        // a column's samples
    const long long slot = padded_len((long long)g.cols * len);
    float4* const alt = slots + g.ring_cols * slot;  // a prime pass's other buffer
    float2* const w4 = reinterpret_cast<float2*>(alt + (PRIMES ? slot : 0));
    float2* const tws = w4 + four_step_entries(n);
    gather_four_step(n, tw, w4);
    if (!CHIRP) gather_tables(g.p1, n1, n2, tw, tws);
    const int per_frame = g.col_groups * g.blocks;
    // unit u: its frame, first column, columns and output block
    auto unit = [&](long long u, long long& fr, int& b0, int& nc, int& blk) {
        fr = u / per_frame;
        const int rem = (int)(u - fr * per_frame);
        const int grp = rem / g.blocks;
        blk = rem - grp * g.blocks;
        b0 = grp * g.cols;
        nc = min(g.cols, n2 - b0);
    };
    auto stage = [&](long long u, float4* dst) {
        long long fr;
        int b0, nc, blk;
        unit(u, fr, b0, nc, blk);
        const long long clip_b = fr / T;
        const long long s0 = (fr - clip_b * T) * hop - n / 2 + b0;
        const float4* clip = x + clip_b * clip_stride;
        const float inv_nc = 1.0f / static_cast<float>(nc);
        for (int idx = threadIdx.x; idx < nc * q; idx += FR_THREADS) {
            const int a = div_exact(idx, inv_nc);
            const int i = idx - a * nc;
            const long long s = s0 + (long long)n2 * a + i;
            const long long src = s < 0 ? -s : s;
            const bool ok = src < N;
            cp_async(dst + padded(i * len + a), clip + (ok ? src : 0), ok);
        }
    };
    auto work = [&](long long u, float4* buf) {
        long long fr;
        int b0, nc, blk;
        unit(u, fr, b0, nc, blk);
        const float inv_nc = 1.0f / static_cast<float>(nc);
        float4* const out = scratch + fr * n;
        if (!CHIRP) {
            // the window, in place
            batched_copy(nc * n1, [&](int idx) {
                const int a = div_exact(idx, inv_nc);
                const int i = idx - a * nc;
                return scale(buf[padded(i * n1 + a)], __ldg(win + n2 * a + b0 + i));
            }, [&](int idx, float4 v) {
                const int a = div_exact(idx, inv_nc);
                buf[padded((idx - a * nc) * n1 + a)] = v;
            });
            __syncthreads();
            const float4* z = tile_passes<WIDE, PRIMES>(
                buf, alt, false, 0, nullptr, tws, g.p1, n1, nc);
            batched_copy(nc * n1, [&](int idx) {
                const int c = div_exact(idx, inv_nc);
                const int i = idx - c * nc;
                return twiddle(z[padded(i * n1 + c)], four_step_twiddle(w4, (b0 + i) * c));
            }, [&](int idx, float4 v) {
                const int c = div_exact(idx, inv_nc);
                out[(long long)c * n2 + b0 + idx - c * nc] = v;
            });
        } else {
            const int M = g.m_len;
            const float inv_mlen = 1.0f / static_cast<float>(M);
            const float2* __restrict__ cc = chirps + g.cc_off;
            const float2* __restrict__ twm = chirps + g.twm_off;
            const float2* __restrict__ h = chirps + g.h_off + (long long)blk * M;
            // u_r = x_r w(n2 r + b) conj(b_r), zeros from q on
            batched_copy(nc * M, [&](int idx) {
                const int i = div_exact(idx, inv_mlen);
                const int r = idx - i * M;
                return r < q ? twiddle(scale(buf[padded(idx)], __ldg(win + n2 * r + b0 + i)),
                                       __ldg(cc + r))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }, [&](int idx, float4 v) { buf[padded(idx)] = v; });
            __syncthreads();
            for (int p = 0, L = M; p < g.m_pass; L /= g.m_radix[p], ++p) {
                chirp_fft_pass<false>(g.m_radix[p], buf, nc, M, L, twm);
            }
            // conj(U H_blk), both in digit-reversed order
            batched_copy(nc * M, [&](int idx) {
                const int e = idx - div_exact(idx, inv_mlen) * M;
                return conj4(twiddle(buf[padded(idx)], __ldg(h + e)));
            }, [&](int idx, float4 v) { buf[padded(idx)] = v; });
            __syncthreads();
            for (int p = g.m_pass - 1, L = 1; p >= 0; --p) {
                L *= g.m_radix[p];
                chirp_fft_pass<true>(g.m_radix[p], buf, nc, M, L, twm);
            }
            // bin s of this block: conj(b_s) v_t = cc_s conj(buf[t]), t = s - first
            const int first = blk * g.outs;
            const int cnt = min(g.outs, q - first);
            batched_copy(nc * cnt, [&](int idx) {
                const int t = div_exact(idx, inv_nc);
                const int i = idx - t * nc;
                const float4 y = twiddle(conj4(buf[padded(i * M + t)]), __ldg(cc + first + t));
                return twiddle(y, four_step_twiddle(w4, (b0 + i) * (first + t)));
            }, [&](int idx, float4 v) {
                const int t = div_exact(idx, inv_nc);
                out[(long long)(first + t) * n2 + b0 + idx - t * nc] = v;
            });
        }
    };
    unit_ring(units, slots, slot, g.ring_cols, stage, work);
}

// Launch B of the global route.  Work unit u: (frame, row group).  Lower
// rows c0..c0 + cw - 1 of [0, n1/2] in slots 0..cw-1 and their mirrors (n1
// - c) mod n1 in slots cw..2cw-1, n2 float4 each from scratch[frame][c],
// by cp.async in a ring of two slots; their n2-point transforms; then the
// pair split of every bin k = c + n1 d < K whose row is in the unit: Z[n -
// k] is the mirror row's element n2 - 1 - d (c > 0) or (n2 - d) mod n2 (c
// = 0).
template <bool PRIMES>
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_rows_kernel(const float4* __restrict__ scratch, int n,
                        const float* __restrict__ table, GlobalPlan g, long long units,
                        float* __restrict__ re, float* __restrict__ im) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const slots = reinterpret_cast<float4*>(smem_raw);
    const float2* __restrict__ tw = reinterpret_cast<const float2*>(table);
    const int n1 = g.n1, n2 = g.n2;
    const long long slot = padded_len(2LL * g.rows * n2);
    float4* const alt = slots + g.ring_rows * slot;  // a prime pass's other buffer
    float2* const tws = reinterpret_cast<float2*>(alt + (PRIMES ? slot : 0));
    gather_tables(g.p2, n2, n1, tw, tws);
    const int K = n / 2 + 1;
    const int lower = n1 / 2 + 1;
    const float inv_n2 = 1.0f / static_cast<float>(n2);
    auto stage = [&](long long u, float4* dst) {
        const long long fr = u / g.row_groups;
        const int c0 = (int)(u - fr * g.row_groups) * g.rows;
        const int cw = min(g.rows, lower - c0);
        const float4* in = scratch + fr * n;
        for (int idx = threadIdx.x; idx < 2 * cw * n2; idx += FR_THREADS) {
            const int sl = div_exact(idx, inv_n2);
            const int row = sl < cw ? c0 + sl : (n1 - c0 - (sl - cw)) % n1;
            cp_async(dst + padded(idx), in + (long long)row * n2 + (idx - sl * n2), true);
        }
    };
    auto work = [&](long long u, float4* buf) {
        const long long fr = u / g.row_groups;
        const int c0 = (int)(u - fr * g.row_groups) * g.rows;
        const int cw = min(g.rows, lower - c0);
        const float inv_cw = 1.0f / static_cast<float>(cw);
        const float4* z = tile_passes<WIDE, PRIMES>(
            buf, alt, false, 0, nullptr, tws, g.p2, n2, 2 * cw);
        const long long out0 = fr * K;
        for (int idx = threadIdx.x; idx < 2 * cw * n2; idx += FR_THREADS) {
            const int half = idx >= cw * n2;  // 0: the lower rows, 1: their mirrors
            const int e = idx - half * cw * n2;
            const int d = div_exact(e, inv_cw);
            const int i = e - d * cw;
            const int c = c0 + i;
            if (half && (c == 0 || 2 * c == n1)) continue;  // its own mirror
            const int k = (half ? n1 - c : c) + n1 * d;
            if (k >= K) continue;
            const int pd = c == 0 ? (n2 - d) % n2 : n2 - 1 - d;
            store_split(z[padded((half * cw + i) * n2 + d)],
                        z[padded(((1 - half) * cw + i) * n2 + pd)], re, im, out0 + k);
        }
    };
    unit_ring(units, slots, slot, g.ring_rows, stage, work);
}

// Launch A of the global route's whole-frame Bluestein (g.segments > 0).
// Work unit u = (frame, input block i): samples iS..iS + S - 1 of the frame
// (window, reflection and zeros as the shared routes) by cp.async, times
// the window and conj b_j, zeros from S on; their M-point in-place DIF
// transform into scratch[frame][i] (digit-reversed order).
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_chirp_in_kernel(const float4* __restrict__ x, long long clip_stride, long long N,
                            int T, int hop, int n, const float* __restrict__ table,
                            const float2* __restrict__ chirps, GlobalPlan g, long long units,
                            float4* __restrict__ scratch) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const slot = reinterpret_cast<float4*>(smem_raw);
    const float* __restrict__ win = table + 2 * n;
    const float2* __restrict__ cc = chirps + g.cc_off;
    const float2* __restrict__ twm = chirps + g.twm_off;
    const int M = g.m_len, S = g.outs, P = g.blocks;
    auto stage = [&](long long u, float4* dst) {
        const long long fr = u / P;
        const int j0 = (int)(u - fr * P) * S;
        const long long clip_b = fr / T;
        const long long s0 = (fr - clip_b * T) * hop - n / 2 + j0;
        const float4* clip = x + clip_b * clip_stride;
        for (int i = threadIdx.x; i < S; i += FR_THREADS) {
            const long long s = s0 + i;
            const long long src = s < 0 ? -s : s;
            const bool ok = j0 + i < n && src < N;
            cp_async(dst + padded(i), clip + (ok ? src : 0), ok);
        }
    };
    auto work = [&](long long u, float4* buf) {
        const int j0 = (int)(u % P) * S;
        batched_copy(M, [&](int i) {
            const int j = j0 + i;
            return i < S && j < n ? twiddle(scale(buf[padded(i)], __ldg(win + j)), __ldg(cc + j))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        }, [&](int i, float4 v) { buf[padded(i)] = v; });
        __syncthreads();
        for (int p = 0, L = M; p < g.m_pass; L /= g.m_radix[p], ++p) {
            chirp_fft_pass<false>(g.m_radix[p], buf, 1, M, L, twm);
        }
        float4* const out = scratch + u * M;
        for (int e = threadIdx.x; e < M; e += FR_THREADS) out[e] = buf[padded(e)];
    };
    unit_ring(units, slot, padded_len(M), 1, stage, work);
}

// Launch B of the whole-frame Bluestein.  Work unit u = (frame, lower
// output block s): bins k = sS + t < n/2 + 1 and their mirrors n - k, the
// mirror block's bins n - sS - S + 1 + t' (t' = S - 1 - t for bin n - k).
// For each of the two: conj(sum_i U_i H_f) over the frame's P input blocks
// (f = s - i + P - 1, or P + segments - 1 + s + i for the mirror; the
// filters' transforms with 1/M folded in, in the DIF order), in-place DIT,
// then conj(b_k) conj(v_t); the lower block's bins wait in `low` while the
// mirror's are formed, and the pair split writes both.
__global__ void __launch_bounds__(FR_THREADS, 1)
stft_frames_chirp_out_kernel(const float4* __restrict__ spectra, int n,
                             const float2* __restrict__ chirps, GlobalPlan g, long long units,
                             float* __restrict__ re, float* __restrict__ im) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* const buf = reinterpret_cast<float4*>(smem_raw);
    float4* const low = buf + padded_len(g.m_len);
    const float2* __restrict__ cc = chirps + g.cc_off;
    const float2* __restrict__ twm = chirps + g.twm_off;
    const float2* __restrict__ h = chirps + g.h_off;
    const int M = g.m_len, S = g.outs, P = g.blocks, O = g.segments;
    const int K = n / 2 + 1;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const long long fr = u / O;
        const int s = (int)(u - fr * O);
        const float4* in = spectra + fr * P * M;
        const int first = s * S;
        const int cnt = min(S, K - first);
        for (int half = 0; half < 2; ++half) {
            for (int e = threadIdx.x; e < M; e += FR_THREADS) {
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                for (int i = 0; i < P; ++i) {
                    const int f = half ? P + O - 1 + s + i : s - i + P - 1;
                    acc = add(acc, twiddle(in[(long long)i * M + e],
                                           __ldg(h + (long long)f * M + e)));
                }
                buf[padded(e)] = conj4(acc);
            }
            __syncthreads();
            for (int p = g.m_pass - 1, L = 1; p >= 0; --p) {
                L *= g.m_radix[p];
                chirp_fft_pass<true>(g.m_radix[p], buf, 1, M, L, twm);
            }
            if (half == 0) {
                for (int t = threadIdx.x; t < cnt; t += FR_THREADS) {
                    low[t] = twiddle(conj4(buf[padded(t)]), __ldg(cc + first + t));
                }
                __syncthreads();  // buf is read before the mirror's sums overwrite it
            }
        }
        const long long out0 = fr * K;
        for (int t = threadIdx.x; t < cnt; t += FR_THREADS) {
            const int k = first + t;
            store_split(low[t], twiddle(conj4(buf[padded(S - 1 - t)]), __ldg(cc + (n - k))),
                        re, im, out0 + k);
        }
        __syncthreads();
    }
}

// The radices of L >= 1 by the plan rule (ops/hopper_stft.py::
// frames_radix_plan): 16s, the power of two left (8, 4 or 2), then the odd
// primes in ascending order; none for L = 1.  Returns their count.
int radix_rule(long long L, int* out) {
    int k = 0, twos = 0;
    while (L % 2 == 0) {
        L /= 2;
        ++twos;
    }
    for (int i = 0; i < twos / 4; ++i) out[k++] = 16;
    if (twos % 4) out[k++] = 1 << (twos % 4);
    for (long long p = 3; L > 1;) {
        while (L % p == 0) {
            out[k++] = (int)p;
            L /= p;
        }
        p += 2;
        if (p * p > L && L > 1) {
            out[k++] = (int)L;
            break;
        }
    }
    return k;
}

// `radices` laid out as a plan: each pass's twiddles [r - 1][k] in the
// shared table, then each prime pass's roots.
void layout_plan(const int* radices, int n_pass, FramesPlan* plan) {
    plan->n_pass = n_pass;
    int off = 0, ns = 1;
    for (int p = 0; p < n_pass; ++p) {
        plan->radix[p] = radices[p];
        plan->tw_off[p] = off;
        plan->root_off[p] = 0;
        off += (radices[p] - 1) * ns;
        ns *= radices[p];
    }
    for (int p = 0; p < n_pass; ++p) {
        if (prime_radix(radices[p])) {
            plan->root_off[p] = off;
            off += (radices[p] - 1) / 2;
        }
    }
    plan->entries = off;
}

// Whether every pass of `radices` runs in a tile (register and prime
// radices only).
bool tile_radices(const FramesPlan& plan) {
    for (int p = 0; p < plan.n_pass; ++p) {
        if (!register_radix(plan.radix[p]) && !prime_radix(plan.radix[p])) return false;
    }
    return true;
}

// The frames kernel's plan of n from the caller's radices, which must be
// the plan rule's: 0 or the failure.
int make_frames_plan(const int* radices, int n_pass, int n, FramesPlan* plan) {
    int rule[FR_MAX_PASSES];
    const int k = radix_rule(n, rule);
    bool same = n_pass == k;
    for (int p = 0; same && p < k; ++p) same = radices[p] == rule[p];
    if (!same) {
        return fail((int)cudaErrorInvalidValue, "frames plan: %d radices (%d, ...) are not the "
                    "plan rule's %d (%d, ...) at n_fft %d", n_pass, n_pass > 0 ? radices[0] : 0,
                    k, k > 0 ? rule[0] : 0, n);
    }
    layout_plan(rule, k, plan);
    return 0;
}

// A shared route's slot, in elements: the span of `frames` frames or their
// padded transforms, whichever is longer.
long long frames_slot(int n, int hop, int frames) {
    const long long span = (long long)(frames - 1) * hop + n;
    const long long transforms = padded_len((long long)frames * n);
    return span > transforms ? span : transforms;
}

bool has_prime(const FramesPlan& plan) {
    for (int p = 0; p < plan.n_pass; ++p) {
        if (prime_radix(plan.radix[p])) return true;
    }
    return false;
}

// A shared route's dynamic shared memory: the slots, a prime pass's other
// buffer, then the table (n float2, and the prime passes' roots).
long long frames_smem(const FramesPlan& plan, int n, int hop, int frames, int ring) {
    return ring * frames_slot(n, hop, frames) * (long long)sizeof(float4) +
           (has_prime(plan) ? padded_len((long long)frames * n) * 16 : 0) +
           8LL * (n + plan.entries - (n - 1));
}

// Whether every pass of `plan` over `frames` transforms of n points fits
// the registers of the block's threads (ept values a thread; a prime pass
// holds one work item at a time).
bool frames_fit(const FramesPlan& plan, long long n, long long frames, int ept) {
    const long long points = frames * n;
    if (points >= (1LL << 21)) return false;  // div_exact's range
    for (int p = 0; p < plan.n_pass; ++p) {
        const int r = plan.radix[p];
        if (prime_radix(r)) continue;
        if (!register_radix(r) || (points / r + FR_THREADS - 1) / FR_THREADS > ept / r) {
            return false;
        }
    }
    return true;
}

// Bluestein's FFT length for a cyclic convolution of at least `need`
// points: of the 2^a 3^b 5^c in [need, 2 need) whose transform fits a
// ring of `ring` slots beside `extra` float2, the one of the fewest passes
// x points (ties: the shorter); -1 for none.
long long bluestein_length(long long need, int ring, long long extra) {
    long long best = -1, best_cost = 0;
    int rad[FR_MAX_PASSES];
    for (long long a = 1; a < 2 * need; a *= 2) {
        for (long long b = a; b < 2 * need; b *= 3) {
            for (long long c = b; c < 2 * need; c *= 5) {
                if (c < need || ring * padded_len(c) * 16 + 8 * extra > SMEM_OPTIN) continue;
                const long long cost = c * radix_rule(c, rad);
                if (best < 0 || cost < best_cost || (cost == best_cost && c < best)) {
                    best = c;
                    best_cost = cost;
                }
            }
        }
    }
    return best;
}

// n1 of a four-step split of n (n = n1 n2): of the divisors within 2x of
// the square root, the one of fewest passes of n1 and n2, then the nearest
// at or above the root (9600: 120 x 80, 2 + 3 passes); without one there,
// the least divisor above the root.
int four_step_split(int n) {
    int root = 1, rad[FR_MAX_PASSES], n1 = 0, best = 1 << 30, far_best = 1 << 30;
    while ((long long)root * root < n) ++root;
    for (int d = root / 2 > 1 ? root / 2 : 1; d <= 2 * root; ++d) {
        if (n % d) continue;
        const int cost = radix_rule(d, rad) + radix_rule(n / d, rad);
        const int far = d >= root ? d - root : root - d + n;
        if (cost < best || (cost == best && far < far_best)) {
            best = cost;
            far_best = far;
            n1 = d;
        }
    }
    if (n1 == 0) {
        n1 = root;
        while (n % n1) ++n1;
    }
    return n1;
}

// Route four_step's plan at n (ops/hopper_stft.py::four_step_config is the
// wrapper's copy): 0, or -1 where n has a radix other than the register
// radices, or its frame, tables and groups fit no block.
int four_step_choose(int n, FourStepPlan* fp) {
    int rad[FR_MAX_PASSES];
    const int k = radix_rule(n, rad);
    for (int p = 0; p < k; ++p) {
        if (!register_radix(rad[p])) return -1;
    }
    *fp = FourStepPlan{};
    fp->n1 = four_step_split(n);
    fp->n2 = n / fp->n1;
    int r[FR_MAX_PASSES];
    layout_plan(r, radix_rule(fp->n1, r), &fp->p1);
    layout_plan(r, radix_rule(fp->n2, r), &fp->p2);
    int cols = 0, rows = 0;
    for (int c = fp->n2; c >= 1 && cols == 0; --c) {
        if (frames_fit(fp->p1, fp->n1, c, ROUTE_VALUES[ROUTE_SHARED])) cols = c;
    }
    for (int c = fp->n1; c >= 1 && rows == 0; --c) {
        if (frames_fit(fp->p2, fp->n2, c, ROUTE_VALUES[ROUTE_SHARED])) rows = c;
    }
    if (cols == 0 || rows == 0 || n >= (1 << 21)) return -1;
    const int col_groups = (fp->n2 + cols - 1) / cols, row_groups = (fp->n1 + rows - 1) / rows;
    fp->cols = (fp->n2 + col_groups - 1) / col_groups;
    fp->rows = (fp->n1 + row_groups - 1) / row_groups;
    fp->smem = padded_len(n) * 16 +
               8LL * (four_step_entries(n) + fp->p1.entries + fp->p2.entries);
    return fp->smem <= SMEM_OPTIN ? 0 : -1;
}

// The global route's four-step plan at n: 0, or -1 where n has none (a
// Bluestein part whose transform fits no shared tile, or rows that fit
// none).
int split_choose(int n, GlobalPlan* g) {
    int rad[FR_MAX_PASSES];
    const int k = radix_rule(n, rad);
    long long q = 1;
    for (int p = 0; p < k; ++p) {
        if (!register_radix(rad[p]) && !prime_radix(rad[p])) q *= rad[p];
    }
    *g = GlobalPlan{};
    if (q > 1) {
        g->n1 = (int)q;
    } else {
        g->n1 = four_step_split(n);
    }
    g->n2 = n / g->n1;
    const int n1 = g->n1, n2 = g->n2;
    int r2[FR_MAX_PASSES];
    layout_plan(r2, radix_rule(n2, r2), &g->p2);
    // launch B: the most lower rows a unit whose rows and mirrors fit a tile,
    // in two input slots, else one
    const int lower = n1 / 2 + 1;
    int rows = 0;
    for (int ring = 2; ring >= 1 && rows == 0; --ring) {
        for (int c = lower; c >= 1; --c) {
            if (frames_fit(g->p2, n2, 2LL * c, WIDE) &&
                (ring + has_prime(g->p2)) * padded_len(2LL * c * n2) * 16 +
                        8LL * g->p2.entries <= SMEM_OPTIN) {
                rows = c;
                g->ring_rows = ring;
                break;
            }
        }
    }
    if (rows == 0) return -1;
    g->row_groups = (lower + rows - 1) / rows;
    g->rows = (lower + g->row_groups - 1) / g->row_groups;
    g->smem_rows = (g->ring_rows + has_prime(g->p2)) * padded_len(2LL * g->rows * n2) * 16 +
                   8LL * g->p2.entries;
    int cols = 0;
    if (q == 1) {
        int r1[FR_MAX_PASSES];
        layout_plan(r1, radix_rule(n1, r1), &g->p1);
        for (int ring = 2; ring >= 1 && cols == 0; --ring) {
            for (int c = n2; c >= 1; --c) {
                if (frames_fit(g->p1, n1, c, WIDE) &&
                    (ring + has_prime(g->p1)) * padded_len((long long)c * n1) * 16 +
                            8LL * (g->p1.entries + four_step_entries(n)) <= SMEM_OPTIN) {
                    cols = c;
                    g->ring_cols = ring;
                    break;
                }
            }
        }
        if (cols == 0) return -1;
        g->blocks = 1;
    } else {
        // one slot (three columns of 4096 in one read faster than one in
        // two, PERF.md §6) and the fewest output blocks
        g->q = (int)q;
        g->ring_cols = 1;
        for (int J = 1; J <= MAX_BLUESTEIN_BLOCKS && g->m_len == 0; ++J) {
            const long long outs = (q + J - 1) / J;
            const long long M = bluestein_length(q + outs - 1, 1, four_step_entries(n));
            if (M > 0) {
                g->m_len = (int)M;
                g->blocks = g->filters = J;
                g->outs = (int)outs;
            }
        }
        if (g->m_len == 0) return -1;
        g->m_pass = radix_rule(g->m_len, g->m_radix);
        for (int c = n2; c >= 1; --c) {
            const long long pts = (long long)c * g->m_len;
            if (g->ring_cols * padded_len(pts) * 16 + 8LL * four_step_entries(n) <= SMEM_OPTIN &&
                pts < (1LL << 21)) {
                cols = c;
                break;
            }
        }
        // the chirp table: conj b_r (q), M's twiddles (M), the filters (J M)
        g->cc_off = 0;
        g->twm_off = q;
        g->h_off = g->twm_off + g->m_len;
    }
    g->col_groups = (n2 + cols - 1) / cols;
    g->cols = (n2 + g->col_groups - 1) / g->col_groups;
    g->smem_cols = (g->ring_cols + (q == 1 && has_prime(g->p1))) *
                       padded_len((long long)g->cols * (q == 1 ? n1 : g->m_len)) * 16 +
                   8LL * four_step_entries(n) + (q == 1 ? 8LL * g->p1.entries : 0);
    return 0;
}

// The global route's whole-frame Bluestein plan at n (the design note
// above): P input blocks and O lower output blocks of S = M / 2 points;
// the chirp table holds conj b_k for k <= n, M's twiddles and 2 (P + O -
// 1) filters; launch A's block one slot of M, launch B's that and S bins.
void chirp_choose(int n, GlobalPlan* g) {
    *g = GlobalPlan{};
    g->n1 = g->q = n;
    g->n2 = g->cols = g->col_groups = g->ring_cols = g->ring_rows = 1;
    g->m_len = CHIRP_M;
    g->outs = CHIRP_M / 2;
    g->blocks = (n + g->outs - 1) / g->outs;
    g->segments = g->rows = g->row_groups = (n / 2 + g->outs) / g->outs;
    g->filters = 2 * (g->blocks + g->segments - 1);
    g->m_pass = radix_rule(g->m_len, g->m_radix);
    g->cc_off = 0;
    g->twm_off = n + 1LL;
    g->h_off = g->twm_off + g->m_len;
    g->smem_cols = padded_len(g->m_len) * 16;
    g->smem_rows = (padded_len(g->m_len) + g->outs) * 16;
}

// The global route's plan at n (ops/hopper_stft.py::global_config is the
// wrapper's copy): the four-step split where it fits, else the
// whole-frame Bluestein, which takes every n.
void global_choose(int n, GlobalPlan* g) {
    if (split_choose(n, g) != 0) chirp_choose(n, g);
}

// The chirp table's float32 length (0 without Bluestein).
long long chirp_floats(const GlobalPlan& g) {
    return g.q == 0 ? 0 : 2 * (g.h_off + (long long)g.filters * g.m_len);
}

// The route, frames a tile and ring of span slots that a launch at (n,
// hop) takes (ops/hopper_stft.py::frames_config is the wrapper's copy):
// the first shared route where a tile fits the registers and 227 KB, a
// ring of two slots before one, the most frames a tile; else route
// four_step where a frame fits a block; else the global route.  Returns
// the block's dynamic shared memory (0 on the global route).
long long frames_choose(const FramesPlan& plan, int n, int hop, int* config) {
    if (tile_radices(plan)) {
        for (int route = ROUTE_SHARED; route <= ROUTE_SHARED_WIDE; ++route) {
            for (int ring = 2; ring >= 1; --ring) {
                for (int frames = FR_MAX_FRAMES; frames >= 1; --frames) {
                    const long long smem = frames_smem(plan, n, hop, frames, ring);
                    if (smem <= SMEM_OPTIN &&
                        frames_fit(plan, n, frames, ROUTE_VALUES[route])) {
                        config[0] = route;
                        config[1] = frames;
                        config[2] = ring;
                        return smem;
                    }
                }
            }
        }
    }
    FourStepPlan fp;
    if (four_step_choose(n, &fp) == 0) {
        config[0] = ROUTE_FOUR_STEP;
        config[1] = config[2] = 1;
        return fp.smem;
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
template <int EPT, bool PRIMES>
int launch_frames(const void* x, long long clip_stride, long long N, int T, int hop, int n,
                  const void* table, const FramesPlan& plan, int frames, int ring, int units,
                  int tiles_per_clip, size_t smem, void* re, void* im, cudaStream_t stream) {
    const long long resident = resident_blocks(stft_frames_fft_kernel<EPT, PRIMES>, smem,
                                               "stft_frames_fft_kernel");
    if (resident < 0) return (int)-resident;
    const int grid = (int)(resident < units ? resident : units);
    stft_frames_fft_kernel<EPT, PRIMES><<<grid, FR_THREADS, smem, stream>>>(
        static_cast<const float*>(x), clip_stride, N, T, hop, n,
        static_cast<const float*>(table), plan, frames, ring,
        (int)frames_slot(n, hop, frames), tiles_per_clip, units, static_cast<float*>(re),
        static_cast<float*>(im));
    return check_launch("stft_frames_fft_kernel");
}

// The global route's two launches (persistent grids): launch A's instance
// by n1's plan (prime passes or not) or Bluestein, launch B's by n2's.
template <bool P1, bool CHIRP, bool P2>
int launch_global(const void* x, long long clip_stride, long long N, int B, int T, int hop,
                  int n, const void* table, const void* chirps, const GlobalPlan& g,
                  void* scratch, void* re, void* im, cudaStream_t stream) {
    const long long frames = (long long)B * T;
    const long long units_a = frames * g.col_groups * g.blocks;
    long long resident = resident_blocks(stft_frames_cols_kernel<P1, CHIRP>,
                                         (size_t)g.smem_cols, "stft_frames_cols_kernel");
    if (resident < 0) return (int)-resident;
    stft_frames_cols_kernel<P1, CHIRP><<<(int)(resident < units_a ? resident : units_a),
                                         FR_THREADS, (size_t)g.smem_cols, stream>>>(
        static_cast<const float4*>(x), clip_stride, N, T, hop, n,
        static_cast<const float*>(table), static_cast<const float2*>(chirps), g, units_a,
        static_cast<float4*>(scratch));
    if (int rc = check_launch("stft_frames_cols_kernel")) return rc;
    const long long units_b = frames * g.row_groups;
    resident = resident_blocks(stft_frames_rows_kernel<P2>, (size_t)g.smem_rows,
                               "stft_frames_rows_kernel");
    if (resident < 0) return (int)-resident;
    stft_frames_rows_kernel<P2><<<(int)(resident < units_b ? resident : units_b), FR_THREADS,
                                  (size_t)g.smem_rows, stream>>>(
        static_cast<const float4*>(scratch), n, static_cast<const float*>(table), g, units_b,
        static_cast<float*>(re), static_cast<float*>(im));
    return check_launch("stft_frames_rows_kernel");
}

// The whole-frame Bluestein's two launches (persistent grids).
int launch_chirp(const void* x, long long clip_stride, long long N, int B, int T, int hop,
                 int n, const void* table, const void* chirps, const GlobalPlan& g,
                 void* scratch, void* re, void* im, cudaStream_t stream) {
    const long long frames = (long long)B * T;
    const long long units_a = frames * g.blocks;
    long long resident = resident_blocks(stft_frames_chirp_in_kernel, (size_t)g.smem_cols,
                                         "stft_frames_chirp_in_kernel");
    if (resident < 0) return (int)-resident;
    stft_frames_chirp_in_kernel<<<(int)(resident < units_a ? resident : units_a), FR_THREADS,
                                  (size_t)g.smem_cols, stream>>>(
        static_cast<const float4*>(x), clip_stride, N, T, hop, n,
        static_cast<const float*>(table), static_cast<const float2*>(chirps), g, units_a,
        static_cast<float4*>(scratch));
    if (int rc = check_launch("stft_frames_chirp_in_kernel")) return rc;
    const long long units_b = frames * g.segments;
    resident = resident_blocks(stft_frames_chirp_out_kernel, (size_t)g.smem_rows,
                               "stft_frames_chirp_out_kernel");
    if (resident < 0) return (int)-resident;
    stft_frames_chirp_out_kernel<<<(int)(resident < units_b ? resident : units_b), FR_THREADS,
                                   (size_t)g.smem_rows, stream>>>(
        static_cast<const float4*>(scratch), n, static_cast<const float2*>(chirps), g, units_b,
        static_cast<float*>(re), static_cast<float*>(im));
    return check_launch("stft_frames_chirp_out_kernel");
}

int launch_global(const void* x, long long clip_stride, long long N, int B, int T, int hop,
                  int n, const void* table, const void* chirps, const GlobalPlan& g,
                  void* scratch, void* re, void* im, cudaStream_t stream) {
    auto go = [&](auto launch) {
        return launch(x, clip_stride, N, B, T, hop, n, table, chirps, g, scratch, re, im,
                      stream);
    };
    const bool p2 = has_prime(g.p2);
    if (g.segments > 0) return go(launch_chirp);
    if (g.q > 0) {
        return p2 ? go(launch_global<false, true, true>) : go(launch_global<false, true, false>);
    }
    if (has_prime(g.p1)) {
        return p2 ? go(launch_global<true, false, true>) : go(launch_global<true, false, false>);
    }
    return p2 ? go(launch_global<false, false, true>) : go(launch_global<false, false, false>);
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
// `radices` of its plan (frames_choose, global_choose) into config[0..11]:
// route, frames a tile, ring; on the global route n1, n2, columns a unit
// of stft_frames_cols_kernel, lower rows a unit of stft_frames_rows_kernel,
// Bluestein's output blocks J and length M (0 without; on the whole-frame
// Bluestein n, 1, 1, its lower output blocks, its input blocks P and M),
// stft_frames_rows_kernel's dynamic shared memory, and each kernel's input
// slots.  Returns the block's
// dynamic shared memory (the shared route's kernel, or
// stft_frames_cols_kernel), or -1 for arguments no launch takes.  No
// device work: it lets the wrapper's copy of the rule be checked against
// this one.
extern "C" long long adyolo_stft_frames_config(int n, int hop, const int* radices, int n_pass,
                                               int* config) {
    for (int i = 0; i < 12; ++i) config[i] = 0;
    FramesPlan plan;
    if (n < 2 || n > (1 << 30) || hop < 1 || make_frames_plan(radices, n_pass, n, &plan) != 0) {
        return -1LL;
    }
    const long long smem = frames_choose(plan, n, hop, config);
    if (config[0] == ROUTE_FOUR_STEP) {
        FourStepPlan fp;
        four_step_choose(n, &fp);
        config[3] = fp.n1;
        config[4] = fp.n2;
        config[5] = fp.cols;
        config[6] = fp.rows;
    }
    if (config[0] != ROUTE_GLOBAL) return smem;
    GlobalPlan g;
    global_choose(n, &g);
    config[3] = g.n1;
    config[4] = g.n2;
    config[5] = g.cols;
    config[6] = g.rows;
    config[7] = g.q ? g.blocks : 0;
    config[8] = g.m_len;
    config[9] = (int)g.smem_rows;
    config[10] = g.ring_cols;
    config[11] = g.ring_rows;
    return g.smem_cols;
}

// C entry point of the frames kernel.  x: flat (B, N, 4) float32 audio,
// clip b at x + b * clip_stride (float4 units), 16-byte aligned; T = N /
// hop frames; table: table_len float32, the twiddles e^{-2 pi i m / n} as
// (re, im) pairs, then the window (3 n); chirps: chirp_len float32 of
// Bluestein's chirp, twiddles and filters where the global route's plan
// has one (ops/hopper_stft.py::chirp_table), else unread; radices: the frames
// plan (ops/hopper_stft.py::frames_radix_plan); route, frames, ring:
// ops/hopper_stft.py::frames_config's choice, which this checks (routes 2,
// global, and 3, four_step: the plan follows from n, and frames and ring
// are not read; route 2's `scratch` holds B T n float4, or B T P M on
// the whole-frame Bluestein); re, im: (B, T, n
// / 2 + 1, 4) float32.  Needs N > n / 2 (the reflection of frame 0 stays
// inside the clip).  Launches on `stream` (route 2: two launches); returns
// as adyolo_stft_fft.
extern "C" int adyolo_stft_frames_fft(const void* x, long long clip_stride, long long N, int B,
                                      int T, int hop, int n, const void* table,
                                      long long table_len, const void* chirps,
                                      long long chirp_len, const int* radices, int n_pass,
                                      int route, int frames, int ring, void* scratch,
                                      long long scratch_bytes, void* re, void* im,
                                      void* stream) {
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
        GlobalPlan g;
        global_choose(n, &g);
        const long long need = (long long)B * T * sizeof(float4) *
                               (g.segments > 0 ? (long long)g.blocks * g.m_len : n);
        if (table_len != 3LL * n || chirp_len != chirp_floats(g) ||
            (g.q > 0 && (chirps == nullptr ||
                         reinterpret_cast<unsigned long long>(chirps) % 8 != 0))) {
            return fail((int)cudaErrorInvalidValue, "global route at n_fft %d: table of %lld "
                        "floats (3 n_fft), chirp table %p of %lld floats (%lld, 8-byte "
                        "aligned)", n, table_len, chirps, chirp_len, chirp_floats(g));
        }
        if (scratch == nullptr || scratch_bytes < need ||
            reinterpret_cast<unsigned long long>(scratch) % 16 != 0) {
            return fail((int)cudaErrorInvalidValue, "global route: scratch %p of %lld B (B T "
                        "n_fft float4, or B T P M on the whole-frame Bluestein: %lld B, "
                        "16-byte aligned)", scratch, scratch_bytes, need);
        }
        return launch_global(x, clip_stride, N, B, T, hop, n, table, chirps, g, scratch, re,
                             im, st);
    }
    if (route == ROUTE_FOUR_STEP) {
        FourStepPlan fp;
        if (table_len != 3LL * n || four_step_choose(n, &fp) != 0) {
            return fail((int)cudaErrorInvalidValue, "route 3 (four_step) at n_fft %d: table of "
                        "%lld floats (3 n_fft), or no frame plan", n, table_len);
        }
        const long long units = (long long)B * T;
        const long long resident = resident_blocks(stft_frames_4step_kernel, (size_t)fp.smem,
                                                   "stft_frames_4step_kernel");
        if (resident < 0) return (int)-resident;
        stft_frames_4step_kernel<<<(int)(resident < units ? resident : units), FR_THREADS,
                                   (size_t)fp.smem, st>>>(
            static_cast<const float4*>(x), clip_stride, N, T, hop, n,
            static_cast<const float*>(table), fp, units, static_cast<float*>(re),
            static_cast<float*>(im));
        return check_launch("stft_frames_4step_kernel");
    }
    if (route < ROUTE_SHARED || route > ROUTE_SHARED_WIDE) {
        return fail((int)cudaErrorInvalidValue, "route %d (0, 1 shared, 2 global, 3 "
                    "four_step)", route);
    }
    if (table_len != 3LL * n || !tile_radices(plan)) {
        return fail((int)cudaErrorInvalidValue, "route %d at n_fft %d: table of %lld floats "
                    "(3 n_fft), or a radix above %d", route, n, table_len, PRIME_MAX);
    }
    const int ept = ROUTE_VALUES[route];
    const long long smem = frames >= 1 && (ring == 1 || ring == 2)
        ? frames_smem(plan, n, hop, frames, ring) : -1;
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
    // the instance with prime passes only for a plan that has them
    const bool primes = has_prime(plan);
    auto go = [&](auto launch) {
        return launch(x, clip_stride, N, T, hop, n, table, plan, frames, ring, (int)units,
                      tiles_per_clip, (size_t)smem, re, im, st);
    };
    if (route == ROUTE_SHARED) {
        return primes ? go(launch_frames<16, true>) : go(launch_frames<16, false>);
    }
    return primes ? go(launch_frames<32, true>) : go(launch_frames<32, false>);
}
