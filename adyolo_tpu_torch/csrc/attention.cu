// Online-softmax multi-head attention forward for Hopper (sm_90a), fp32 FFMA.
//
// Replaces two TPU kernels of adyolo_tpu/ops/flash_mhsa.py:
//   * K2 `_fwd_kernel` (:89, launched by `_flash_fwd` at :180) at dropout
//     rate 0: the conformer's eval attention for T <= 2400 frames;
//   * K4 `_long_kernel` (:288, launched by `flash_mhsa_long` at :358): the
//     online-softmax forward for T > 2400 (eval buckets up to 38400).
// K2 holds all of K and V of one (batch, head) in VMEM.  That does not carry
// over: at T = 2400, dh = 64, f32, K+V is 1.2 MB against 227 KB of shared
// memory per block.  So on Hopper both become the same KV-tiled
// online-softmax pass (flash-attention-2 style), one __global__ that the
// wrapper (ops/hopper_attention.py) launches from two entries and counts
// apart.
//
// What it computes, for q/k/v/out (B, T, H, 64) f32 read and written in
// place as the Dense layers lay them out (no head-fold copy, no key pad):
//   out[b, t, h] = sum_{j < L} softmax_j(q[b,t,h] . k[b,j,h] * 64^-0.5) v[b,j,h]
// with L = min(kv_len[b], T).  Every query row is computed (padded rows see
// only the valid keys, as in JAX).  A batch row with L == 0 gets zeros (K4's
// convention).
//
// Design.  One 128-thread block per (32-query tile, b*h).  The Q tile stays
// in shared memory; the loop walks 64-key K and V tiles through shared
// memory, only up to ceil(L / 64).  Thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 8i (i < 4): for S = Q.K^T it takes keys tx + 16j
// (j < 4), for O += P.V the output dims 4tx..4tx+3.  The running row max
// and sum stay in registers; the max is reduced across the 16 lanes of a
// row with shuffles, the sum only once at the end.  P goes through shared
// memory between the two products.  Row strides are padded (K: 68, P: 80
// floats) so that the float4 and scalar accesses are free of bank conflicts.
//
// What bounds it on an H100: per (b, h) the pass does 4*T*L*64 FLOP and
// reads K and V (2*L*64*4 bytes) from HBM about once (the query tiles of one
// (b, h) share them through L2): at T = L = 800 that is ~400 FLOP per byte
// of K/V, far above the 20 FLOP/byte the card's 67 TFLOP/s FFMA and
// 3.35 TB/s allow -- so it is FFMA-bound, and inside the block bound by
// shared-memory loads (8 LDS.128 per 64 FFMA in both products).  f32 FFMA
// on purpose: TF32 would spend the eval's 1e-3 * max-logit budget by itself.
// The KV loop bound saves what the plain version computes for nothing: a
// 35-s clip in the 2400-frame bucket has 1400 of 2400 keys valid, so the
// kernel does 58 % of the plain version's FLOP.  At B = 1, T = 1200 the grid
// is 38 x 4 = 152 blocks for 132 SMs; a 64-query tile would give 76 and
// leave 56 SMs idle, hence the 32-query tile.  wgmma on 3xTF32, TMA and
// warp specialisation are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int BQ = 32;        // queries per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 8 row groups x 16 lanes
constexpr int RPT = BQ / 8;   // rows per thread (4)
constexpr int KPT = BKV / 16; // keys per thread (4)
constexpr int KS = DH + 4;    // K row stride: conflict-free float4 reads
constexpr int PS = BKV + 16;  // P row stride: conflict-free scalar stores
constexpr int SMEM_FLOATS = BQ * DH + BKV * KS + BKV * DH + BQ * PS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 52,224

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float p, float4 v) {
    acc.x = fmaf(p, v.x, acc.x);
    acc.y = fmaf(p, v.y, acc.y);
    acc.z = fmaf(p, v.z, acc.z);
    acc.w = fmaf(p, v.w, acc.w);
}

__global__ void __launch_bounds__(THREADS, 4)
mhsa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ kv_len,
                float* __restrict__ out, int T, int H, float scale_log2) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // [BQ][DH]
    float* Ks = Qs + BQ * DH;      // [BKV][KS]
    float* Vs = Ks + BKV * KS;     // [BKV][DH]
    float* Ps = Vs + BKV * DH;     // [BQ][PS]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int b = blockIdx.y / H;
    const int h = blockIdx.y - b * H;
    const int q0 = blockIdx.x * BQ;
    const long long frame = (long long)H * DH;               // floats per t
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (L == 0) {  // no valid key: zeros (block-uniform, before any barrier)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int t = q0 + ty + 8 * i;
            if (t < T) st4(out + base + t * frame + 4 * tx,
                           make_float4(0.f, 0.f, 0.f, 0.f));
        }
        return;
    }

    // Q tile: 32 rows x 16 float4; rows past T are zero
#pragma unroll
    for (int p = 0; p < BQ * DH / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int r = idx >> 4, c = (idx & 15) * 4;
        const int t = q0 + r;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < T) val = __ldg(reinterpret_cast<const float4*>(q + base + t * frame + c));
        st4(Qs + r * DH + c, val);
    }

    float m[RPT], l[RPT];
    float4 acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    const int n_tiles = (L + BKV - 1) / BKV;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int j0 = tile * BKV;
        // K and V tiles: 64 rows x 16 float4 each; keys past L are zero so
        // that 0 * v stays 0 below
#pragma unroll
        for (int p = 0; p < BKV * DH / 4 / THREADS; ++p) {
            const int idx = tid + p * THREADS;
            const int r = idx >> 4, c = (idx & 15) * 4;
            const int j = j0 + r;
            float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
            if (j < L) {
                const long long off = base + j * frame + c;
                kk = __ldg(reinterpret_cast<const float4*>(k + off));
                vv = __ldg(reinterpret_cast<const float4*>(v + off));
            }
            st4(Ks + r * KS + c, kk);
            st4(Vs + r * DH + c, vv);
        }
        __syncthreads();

        // S = Q . K^T for rows ty + 8i, keys tx + 16j
        float s[RPT][KPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
            float4 qa[RPT], kb[KPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) qa[i] = ld4(Qs + (ty + 8 * i) * DH + d);
#pragma unroll
            for (int j = 0; j < KPT; ++j) kb[j] = ld4(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < KPT; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
        }

        // online softmax in the log2 domain; keys >= L are -inf -> p = 0.
        // Tile 0 holds key 0 < L, so every row max is finite from then on.
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < KPT; ++j) {
                const int key = j0 + tx + 16 * j;
                s[i][j] = key < L ? s[i][j] * scale_log2 : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = exp2f(m[i] - m_new);  // 0 on tile 0
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < KPT; ++j) {
                const float p = exp2f(s[i][j] - m_new);
                Ps[(ty + 8 * i) * PS + tx + 16 * j] = p;
                rs += p;
            }
            l[i] = l[i] * alpha + rs;  // this lane's partial row sum
            acc[i].x *= alpha;
            acc[i].y *= alpha;
            acc[i].z *= alpha;
            acc[i].w *= alpha;
            m[i] = m_new;
        }
        __syncthreads();

        // O += P . V for rows ty + 8i, dims 4tx..4tx+3
#pragma unroll 4
        for (int j = 0; j < BKV; j += 4) {
            float4 vb[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) vb[u] = ld4(Vs + (j + u) * DH + 4 * tx);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const float4 pa = ld4(Ps + (ty + 8 * i) * PS + j);
                axpy4(acc[i], pa.x, vb[0]);
                axpy4(acc[i], pa.y, vb[1]);
                axpy4(acc[i], pa.z, vb[2]);
                axpy4(acc[i], pa.w, vb[3]);
            }
        }
        __syncthreads();  // before the next tile overwrites Ks, Vs, Ps
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        float li = l[i];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
        const int t = q0 + ty + 8 * i;
        if (t < T) {
            const float inv = 1.f / li;
            st4(out + base + t * frame + 4 * tx,
                make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                            acc[i].w * inv));
        }
    }
}

}  // namespace

// C entry point (bound with ctypes).  q, k, v, out: (B, T, H, dh) float32,
// contiguous; kv_len: (B,) int32 on the device.  dh must be 64.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int adyolo_mhsa_fwd(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int T,
                               int H, int dh, void* stream) {
    if (B < 1 || T < 1 || H < 1 || dh != DH || (long long)B * H > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaFuncSetAttribute(
        mhsa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const float scale_log2 = (1.0f / sqrtf((float)DH)) * 1.4426950408889634f;
    dim3 grid((T + BQ - 1) / BQ, B * H);
    mhsa_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<float*>(out), T, H, scale_log2);
    return (int)cudaGetLastError();
}
