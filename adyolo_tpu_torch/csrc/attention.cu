// Multi-head attention for Hopper (sm_90a), fp32 FFMA: the online-softmax
// forward (eval, and train with dropout) and the attention backward.
//
// Replaces three TPU kernels of adyolo_tpu/ops/flash_mhsa.py:
//   * K2 `_fwd_kernel` (:89, launched by `_flash_fwd` at :180): the
//     conformer's attention for T <= 2400 frames, at dropout rate 0 (eval,
//     `mhsa_fwd_kernel<false>`) and in training with the u8-threshold
//     dropout on the probabilities (`mhsa_fwd_kernel<true>`, which also
//     writes the row logsumexp for the backward);
//   * K3 `_bwd_kernel` (:107, launched by `_flash_bwd` at :202): the
//     backward, as `mhsa_bwd_delta_kernel` + `mhsa_bwd_dq_kernel` +
//     `mhsa_bwd_dkdv_kernel`;
//   * K4 `_long_kernel` (:288, launched by `flash_mhsa_long` at :358): the
//     online-softmax forward for T > 2400 (eval buckets up to 38400), the
//     same `mhsa_fwd_kernel<false>`.
// K2/K3 hold all of K and V of one (batch, head) in VMEM.  That does not
// carry over: at T = 2400, dh = 64, f32, K+V is 1.2 MB against 227 KB of
// shared memory per block.  So the forward is a KV-tiled online-softmax
// pass (flash-attention-2 style) that the wrapper (ops/hopper_attention.py)
// launches from counted routes, and the backward recomputes the
// probabilities tile by tile from the saved logsumexp.
//
// What the forward computes, for q/k/v/out (B, T, H, 64) f32 read and
// written in place as the Dense layers lay them out (no head-fold copy, no
// key pad):
//   out[b, t, h] = sum_{j < L} keep(t, j) * ks * softmax_j(q.k_j * 64^-0.5) v_j
// with L = min(kv_len[b], T), ks = 256 / (256 - thresh), keep = 1 at
// thresh 0.  The softmax normaliser sums the undropped probabilities.
// Every query row is computed (padded rows see only the valid keys, as in
// JAX).  A batch row with L == 0 gets zeros (K4's convention).
//
// The dropout bits are the splitmix32 position hash of the JAX kernels'
// interpret mode (flash_mhsa.py:64-71), indexed by the JAX blocking so that
// the masks agree bit for bit with it and with the plain version
// (ops/attention.py::dropout_bits): for query t and key j,
//   x = (t % bq) * Tp + j + seed * 0x9E3779B9 + ((b*H + h) * nq + t / bq)
//       * 0x85EBCA6B  (uint32), keep = mix(x) >= thresh << 24,
// bq the JAX query block, nq = T / bq, Tp = ceil(T / 128) * 128.
//
// The backward, with p = exp(s - lse) recomputed and D = rowsum(dO o O)
// (which equals rowsum(dp o p) with dropout on, as O = pd . V):
//   dp = keep * ks * dO . V^T,  ds = p o (dp - D) * 64^-0.5,
//   dq = ds . K,  dk = ds^T . Q,  dv = (keep * ks * p)^T . dO.
// The TPU kernel sums dk/dv over a sequential query-block grid dimension;
// Hopper blocks run in no order, so dk/dv come from a KV-tile-parallel pass
// that loops over the query tiles (f32 sums in registers), and dq from a
// query-tile-parallel pass that loops over the key tiles: deterministic,
// no atomics.  Keys >= L get zero gradients; an L == 0 row gets zeros.
//
// Design.  Every kernel is one 128-thread block per (32-row tile, b*h);
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8i (i < 4), takes
// columns tx + 16j (j < 4) of a 32 x 64 score tile and output dims
// 4tx..4tx+3 of the products with a 64-row operand.  The forward and dq
// own 32 queries and walk 64-key tiles up to ceil(L / 64); dkdv owns 32
// keys and walks 64-query tiles.  Score tiles go through shared memory
// between the two products.  Row strides of the operands read row-wise
// are padded (68 floats, P/dS tiles 80) so that the float4 and scalar
// accesses are free of bank conflicts.
//
// What bounds them on an H100: per (b, h) a pass does 4*T*L*64 FLOP (the
// forward) or 14*T*L*64 (the backward: S and dO.V^T in both passes, dq,
// dk, dv) and reads K and V about once per pass (the tiles of one (b, h)
// share them through L2): at T = L = 800 that is hundreds of FLOP per
// byte, far above the 20 FLOP/byte the card's 67 TFLOP/s FFMA and
// 3.35 TB/s allow -- so they are FFMA-bound, and inside the block bound by
// shared-memory loads.  f32 FFMA on purpose: TF32 would spend the eval's
// 1e-3 * max-logit budget by itself.  At B = 1, T = 1200 the grid is 38 x 4
// = 152 blocks for 132 SMs; a 64-row tile would give 76, hence 32 rows.
// wgmma on 3xTF32, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int BR = 32;        // rows a block owns (queries; keys in dkdv)
constexpr int BC = 64;        // columns of a tile (keys; queries in dkdv)
constexpr int THREADS = 128;  // 8 row groups x 16 lanes
constexpr int RPT = BR / 8;   // rows per thread (4)
constexpr int CPT = BC / 16;  // columns per thread (4)
constexpr int KS = DH + 4;    // stride of operands read row-wise
constexpr int PS = BC + 16;   // stride of score tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr size_t FWD_SMEM = (BR * DH + BC * KS + BC * DH + BR * PS) * sizeof(float);
constexpr size_t DQ_SMEM = (2 * BR * DH + 2 * BC * KS + BR * PS) * sizeof(float);
constexpr size_t DKDV_SMEM = (2 * BR * DH + 2 * BC * KS + 2 * BR * PS + 2 * BC) * sizeof(float);

// The dropout of one call: keep a probability when its bits are >= t24.
struct Drop {
    unsigned t24;    // thresh << 24 (0: no dropout)
    float kscale;    // 256 / (256 - thresh)
    int bq, nq;      // the JAX query block and count
    unsigned tp;     // keys padded to 128
};

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

// The hash's per-query part: everything of x but the key index.
__device__ __forceinline__ unsigned row_base(const Drop& d, unsigned seed_term,
                                             int bh, int t) {
    const unsigned lane = (unsigned)(bh * d.nq + t / d.bq);
    return (unsigned)(t % d.bq) * d.tp + seed_term + lane * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool keep_bit(const Drop& d, unsigned base, int key) {
    unsigned x = base + (unsigned)key;
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return (x ^ (x >> 16)) >= d.t24;
}

// Load rows [r0, r0 + R) of one head into smem (row stride `stride`), rows
// >= n as zeros.  R * 16 float4 over the block's threads.
template <int R>
__device__ __forceinline__ void load_rows(float* dst, int stride, const float* src,
                                          long long base, long long frame, int r0,
                                          int n, int tid) {
#pragma unroll
    for (int p = 0; p < R * DH / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
        const int r = idx >> 4, c = (idx & 15) * 4;
        const int t = r0 + r;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < n) val = __ldg(reinterpret_cast<const float4*>(src + base + t * frame + c));
        st4(dst + r * stride + c, val);
    }
}

// Forward.  TRAIN: dropout (when d.t24 > 0) and the row logsumexp written
// to lse (B, H, T) in natural log units.
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 4)
mhsa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ kv_len,
                const int* __restrict__ seed, float* __restrict__ out,
                float* __restrict__ lse, int T, int H, float scale_log2, Drop d) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // [BR][DH]
    float* Ks = Qs + BR * DH;      // [BC][KS]
    float* Vs = Ks + BC * KS;      // [BC][DH]
    float* Ps = Vs + BC * DH;      // [BR][PS]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int q0 = blockIdx.x * BR;
    const long long frame = (long long)H * DH;               // floats per t
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (L == 0) {  // no valid key: zeros (block-uniform, before any barrier)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int t = q0 + ty + 8 * i;
            if (t < T) {
                st4(out + base + t * frame + 4 * tx, make_float4(0.f, 0.f, 0.f, 0.f));
                if (TRAIN && tx == 0) lse[(long long)bh * T + t] = -INFINITY;
            }
        }
        return;
    }

    const bool drop = TRAIN && d.t24 != 0u;
    unsigned rbase[RPT];
    if (drop) {
        const unsigned seed_term = (unsigned)seed[0] * 0x9E3779B9u;
#pragma unroll
        for (int i = 0; i < RPT; ++i) rbase[i] = row_base(d, seed_term, bh, q0 + ty + 8 * i);
    }

    load_rows<BR>(Qs, DH, q, base, frame, q0, T, tid);

    float m[RPT], l[RPT];
    float4 acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    const int n_tiles = (L + BC - 1) / BC;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int j0 = tile * BC;
        // keys past L are zero so that 0 * v stays 0 below
        load_rows<BC>(Ks, KS, k, base, frame, j0, L, tid);
        load_rows<BC>(Vs, DH, v, base, frame, j0, L, tid);
        __syncthreads();

        // S = Q . K^T for rows ty + 8i, keys tx + 16j
        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll
        for (int dd = 0; dd < DH; dd += 4) {
            float4 qa[RPT], kb[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) qa[i] = ld4(Qs + (ty + 8 * i) * DH + dd);
#pragma unroll
            for (int j = 0; j < CPT; ++j) kb[j] = ld4(Ks + (tx + 16 * j) * KS + dd);
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
        }

        // online softmax in the log2 domain; keys >= L are -inf -> p = 0.
        // Tile 0 holds key 0 < L, so every row max is finite from then on.
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
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
            for (int j = 0; j < CPT; ++j) {
                const int key = j0 + tx + 16 * j;
                const float p = exp2f(s[i][j] - m_new);
                rs += p;  // the normaliser sums the undropped probabilities
                Ps[(ty + 8 * i) * PS + tx + 16 * j] =
                    (drop && !keep_bit(d, rbase[i], key)) ? 0.f : p;
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
        for (int j = 0; j < BC; j += 4) {
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
            const float inv = (drop ? d.kscale : 1.f) / li;
            st4(out + base + t * frame + 4 * tx,
                make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                            acc[i].w * inv));
            if (TRAIN && tx == 0) lse[(long long)bh * T + t] = (m[i] + log2f(li)) * LN2;
        }
    }
}

// D = rowsum(dO o O) -> delta (B, H, T); 16 lanes per row, 8 rows a block.
__global__ void __launch_bounds__(THREADS)
mhsa_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                      float* __restrict__ delta, int B, int T, int H) {
    const int tx = threadIdx.x & 15;
    const long long row = (long long)blockIdx.x * (THREADS / 16) + (threadIdx.x >> 4);
    const bool valid = row < (long long)B * T * H;  // row = (b*T + t)*H + h
    float acc = 0.f;
    if (valid) acc = dot4(__ldg(reinterpret_cast<const float4*>(out + row * DH + 4 * tx)),
                          __ldg(reinterpret_cast<const float4*>(dout + row * DH + 4 * tx)), 0.f);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (valid && tx == 0) {
        const long long h = row % H, bt = row / H, t = bt % T, b = bt / T;
        delta[(b * H + h) * T + t] = acc;
    }
}

// S = A . B^T and E = C . D^T for this thread's rows (A, C in [BR][DH],
// rows ty + 8i) and columns (B, D in [BC][KS], rows tx + 16j).
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* Dm,
                                             int tx, int ty, float s[RPT][CPT],
                                             float e[RPT][CPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = e[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DH; dd += 4) {
        float4 a[RPT], bb[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = ld4(A + (ty + 8 * i) * DH + dd);
#pragma unroll
        for (int j = 0; j < CPT; ++j) bb[j] = ld4(Bm + (tx + 16 * j) * KS + dd);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = dot4(a[i], bb[j], s[i][j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = ld4(C + (ty + 8 * i) * DH + dd);
#pragma unroll
        for (int j = 0; j < CPT; ++j) bb[j] = ld4(Dm + (tx + 16 * j) * KS + dd);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) e[i][j] = dot4(a[i], bb[j], e[i][j]);
    }
}

// acc[i] += sum_c P[row i][c] * X[c][4tx..4tx+3] over the BC columns.
__device__ __forceinline__ void score_times(const float* P, const float* X, int xstride,
                                            int tx, int ty, float4 acc[RPT]) {
#pragma unroll 4
    for (int c = 0; c < BC; c += 4) {
        float4 xb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) xb[u] = ld4(X + (c + u) * xstride + 4 * tx);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const float4 pa = ld4(P + (ty + 8 * i) * PS + c);
            axpy4(acc[i], pa.x, xb[0]);
            axpy4(acc[i], pa.y, xb[1]);
            axpy4(acc[i], pa.z, xb[2]);
            axpy4(acc[i], pa.w, xb[3]);
        }
    }
}

// dq for 32 queries, looping over the 64-key tiles up to ceil(L / 64).
__global__ void __launch_bounds__(THREADS, 2)
mhsa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ kv_len,
                   const int* __restrict__ seed, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int T, int H, float scale, Drop d) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // [BR][DH]
    float* Os = Qs + BR * DH;      // [BR][DH]  dO
    float* Ks = Os + BR * DH;      // [BC][KS]
    float* Vs = Ks + BC * KS;      // [BC][KS]
    float* Ss = Vs + BC * KS;      // [BR][PS]  dS

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int q0 = blockIdx.x * BR;
    const long long frame = (long long)H * DH;
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (L == 0) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int t = q0 + ty + 8 * i;
            if (t < T) st4(dq + base + t * frame + 4 * tx, make_float4(0.f, 0.f, 0.f, 0.f));
        }
        return;
    }

    const bool drop = d.t24 != 0u;
    const float scale_log2 = scale * LOG2E;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;
    unsigned rbase[RPT];
    float lse2[RPT], dlt[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int t = q0 + ty + 8 * i;
        rbase[i] = drop ? row_base(d, seed_term, bh, t) : 0u;
        lse2[i] = t < T ? lse[(long long)bh * T + t] * LOG2E : 0.f;
        dlt[i] = t < T ? delta[(long long)bh * T + t] : 0.f;
    }

    load_rows<BR>(Qs, DH, q, base, frame, q0, T, tid);
    load_rows<BR>(Os, DH, dout, base, frame, q0, T, tid);

    float4 acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    const int n_tiles = (L + BC - 1) / BC;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int j0 = tile * BC;
        load_rows<BC>(Ks, KS, k, base, frame, j0, L, tid);
        load_rows<BC>(Vs, KS, v, base, frame, j0, L, tid);
        __syncthreads();

        float s[RPT][CPT], dpd[RPT][CPT];
        two_products(Qs, Ks, Os, Vs, tx, ty, s, dpd);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int t = q0 + ty + 8 * i;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int key = j0 + tx + 16 * j;
                float ds = 0.f;
                if (key < L && t < T) {
                    const float p = exp2f(s[i][j] * scale_log2 - lse2[i]);
                    float dp = dpd[i][j];
                    if (drop) dp = keep_bit(d, rbase[i], key) ? dp * d.kscale : 0.f;
                    ds = p * (dp - dlt[i]) * scale;
                }
                Ss[(ty + 8 * i) * PS + tx + 16 * j] = ds;
            }
        }
        __syncthreads();
        score_times(Ss, Ks, KS, tx, ty, acc);  // dq += dS . K
        __syncthreads();  // before the next tile overwrites Ks, Vs, Ss
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int t = q0 + ty + 8 * i;
        if (t < T) st4(dq + base + t * frame + 4 * tx, acc[i]);
    }
}

// dk, dv for 32 keys, looping over all 64-query tiles; f32 sums in
// registers, one writer per element.
__global__ void __launch_bounds__(THREADS, 2)
mhsa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kv_len,
                     const int* __restrict__ seed, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                     float scale, Drop d) {
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;              // [BR][DH]  this block's keys
    float* Vs = Ks + BR * DH;      // [BR][DH]
    float* Qs = Vs + BR * DH;      // [BC][KS]  a query tile
    float* Os = Qs + BC * KS;      // [BC][KS]  its dO
    float* Ps = Os + BC * KS;      // [BR][PS]  (keep * ks * p)^T
    float* Ss = Ps + BR * PS;      // [BR][PS]  dS^T
    float* lse2s = Ss + BR * PS;   // [BC]
    float* dlts = lse2s + BC;      // [BC]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int k0 = blockIdx.x * BR;
    const long long frame = (long long)H * DH;
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (k0 >= L) {  // keys no query sees: zero gradients (block-uniform)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int j = k0 + ty + 8 * i;
            if (j < T) {
                st4(dk + base + j * frame + 4 * tx, make_float4(0.f, 0.f, 0.f, 0.f));
                st4(dv + base + j * frame + 4 * tx, make_float4(0.f, 0.f, 0.f, 0.f));
            }
        }
        return;
    }

    const bool drop = d.t24 != 0u;
    const float scale_log2 = scale * LOG2E;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;

    load_rows<BR>(Ks, DH, k, base, frame, k0, L, tid);
    load_rows<BR>(Vs, DH, v, base, frame, k0, L, tid);

    float4 gk[RPT], gv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        gk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        gv[i] = gk[i];
    }

    for (int c0 = 0; c0 < T; c0 += BC) {
        load_rows<BC>(Qs, KS, q, base, frame, c0, T, tid);
        load_rows<BC>(Os, KS, dout, base, frame, c0, T, tid);
        if (tid < BC) {
            const int t = c0 + tid;
            lse2s[tid] = t < T ? lse[(long long)bh * T + t] * LOG2E : 0.f;
            dlts[tid] = t < T ? delta[(long long)bh * T + t] : 0.f;
        }
        __syncthreads();

        // S^T = K . Q^T and dPd^T = V . dO^T for keys ty + 8i, queries tx + 16j
        float s[RPT][CPT], dpd[RPT][CPT];
        two_products(Ks, Qs, Vs, Os, tx, ty, s, dpd);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const int col = tx + 16 * j;
            const int t = c0 + col;
            const unsigned rb = drop && t < T ? row_base(d, seed_term, bh, t) : 0u;
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int key = k0 + ty + 8 * i;
                float pd = 0.f, ds = 0.f;
                if (key < L && t < T) {
                    const float p = exp2f(s[i][j] * scale_log2 - lse2s[col]);
                    float dp = dpd[i][j];
                    pd = p;
                    if (drop) {
                        const bool kp = keep_bit(d, rb, key);
                        pd = kp ? p * d.kscale : 0.f;
                        dp = kp ? dp * d.kscale : 0.f;
                    }
                    ds = p * (dp - dlts[col]) * scale;
                }
                Ps[(ty + 8 * i) * PS + col] = pd;
                Ss[(ty + 8 * i) * PS + col] = ds;
            }
        }
        __syncthreads();
        score_times(Ps, Os, KS, tx, ty, gv);  // dv += pd^T . dO
        score_times(Ss, Qs, KS, tx, ty, gk);  // dk += dS^T . Q
        __syncthreads();  // before the next tile overwrites Qs, Os, Ps, Ss
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int j = k0 + ty + 8 * i;
        if (j < T) {
            st4(dk + base + j * frame + 4 * tx, gk[i]);
            st4(dv + base + j * frame + 4 * tx, gv[i]);
        }
    }
}

int check_shape(int B, int T, int H, int dh) {
    if (B < 1 || T < 1 || H < 1 || dh != DH || (long long)B * H > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    return 0;
}

Drop make_drop(int thresh, int bq, int tp) {
    Drop d;
    d.t24 = thresh > 0 ? (unsigned)thresh << 24 : 0u;
    d.kscale = thresh > 0 ? 256.0f / (256.0f - (float)thresh) : 1.0f;
    d.bq = bq;
    d.nq = 1;  // set by the caller from T
    d.tp = (unsigned)tp;
    return d;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

}  // namespace

// C entry points (bound with ctypes).  q, k, v, out, dout, dq, dk, dv:
// (B, T, H, dh) float32, contiguous; kv_len: (B,) int32 and seed: (1,)
// int32 on the device; lse, delta: (B, H, T) float32.  dh must be 64.
// thresh = round(rate * 256) in [0, 255]; bq the JAX query block (T % bq
// == 0) and tp = ceil(T / 128) * 128 index the dropout hash.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success).

// Eval forward (K2 at rate 0, K4).
extern "C" int adyolo_mhsa_fwd(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int T,
                               int H, int dh, void* stream) {
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (int rc = set_smem(mhsa_fwd_kernel<false>, FWD_SMEM)) return rc;
    const float scale_log2 = (1.0f / sqrtf((float)DH)) * LOG2E;
    dim3 grid((T + BR - 1) / BR, B * H);
    mhsa_fwd_kernel<false><<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len), nullptr,
        static_cast<float*>(out), nullptr, T, H, scale_log2, make_drop(0, 1, 128));
    return (int)cudaGetLastError();
}

// Train forward (K2 with its dropout branch): out and the row logsumexp.
extern "C" int adyolo_mhsa_fwd_train(const void* q, const void* k, const void* v,
                                     const void* kv_len, const void* seed, void* out,
                                     void* lse, int B, int T, int H, int dh,
                                     int thresh, int bq, int tp, void* stream) {
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (thresh < 0 || thresh > 255 || bq < 1 || T % bq != 0 || tp < T) {
        return (int)cudaErrorInvalidValue;
    }
    if (int rc = set_smem(mhsa_fwd_kernel<true>, FWD_SMEM)) return rc;
    Drop d = make_drop(thresh, bq, tp);
    d.nq = T / bq;
    const float scale_log2 = (1.0f / sqrtf((float)DH)) * LOG2E;
    dim3 grid((T + BR - 1) / BR, B * H);
    mhsa_fwd_kernel<true><<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<float*>(out),
        static_cast<float*>(lse), T, H, scale_log2, d);
    return (int)cudaGetLastError();
}

// Backward (K3): delta, then dq, then dk and dv.
extern "C" int adyolo_mhsa_bwd(const void* q, const void* k, const void* v,
                               const void* kv_len, const void* seed, const void* out,
                               const void* dout, const void* lse, void* delta,
                               void* dq, void* dk, void* dv, int B, int T, int H,
                               int dh, int thresh, int bq, int tp, void* stream) {
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (thresh < 0 || thresh > 255 || bq < 1 || T % bq != 0 || tp < T) {
        return (int)cudaErrorInvalidValue;
    }
    if (int rc = set_smem(mhsa_bwd_dq_kernel, DQ_SMEM)) return rc;
    if (int rc = set_smem(mhsa_bwd_dkdv_kernel, DKDV_SMEM)) return rc;
    Drop d = make_drop(thresh, bq, tp);
    d.nq = T / bq;
    const float scale = 1.0f / sqrtf((float)DH);
    cudaStream_t st = (cudaStream_t)stream;
    const long long rows = (long long)B * T * H;
    mhsa_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), THREADS, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        static_cast<float*>(delta), B, T, H);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    dim3 grid((T + BR - 1) / BR, B * H);
    mhsa_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), T, H, scale, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    mhsa_bwd_dkdv_kernel<<<grid, THREADS, DKDV_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale, d);
    return (int)cudaGetLastError();
}
