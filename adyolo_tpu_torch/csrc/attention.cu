// Multi-head attention for Hopper (sm_90a): the online-softmax forward
// (eval, and train with dropout) on fp32 FFMA, and the attention backward
// on the tensor cores in 3xTF32.
//
// Replaces three TPU kernels of adyolo_tpu/ops/flash_mhsa.py:
//   * K2 `_fwd_kernel` (:89, launched by `_flash_fwd` at :180): the
//     conformer's attention for T <= 2400 frames, at dropout rate 0 (eval,
//     `mhsa_fwd_kernel<false>`) and in training with the u8-threshold
//     dropout on the probabilities (`mhsa_fwd_kernel<true>`, which also
//     writes the row logsumexp for the backward);
//   * K3 `_bwd_kernel` (:107, launched by `_flash_bwd` at :202): the
//     backward, as `mhsa_bwd_dq_kernel` (which also writes D) +
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
// Design of the forward (the backward's is at its kernels below).  One
// 128-thread block per (32-row tile, b*h);
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8i (i < 4), takes
// columns tx + 16j (j < 4) of a 32 x 64 score tile and output dims
// 4tx..4tx+3 of the products with a 64-row operand.  It owns 32 queries
// and walks 64-key tiles up to ceil(L / 64).  The score tile goes through
// shared memory between the two products.  Row strides of the operands
// read row-wise are padded (68 floats, P tiles 80) so that the float4 and
// scalar accesses are free of bank conflicts.
//
// What bounds them on an H100: per (b, h) the forward does 4*T*L*64 FLOP
// and the backward 14*T*L*64 (S and dO.V^T in both passes, dq, dk, dv),
// reading K and V about once per pass (the tiles of one (b, h) share them
// through L2): at T = L = 800 that is hundreds of FLOP per byte, far above
// the ~20 FLOP/byte of the card's 67 TFLOP/s FFMA or ~50 of its 165
// TFLOP/s of 3xTF32 (a third of the 495 TF32 peak) at 3.35 TB/s -- so
// they are bound by operations.  The forward is f32 FFMA, inside the block
// bound by shared-memory loads (plain TF32 would spend the eval's
// 1e-3 * max-logit budget by itself); the backward runs 3xTF32 mma.sync,
// which keeps f32 accuracy.  At B = 1, T = 1200 the forward's grid is
// 38 x 4 = 152 blocks for 132 SMs; a 64-row tile would give 76, hence 32
// rows.  wgmma, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DH = 64;        // head dim
constexpr int BR = 32;        // queries a forward block owns
constexpr int BC = 64;        // keys of a forward tile
constexpr int THREADS = 128;  // 8 row groups x 16 lanes
constexpr int RPT = BR / 8;   // rows per thread (4)
constexpr int CPT = BC / 16;  // columns per thread (4)
constexpr int KS = DH + 4;    // stride of operands read row-wise
constexpr int PS = BC + 16;   // stride of score tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr size_t FWD_SMEM = (BR * DH + BC * KS + BC * DH + BR * PS) * sizeof(float);

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

// ---- K3: the backward on the tensor cores, 3xTF32 ----------------------
//
// Two launches, both 128 threads = 4 warps, each warp owning 16 rows of a
// 64-row tile; every product is a warp-level mma.sync m16n8k8 on TF32 in
// 3xTF32: x = hi + lo (split_tf32) and c += a_lo b_hi + a_hi b_lo +
// a_hi b_hi with fp32 accumulation (the dropped a_lo b_lo is ~2^-22 of the
// product).  The three mma of a column tile go in separate sweeps over the
// tiles, so consecutive mma are independent, and each key or query tile's
// dq/dk/dv product is summed in fresh accumulators before it joins the
// running sum in fp32: the tensor cores' accumulation truncates, and a sum
// over every tile would collect that error.
//   * dq pass, query-tile parallel: writes D = rowsum(dO o O) of its 64
//     queries to `delta` in its prologue, then walks the 64-key tiles up to
//     ceil(L / 64): S = Q K^T, dPd = dO V^T, dS in registers, dq += dS K.
//   * dk/dv pass, key-tile parallel, after it: walks all 64-query tiles:
//     S^T = K Q^T and dPd^T = V dO^T (keys as rows, so the transposed
//     scores come straight out of the accumulators), then dv += Pd^T dO and
//     dk += dS^T Q.
// The block's own tiles (Q/dO, resp. K/V) arrive by cp.async and are split
// into TF32 as fragments are read.  The streamed tiles (K/V, resp. Q/dO
// with their lse, D and hash row bases) are read into registers, split
// once for the block and stored as hi and lo tiles, so the four warps do
// not each split every element again: the TF32 split, not the mma, bounds
// these kernels' instruction issue, so this beats a cp.async double buffer
// of the raw tiles that every warp splits for itself.  Rows past T
// (queries) or L (keys) are zeros.  A score's exp2, keep bit and dS are
// evaluated at the accumulator element's own (query, key) coordinates, so
// the dropout mask is the same hash as the forward's.  The score
// accumulators feed the next product as its A operand without leaving
// registers: the k index of an m16n8k8 step is permuted so that A slot t
// is column 2t and slot t + 4 column 2t + 1 (the accumulator layout), and
// the B operand is read from shared memory in the same order.  Rows are
// padded to 68 words, which keeps every fragment load free of bank
// conflicts.  No atomics: each output element has one writer, and sums
// run in a fixed order.

constexpr int BT = 64;            // rows of a backward tile
constexpr int BWD_THREADS = 128;  // 4 warps x 16 rows
constexpr int TS = DH + 4;        // row stride of a tile in shared memory
constexpr int TILE = BT * TS;     // floats of one tile
constexpr int DQ_NG = 8;          // column tiles a product sweeps at once (dq pass)
constexpr int DKDV_NG = 4;        // the same in the dk/dv pass (more live sums)

constexpr size_t DQ_SMEM = 6 * TILE * sizeof(float);
constexpr size_t DKDV_SMEM = 6 * TILE * sizeof(float) + 3 * BT * sizeof(float);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros when !valid (src must still be mapped)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + BT) of one head into a tile (stride TS), rows >= n zeros.
__device__ __forceinline__ void tile_async(float* dst, const float* src, long long base,
                                           long long frame, int r0, int n, int tid) {
#pragma unroll
    for (int p = 0; p < BT * DH / 4 / BWD_THREADS; ++p) {
        const int idx = tid + p * BWD_THREADS;
        const int r = idx >> 4, c = (idx & 15) * 4;
        const bool ok = r0 + r < n;
        cp_async16(dst + r * TS + c, src + base + (ok ? (long long)(r0 + r) * frame : 0LL) + c,
                   ok);
    }
}

// x = hi + lo in TF32: hi = x rounded to 10 mantissa bits, to nearest with
// ties away from zero (cvt.rna.tf32.f32), lo = x - hi (exact) rounded the
// same way.  Done on the bits, which gives cvt.rna.tf32.f32's result for
// every finite x: ptxas expands that instruction into compare-and-select
// sequences, and the split is what these kernels issue most.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, const unsigned* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[u] += a . b[u] for NG column tiles in 3xTF32: three sweeps of NG
// independent mma (the lo terms first), so that no mma waits on the one
// before it.
template <int NG>
__device__ __forceinline__ void mma3_group(float acc[][4], const unsigned* ahi,
                                           const unsigned* alo, unsigned bhi[][2],
                                           unsigned blo[][2]) {
#pragma unroll
    for (int u = 0; u < NG; ++u) mma_tf32(acc[u], alo, bhi[u]);
#pragma unroll
    for (int u = 0; u < NG; ++u) mma_tf32(acc[u], ahi, blo[u]);
#pragma unroll
    for (int u = 0; u < NG; ++u) mma_tf32(acc[u], ahi, bhi[u]);
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// Store this warp's 16 x DH accumulator as rows r0 + g (+ 8) of one head,
// rows >= T skipped.
__device__ __forceinline__ void store_rows(float* dst, const float acc[8][4], long long base,
                                           long long frame, int r0, int T, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        if (r >= T) continue;
        float* row = dst + base + (long long)r * frame + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(row + nt * 8) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// Zeros for rows [r0, r0 + BT) of one head (rows >= T skipped).
__device__ __forceinline__ void zero_rows(float* dst, long long base, long long frame, int r0,
                                          int T, int tid) {
#pragma unroll
    for (int p = 0; p < BT * DH / 4 / BWD_THREADS; ++p) {
        const int idx = tid + p * BWD_THREADS;
        const int r = r0 + (idx >> 4);
        if (r < T) st4(dst + base + (long long)r * frame + (idx & 15) * 4,
                       make_float4(0.f, 0.f, 0.f, 0.f));
    }
}

// Rows [r0, r0 + BT) of two heads' tiles (a from src_a, b from src_b) into
// TF32 hi and lo tiles (stride TS), rows >= n zeros: every load is issued
// before any store.
__device__ __forceinline__ void tiles_split(unsigned* ah, unsigned* al, const float* src_a,
                                            unsigned* bh, unsigned* bl, const float* src_b,
                                            long long base, long long frame, int r0, int n,
                                            int tid) {
    constexpr int P = BT * DH / 4 / BWD_THREADS;  // 8 float4 of each tile
    float4 va[P], vb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int idx = tid + p * BWD_THREADS;
        const int r = idx >> 4, c = (idx & 15) * 4;
        va[p] = vb[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < n) {
            const long long off = base + (long long)(r0 + r) * frame + c;
            va[p] = __ldg(reinterpret_cast<const float4*>(src_a + off));
            vb[p] = __ldg(reinterpret_cast<const float4*>(src_b + off));
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int idx = tid + p * BWD_THREADS;
        const int o = (idx >> 4) * TS + (idx & 15) * 4;
        uint4 h, l;
        split_tf32(va[p].x, h.x, l.x);
        split_tf32(va[p].y, h.y, l.y);
        split_tf32(va[p].z, h.z, l.z);
        split_tf32(va[p].w, h.w, l.w);
        *reinterpret_cast<uint4*>(ah + o) = h;
        *reinterpret_cast<uint4*>(al + o) = l;
        split_tf32(vb[p].x, h.x, l.x);
        split_tf32(vb[p].y, h.y, l.y);
        split_tf32(vb[p].z, h.z, l.z);
        split_tf32(vb[p].w, h.w, l.w);
        *reinterpret_cast<uint4*>(bh + o) = h;
        *reinterpret_cast<uint4*>(bl + o) = l;
    }
}

// acc (16 x 64, 8 column tiles of m16n8 accumulators) += A . B^T over the
// DH dims: A = 16 rows at `a` (this warp's), B = 64 rows split into TF32
// hi and lo tiles (bh, bl), all with row stride TS.  Element i of acc[nt]
// is (row g + 8 (i >> 1), column 8 nt + 2 t + (i & 1)), g = lane / 4,
// t = lane % 4.
template <int NG>
__device__ __forceinline__ void gemm_abt(float acc[8][4], const float* a, const unsigned* bh,
                                         const unsigned* bl, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
        unsigned ahi[4], alo[4];
        split_tf32(a[g * TS + kk + t], ahi[0], alo[0]);
        split_tf32(a[(g + 8) * TS + kk + t], ahi[1], alo[1]);
        split_tf32(a[g * TS + kk + t + 4], ahi[2], alo[2]);
        split_tf32(a[(g + 8) * TS + kk + t + 4], ahi[3], alo[3]);
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += NG) {
            unsigned bhi[NG][2], blo[NG][2];
#pragma unroll
            for (int u = 0; u < NG; ++u) {
                const int o = ((n0 + u) * 8 + g) * TS + kk + t;
                bhi[u][0] = bh[o];
                bhi[u][1] = bh[o + 4];
                blo[u][0] = bl[o];
                blo[u][1] = bl[o + 4];
            }
            mma3_group<NG>(acc + n0, ahi, alo, bhi, blo);
        }
    }
}

// acc (16 x DH) += P . X: P (16 x 64) in registers in the accumulator
// layout of gemm_abt, X = 64 rows of DH split into TF32 hi and lo tiles
// (xh, xl; stride TS).  k slot t of step kt is column 8 kt + 2 t, slot
// t + 4 column 8 kt + 2 t + 1, so A comes from P's registers as they are
// and B rows are read in that order.  The tile's product is summed in
// fresh accumulators and then added to acc.
template <int NG>
__device__ __forceinline__ void gemm_px(float acc[8][4], const float p[8][4],
                                        const unsigned* xh, const unsigned* xl, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float part[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[nt][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
        unsigned ahi[4], alo[4];
        split_tf32(p[kt][0], ahi[0], alo[0]);
        split_tf32(p[kt][2], ahi[1], alo[1]);
        split_tf32(p[kt][1], ahi[2], alo[2]);
        split_tf32(p[kt][3], ahi[3], alo[3]);
        const int o0 = (kt * 8 + 2 * t) * TS + g;
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += NG) {
            unsigned bhi[NG][2], blo[NG][2];
#pragma unroll
            for (int u = 0; u < NG; ++u) {
                const int o = o0 + (n0 + u) * 8;
                bhi[u][0] = xh[o];
                bhi[u][1] = xh[o + TS];
                blo[u][0] = xl[o];
                blo[u][1] = xl[o + TS];
            }
            mma3_group<NG>(part + n0, ahi, alo, bhi, blo);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
}

// dq for 64 queries (and D of those rows into `delta`), walking the 64-key
// tiles up to ceil(L / 64).
__global__ void __launch_bounds__(BWD_THREADS, 2)
mhsa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ kv_len,
                   const int* __restrict__ seed, const float* __restrict__ out,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ delta, float* __restrict__ dq, int T, int H,
                   float scale, Drop d) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                                     // [BT][TS]
    float* Os = Qs + TILE;                                // [BT][TS]  dO
    unsigned* Kh = reinterpret_cast<unsigned*>(Os + TILE);  // [BT][TS] K, TF32 hi
    unsigned* Kl = Kh + TILE;                             // K, TF32 lo
    unsigned* Vh = Kl + TILE;
    unsigned* Vl = Vh + TILE;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int q0 = blockIdx.x * BT;
    const long long frame = (long long)H * DH;
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (L == 0) {  // no valid key: zeros (block-uniform, before any barrier)
        zero_rows(dq, base, frame, q0, T, tid);
        return;
    }
    tile_async(Qs, q, base, frame, q0, T, tid);
    tile_async(Os, dout, base, frame, q0, T, tid);
    cp_async_commit();

    // D = rowsum(dO o O): threads 2r, 2r + 1 take the halves of row r, in
    // the warp that owns the row
    float dsum = 0.f;
    {
        const int r = q0 + (tid >> 1);
        if (r < T) {
            const long long off = base + (long long)r * frame + (tid & 1) * (DH / 2);
#pragma unroll
            for (int c = 0; c < DH / 2; c += 4)
                dsum = dot4(__ldg(reinterpret_cast<const float4*>(out + off + c)),
                            __ldg(reinterpret_cast<const float4*>(dout + off + c)), dsum);
        }
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        if (r < T && (tid & 1) == 0) delta[(long long)bh * T + r] = dsum;
    }
    // this thread's rows: warp * 16 + g (i < 2) and + 8 (i >= 2)
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    const float dlt[2] = {__shfl_sync(0xffffffffu, dsum, 2 * g),
                          __shfl_sync(0xffffffffu, dsum, 2 * g + 16)};
    const bool drop = d.t24 != 0u;
    const float scale_log2 = scale * LOG2E;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;
    float lse2[2];
    unsigned rbase[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        lse2[u] = row[u] < T ? lse[(long long)bh * T + row[u]] * LOG2E : 0.f;
        rbase[u] = drop ? row_base(d, seed_term, bh, row[u]) : 0u;
    }

    float acc[8][4];
    zero_acc(acc);
    const int n_tiles = (L + BT - 1) / BT;
    for (int it = 0; it < n_tiles; ++it) {
        if (it > 0) __syncthreads();  // the last tile's reads are done
        tiles_split(Kh, Kl, k, Vh, Vl, v, base, frame, it * BT, L, tid);
        cp_async_wait<0>();
        __syncthreads();
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        gemm_abt<DQ_NG>(s, Qs + warp * 16 * TS, Kh, Kl, lane);
        gemm_abt<DQ_NG>(dp, Os + warp * 16 * TS, Vh, Vl, lane);
        const int j0 = it * BT;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int u = i >> 1;
                const int key = j0 + nt * 8 + 2 * t + (i & 1);
                float ds = 0.f;
                if (key < L && row[u] < T) {
                    const float p = exp2f(s[nt][i] * scale_log2 - lse2[u]);
                    float dpv = dp[nt][i];
                    if (drop) dpv = keep_bit(d, rbase[u], key) ? dpv * d.kscale : 0.f;
                    ds = p * (dpv - dlt[u]) * scale;
                }
                s[nt][i] = ds;
            }
        }
        gemm_px<DQ_NG>(acc, s, Kh, Kl, lane);  // dq += dS . K
    }
    store_rows(dq, acc, base, frame, q0 + warp * 16, T, lane);
}

// dk, dv for 64 keys, walking every 64-query tile; one writer per element.
__global__ void __launch_bounds__(BWD_THREADS, 2)
mhsa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kv_len,
                     const int* __restrict__ seed, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int T, int H,
                     float scale, Drop d) {
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                                     // [BT][TS]  this block's keys
    float* Vs = Ks + TILE;                                // [BT][TS]
    unsigned* Qh = reinterpret_cast<unsigned*>(Vs + TILE);  // a query tile, TF32 hi
    unsigned* Ql = Qh + TILE;
    unsigned* Oh = Ql + TILE;                             // its dO
    unsigned* Ol = Oh + TILE;
    float* Ls = reinterpret_cast<float*>(Ol + TILE);      // [BT] its lse * log2 e
    float* Dl = Ls + BT;                                  // [BT] its D
    unsigned* Rb = reinterpret_cast<unsigned*>(Dl + BT);  // [BT] its hash row bases

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int k0 = blockIdx.x * BT;
    const long long frame = (long long)H * DH;
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);

    if (k0 >= L) {  // keys no query sees: zero gradients (block-uniform)
        zero_rows(dk, base, frame, k0, T, tid);
        zero_rows(dv, base, frame, k0, T, tid);
        return;
    }
    const bool drop = d.t24 != 0u;
    const float scale_log2 = scale * LOG2E;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;
    const long long stats = (long long)bh * T;

    tile_async(Ks, k, base, frame, k0, L, tid);
    tile_async(Vs, v, base, frame, k0, L, tid);
    cp_async_commit();

    // this thread's keys: warp * 16 + g (i < 2) and + 8 (i >= 2)
    const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    float gk[8][4], gv[8][4];
    zero_acc(gk);
    zero_acc(gv);
    const int n_tiles = (T + BT - 1) / BT;
    for (int it = 0; it < n_tiles; ++it) {
        const int c0 = it * BT;
        if (it > 0) __syncthreads();  // the last tile's reads are done
        tiles_split(Qh, Ql, q, Oh, Ol, dout, base, frame, c0, T, tid);
        if (tid < BT) {
            const int tq = c0 + tid;
            const bool ok = tq < T;
            Ls[tid] = ok ? lse[stats + tq] * LOG2E : 0.f;
            Dl[tid] = ok ? delta[stats + tq] : 0.f;
            Rb[tid] = drop && ok ? row_base(d, seed_term, bh, tq) : 0u;
        }
        cp_async_wait<0>();
        __syncthreads();
        float s[8][4], dp[8][4];
        zero_acc(s);
        zero_acc(dp);
        gemm_abt<DKDV_NG>(s, Ks + warp * 16 * TS, Qh, Ql, lane);
        gemm_abt<DKDV_NG>(dp, Vs + warp * 16 * TS, Oh, Ol, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int u = i >> 1;
                const int col = nt * 8 + 2 * t + (i & 1);
                float pd = 0.f, ds = 0.f;
                if (key[u] < L && c0 + col < T) {
                    const float p = exp2f(s[nt][i] * scale_log2 - Ls[col]);
                    float dpv = dp[nt][i];
                    pd = p;
                    if (drop) {
                        const bool kp = keep_bit(d, Rb[col], key[u]);
                        pd = kp ? p * d.kscale : 0.f;
                        dpv = kp ? dpv * d.kscale : 0.f;
                    }
                    ds = p * (dpv - Dl[col]) * scale;
                }
                s[nt][i] = pd;
                dp[nt][i] = ds;
            }
        }
        gemm_px<DKDV_NG>(gv, s, Oh, Ol, lane);   // dv += Pd^T . dO
        gemm_px<DKDV_NG>(gk, dp, Qh, Ql, lane);  // dk += dS^T . Q
    }
    store_rows(dk, gk, base, frame, k0 + warp * 16, T, lane);
    store_rows(dv, gv, base, frame, k0 + warp * 16, T, lane);
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

// Dynamic shared memory a kernel launches with: 0 the forward, 1 the dq
// pass, 2 the dk/dv pass.
extern "C" long long adyolo_mhsa_smem_bytes(int which) {
    return (long long)(which == 0 ? FWD_SMEM : which == 1 ? DQ_SMEM : DKDV_SMEM);
}

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

// Backward (K3): dq (and D into `delta`), then dk and dv.
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
    dim3 grid((T + BT - 1) / BT, B * H);
    mhsa_bwd_dq_kernel<<<grid, BWD_THREADS, DQ_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq), T, H, scale, d);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    mhsa_bwd_dkdv_kernel<<<grid, BWD_THREADS, DKDV_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale, d);
    return (int)cudaGetLastError();
}
