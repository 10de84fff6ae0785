// Multi-head attention for Hopper (sm_90a) on the tensor cores in 3xTF32:
// the online-softmax forward (eval, and train with dropout) and the
// attention backward; and, for bf16 training, the train forward and the
// backward on bfloat16 operands with wgmma, TMA and a producer warp
// (`mhsa_fwd_bf16_kernel`, `mhsa_bwd_dq_bf16_kernel` +
// `mhsa_bwd_dkdv_bf16_kernel`, routes k2_dropout_bf16 and k3_bf16; their
// own section below), and the bf16 eval forward on the same kernel with no
// dropout (`mhsa_fwd_bf16_kernel<false>`, route k2_bf16: bf16 serving).
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
// JAX).  A batch row with L == 0 gets zeros, and lse = -inf (K4's
// convention).
//
// The dropout bits are the splitmix32 position hash of the JAX kernels'
// interpret mode (flash_mhsa.py:64-71), indexed by the JAX blocking so that
// the masks agree bit for bit with it and with the plain version
// (ops/attention.py::dropout_bits): for query t and key j,
//   x = (t % bq) * Tp + j + seed * 0x9E3779B9 + ((b*Ht + h0 + h) * nq + t / bq)
//       * 0x85EBCA6B  (uint32), keep = mix(x) >= thresh << 24,
// bq the JAX query block, nq = T / bq, Tp = ceil(T / 128) * 128.  A launch
// over a head shard (tensor parallelism: heads [h0, h0 + H) of a model with
// Ht heads) hashes the model's global head, so its mask is the full model's
// mask of those heads; h0 = 0, Ht = H is the unsharded call.
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
// What bounds them on an H100: per (b, h) the forward does 4*T*L*64 FLOP
// and the backward 14*T*L*64 (S and dO.V^T in both passes, dq, dk, dv),
// reading K and V about once per pass (the tiles of one (b, h) share them
// through L2): at T = L = 800 that is hundreds of FLOP per byte, far above
// the ~50 FLOP/byte of the card's 165 TFLOP/s of 3xTF32 (a third of the
// 495 TF32 peak) at 3.35 TB/s, so they are bound by operations.  Plain
// TF32 would spend the eval's 1e-3 * max-logit budget by itself; 3xTF32
// keeps f32 accuracy at three tensor-core products per product, still 2.5x
// the 67 TFLOP/s of f32 FFMA.  Inside the block, every mma.sync m16n8k8
// reads its B fragment (hi and lo, 512 B for the three mma) from shared
// memory, whose 128 B a clock per SM is then about as scarce as the tensor
// cores themselves: the designs below keep that traffic to one fragment
// load per mma group and keep the A operands in registers.
//
// Every product is a warp-level mma.sync m16n8k8 on TF32 in 3xTF32:
// x = hi + lo (split_tf32) and c += a_lo b_hi + a_hi b_lo + a_hi b_hi with
// fp32 accumulation (the dropped a_lo b_lo is ~2^-22 of the product).  The
// three mma of a column tile go in separate sweeps over the tiles, so
// consecutive mma are independent, and each key or query tile's
// P.V / dq / dk / dv product is summed in fresh accumulators before it
// joins the running sum in fp32: the tensor cores' accumulation truncates,
// and a sum over every tile would collect that error.  A score
// accumulator feeds the next product as its A operand without leaving
// registers: the k index of an m16n8k8 step is permuted so that A slot t
// is column 2t and slot t + 4 column 2t + 1 (the accumulator layout), and
// the B operand is read from shared memory in the same order.  Tiles in
// shared memory have rows padded to 68 words, which keeps every fragment
// load free of bank conflicts.
//
// The forward (`mhsa_fwd_kernel`, routes k2, k2_dropout and k4): one
// 128-thread block (4 warps x 16 query rows) per (64-query tile, b*h, key
// split).
//   * Q is split once: the block's Q tile arrives by cp.async and each warp
//     keeps its 16 rows as TF32 hi and lo A fragments in registers (64 of
//     them) for the whole key loop.
//   * K and V stream in 64-key tiles.  The raw tiles of the next step are in
//     flight by cp.async while the current step multiplies, and each tile
//     that has arrived is split once for the block into hi/lo shared-memory
//     tiles that all four warps read: the split, not the mma, bounds the
//     issue when every warp splits for itself (the backward's lesson).
//   * S = Q K^T lands in accumulators that are P.V's A operand as they
//     stand, so the probabilities never leave registers.  The online
//     softmax runs on those fragments: the row max and sum are reduced over
//     the quad of lanes that share a row, p = exp2(s * scale * log2 e - m)
//     is one FFMA and one exp2 (flushing below 2^-126), keys past L are
//     masked on the edge tile only, and each element's keep bit is hashed
//     at its own (query, key).  Each tile's P.V is summed in fresh
//     accumulators and folded in as O = O * alpha + tile, in fp32.  Two
//     barriers a tile.  What is left bounds it: the B fragments, which
//     every warp reads from shared memory (256 KB a 64-key tile a block),
//     and the per-tile split (96 KB more), at 128 B a clock per SM.
//   * Fill.  104,448 B of shared memory (hi/lo K and V, the raw K and V in
//     flight) and <= 255 registers a thread fit 2 blocks = 8 warps an SM.
//     64-row tiles give 832 blocks at (B, T) = (16, 800) (3.15 waves of
//     264), but only 76 at (1, 1200) and 300 at (1, 4800).  So where a
//     model of key tiles per wave says it pays (`pick_splits`), the key tiles
//     are dealt round-robin to up to 4 blocks per query tile; each writes
//     its partial (m, l, O) to scratch, and a second launch
//     (`mhsa_fwd_merge_kernel`) merges them and writes out (and lse).
//     (16, 800) runs unsplit, 832 blocks; (1, 1200) in 3 splits, 228 blocks;
//     (1, 2400) in 3, 456; (1, 4800) in 4, 1200.
// wgmma, TMA and warp specialisation for these float32 kernels are later
// work (the bf16 section below has them).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "errors.cuh"

using adyolo::check_launch;
using adyolo::enter;
using adyolo::fail;
using adyolo::fail_driver;

namespace {

constexpr int DH = 64;            // head dim
constexpr int BT = 64;            // rows of a tile (queries or keys)
constexpr int THREADS = 128;      // 4 warps x 16 rows
constexpr int TS = DH + 4;        // row stride of a tile in shared memory
constexpr int TILE = BT * TS;     // floats of one tile
constexpr int FWD_NG = 4;         // column tiles a forward product sweeps at once
constexpr int DQ_NG = 8;          // the same in the dq pass
constexpr int DKDV_NG = 4;        // the same in the dk/dv pass (more live sums)
constexpr int MAX_SPLITS = 4;     // key splits of a forward query tile
constexpr int MERGE_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr size_t FWD_SMEM = 6 * TILE * sizeof(float);
constexpr size_t DQ_SMEM = 6 * TILE * sizeof(float);
constexpr size_t DKDV_SMEM = 6 * TILE * sizeof(float) + 3 * BT * sizeof(float);

// The dropout of one call: keep a probability when its bits are >= t24.
struct Drop {
    unsigned t24;    // thresh << 24 (0: no dropout)
    float kscale;    // 256 / (256 - thresh)
    int bq, nq;      // the JAX query block and count
    unsigned tp;     // keys padded to 128
    int hl, h0, ht;  // heads of the launch, its first head's index in the model, the model's heads
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

// The hash's per-query part: everything of x but the key index.
__device__ __forceinline__ unsigned row_base(const Drop& d, unsigned seed_term,
                                             int bh, int t) {
    const int gbh = bh + (bh / d.hl) * (d.ht - d.hl) + d.h0;  // b*ht + h0 + h
    const unsigned lane = (unsigned)(gbh * d.nq + t / d.bq);
    return (unsigned)(t % d.bq) * d.tp + seed_term + lane * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool keep_bit(const Drop& d, unsigned base, int key) {
    unsigned x = base + (unsigned)key;
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return (x ^ (x >> 16)) >= d.t24;
}

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
    for (int p = 0; p < BT * DH / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
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

// Two floats as a bfloat16 pair, rounded to nearest even: lo in the low
// half (the lower k or column index of an mma fragment), hi in the high.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
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
    for (int p = 0; p < BT * DH / 4 / THREADS; ++p) {
        const int idx = tid + p * THREADS;
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
    constexpr int P = BT * DH / 4 / THREADS;  // 8 float4 of each tile
    float4 va[P], vb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int idx = tid + p * THREADS;
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
        const int idx = tid + p * THREADS;
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

// A raw tile in shared memory (stride TS) into TF32 hi and lo tiles: every
// load is issued before any store.
__device__ __forceinline__ void split_tile(unsigned* hi, unsigned* lo, const float* raw,
                                           int tid) {
    constexpr int P = BT * DH / 4 / THREADS;  // 8 float4 a thread
    float4 x[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int idx = tid + p * THREADS;
        x[p] = ld4(raw + (idx >> 4) * TS + (idx & 15) * 4);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int idx = tid + p * THREADS;
        const int o = (idx >> 4) * TS + (idx & 15) * 4;
        uint4 h, l;
        split_tf32(x[p].x, h.x, l.x);
        split_tf32(x[p].y, h.y, l.y);
        split_tf32(x[p].z, h.z, l.z);
        split_tf32(x[p].w, h.w, l.w);
        *reinterpret_cast<uint4*>(hi + o) = h;
        *reinterpret_cast<uint4*>(lo + o) = l;
    }
}

// acc (16 x 64) += A . B^T over the DH dims, A given as its TF32 hi and lo
// fragments (ah, al: k step kk's a0..a3), B = 64 rows split into TF32 hi
// and lo tiles (bh, bl; stride TS).  The layout of acc is gemm_abt's.
template <int NG>
__device__ __forceinline__ void gemm_frag_bt(float acc[8][4], const unsigned ah[8][4],
                                             const unsigned al[8][4], const unsigned* bh,
                                             const unsigned* bl, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += NG) {
            unsigned bhi[NG][2], blo[NG][2];
#pragma unroll
            for (int u = 0; u < NG; ++u) {
                const int o = ((n0 + u) * 8 + g) * TS + kk * 8 + t;
                bhi[u][0] = bh[o];
                bhi[u][1] = bh[o + 4];
                blo[u][0] = bl[o];
                blo[u][1] = bl[o + 4];
            }
            mma3_group<NG>(acc + n0, ah[kk], al[kk], bhi, blo);
        }
    }
}

// exp2 flushing subnormal inputs and results to 0 (no range fix-up around
// MUFU.EX2): a probability or rescale factor below 2^-126 of the row max
// is 0 to fp32 accuracy anyway.
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The forward of one (64-query tile, b*h, key split).  Key tiles `split`,
// `split + splits`, ... below ceil(L / 64).  splits == 1: writes out (and,
// TRAIN, the row logsumexp to lse (B, H, T) in natural log units).
// splits > 1: writes its partial output (unnormalised, layout (B, T, H, DH)
// at part + split * B*T*H*DH) and row max (log2 units) and sum (pm, pl:
// (splits, B, H, T)) for mhsa_fwd_merge_kernel; a split with no key tile
// writes nothing (the merge skips it).  TRAIN: dropout when d.t24 > 0.
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 2)
mhsa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ kv_len,
                const int* __restrict__ seed, float* __restrict__ out,
                float* __restrict__ lse, float* __restrict__ part,
                float* __restrict__ pm, float* __restrict__ pl, int T, int H,
                int splits, float scale_log2, Drop d) {
    extern __shared__ __align__(16) float smem[];
    unsigned* Kh = reinterpret_cast<unsigned*>(smem);  // [BT][TS] K, TF32 hi
    unsigned* Kl = Kh + TILE;                           // K, TF32 lo
    unsigned* Vh = Kl + TILE;
    unsigned* Vl = Vh + TILE;
    float* Kr = reinterpret_cast<float*>(Vl + TILE);    // the raw K tile in flight
    float* Vr = Kr + TILE;
    float* Qs = smem;                                   // the raw Q tile, at first

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh - b * H;
    const int q0 = blockIdx.x * BT;
    const int split = blockIdx.z;
    const long long frame = (long long)H * DH;  // floats per t
    const long long base = (long long)b * T * frame + (long long)h * DH;
    const int L = min(max(kv_len[b], 0), T);
    const int n_tiles = (L + BT - 1) / BT;

    if (L == 0 && splits == 1) {  // no valid key: zeros (block-uniform, before any barrier)
        zero_rows(out, base, frame, q0, T, tid);
        if (TRAIN && tid < BT && q0 + tid < T) lse[(long long)bh * T + q0 + tid] = -INFINITY;
        return;
    }
    if (split >= n_tiles) return;  // no key tile for this split (block-uniform)

    tile_async(Qs, q, base, frame, q0, T, tid);
    cp_async_commit();
    tile_async(Kr, k, base, frame, split * BT, L, tid);  // keys >= L are zeros
    tile_async(Vr, v, base, frame, split * BT, L, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // this warp's 16 query rows as TF32 A fragments, for the whole key loop
    unsigned qh[8][4], ql[8][4];
    {
        const float* a = Qs + warp * 16 * TS;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            split_tf32(a[g * TS + kk * 8 + t], qh[kk][0], ql[kk][0]);
            split_tf32(a[(g + 8) * TS + kk * 8 + t], qh[kk][1], ql[kk][1]);
            split_tf32(a[g * TS + kk * 8 + t + 4], qh[kk][2], ql[kk][2]);
            split_tf32(a[(g + 8) * TS + kk * 8 + t + 4], qh[kk][3], ql[kk][3]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // Q read by every warp before Kh is overwritten; K/V arrived

    // this thread's rows: warp * 16 + g (accumulator elements 0, 1) and + 8 (2, 3)
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    const bool drop = TRAIN && d.t24 != 0u;
    unsigned rbase[2] = {0u, 0u};
    if (drop) {
        const unsigned seed_term = (unsigned)seed[0] * 0x9E3779B9u;
#pragma unroll
        for (int u = 0; u < 2; ++u) rbase[u] = row_base(d, seed_term, bh, row[u]);
    }
    float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
    float l[2] = {0.f, 0.f};              // this lane's part of the row sum
    float o[8][4];
    zero_acc(o);

    for (int it = split; it < n_tiles; it += splits) {
        split_tile(Kh, Kl, Kr, tid);
        split_tile(Vh, Vl, Vr, tid);
        __syncthreads();  // hi/lo tiles ready; the raw buffers are free
        const int nxt = it + splits;
        if (nxt < n_tiles) {  // the next step's raw tiles fly while this one multiplies
            tile_async(Kr, k, base, frame, nxt * BT, L, tid);
            tile_async(Vr, v, base, frame, nxt * BT, L, tid);
            cp_async_commit();
        }
        float s[8][4];
        zero_acc(s);
        gemm_frag_bt<FWD_NG>(s, qh, ql, Kh, Kl, lane);  // S = Q . K^T

        // online softmax in the log2 domain; keys >= L are -inf -> p = 0.
        // The tile holds key it * 64 < L, so every row max is finite.
        const int j0 = it * BT;
        float mx[2] = {-INFINITY, -INFINITY};
        if (j0 + BT > L) {  // the edge tile (block-uniform)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (j0 + nt * 8 + 2 * t + (i & 1) >= L) s[nt][i] = -INFINITY;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
        float mnew[2], alpha[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // over the quad that shares the row
            mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
            mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
            mnew[u] = fmaxf(m[u], mx[u] * scale_log2);
            alpha[u] = exp2_ftz(m[u] - mnew[u]);  // 0 on the first tile
            m[u] = mnew[u];
            l[u] *= alpha[u];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int u = i >> 1;
                float p = exp2_ftz(fmaf(s[nt][i], scale_log2, -mnew[u]));
                l[u] += p;  // the normaliser sums the undropped probabilities
                if (drop && !keep_bit(d, rbase[u], j0 + nt * 8 + 2 * t + (i & 1))) p = 0.f;
                s[nt][i] = p;
                o[nt][i] *= alpha[u];
            }
        }
        gemm_px<FWD_NG>(o, s, Vh, Vl, lane);  // O = O * alpha + P . V
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with the hi/lo tiles; the next raw tiles arrived
    }

#pragma unroll
    for (int u = 0; u < 2; ++u) {
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    }
    if (splits == 1) {
        const float inv[2] = {(drop ? d.kscale : 1.f) / l[0], (drop ? d.kscale : 1.f) / l[1]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[nt][i] *= inv[i >> 1];
        store_rows(out, o, base, frame, q0 + warp * 16, T, lane);
        if (TRAIN && t == 0) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
                if (row[u] < T) lse[(long long)bh * T + row[u]] = (m[u] + log2f(l[u])) * LN2;
        }
        return;
    }
    const long long n_out = (long long)gridDim.y / H * T * frame;  // B*T*H*DH
    store_rows(part + split * n_out, o, base, frame, q0 + warp * 16, T, lane);
    if (t == 0) {
        const long long st = ((long long)split * gridDim.y + bh) * T;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            if (row[u] < T) {
                pm[st + row[u]] = m[u];
                pl[st + row[u]] = l[u];
            }
        }
    }
}

// Merge the partial (m, l, O) of the key splits: one thread per 4 dims of
// one (b, t, h) row.  The splits below min(splits, ceil(L / 64)) hold key
// tiles; L == 0 gives zeros and lse = -inf.  lse may be null (eval);
// out16, when not null, gets the output rounded to bfloat16 beside out,
// which may then be null (the bf16 eval forward).
__global__ void __launch_bounds__(MERGE_THREADS)
mhsa_fwd_merge_kernel(const float* __restrict__ part, const float* __restrict__ pm,
                      const float* __restrict__ pl, const int* __restrict__ kv_len,
                      float* __restrict__ out, __nv_bfloat16* __restrict__ out16,
                      float* __restrict__ lse, int B, int T, int H, int splits,
                      float kscale) {
    const long long idx = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
    const long long rows = (long long)B * T * H;
    if (idx >= rows * (DH / 4)) return;
    const long long r = idx / (DH / 4);  // (b * T + t) * H + h
    const int c = (int)(idx % (DH / 4)) * 4;
    const int h = (int)(r % H);
    const int t = (int)((r / H) % T);
    const int b = (int)(r / ((long long)H * T));
    const int L = min(max(kv_len[b], 0), T);
    const int n = min(splits, (L + BT - 1) / BT);
    const long long bht = ((long long)b * H + h) * T + t;  // (b, h, t) of (B, H, T)
    const long long stat = (long long)B * H * T;
    float mmax = -INFINITY;
    for (int s = 0; s < n; ++s) mmax = fmaxf(mmax, pm[s * stat + bht]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n; ++s) {
        const float w = exp2f(pm[s * stat + bht] - mmax);
        lsum = fmaf(w, pl[s * stat + bht], lsum);
        const float4 x = ld4(part + s * rows * DH + r * DH + c);
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
    }
    const float inv = n > 0 ? kscale / lsum : 0.f;
    const float4 o = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    if (out != nullptr) st4(out + r * DH + c, o);
    if (out16 != nullptr) {
        uint2 packed;
        packed.x = pack_bf16(o.x, o.y);
        packed.y = pack_bf16(o.z, o.w);
        *reinterpret_cast<uint2*>(out16 + r * DH + c) = packed;
    }
    if (lse != nullptr && c == 0) lse[bht] = n > 0 ? (mmax + log2f(lsum)) * LN2 : -INFINITY;
}

// ---- K3: the backward ----------------------------------------------------
//
// Two launches, both 128 threads = 4 warps, each warp owning 16 rows of a
// 64-row tile:
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
// not each split every element again.  Rows past T (queries) or L (keys)
// are zeros.  A score's exp2, keep bit and dS are evaluated at the
// accumulator element's own (query, key) coordinates, so the dropout mask
// is the same hash as the forward's.  No atomics: each output element has
// one writer, and sums run in a fixed order.

// dq for 64 queries (and D of those rows into `delta`), walking the 64-key
// tiles up to ceil(L / 64).
__global__ void __launch_bounds__(THREADS, 2)
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
__global__ void __launch_bounds__(THREADS, 2)
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

// ---- bf16 training: K2 with dropout and K3 on bfloat16, wgmma + TMA ----
//
// Replace the same TPU kernels as the float32 pair, on bfloat16 q/k/v: K2
// with its dropout branch (`_fwd_kernel`, adyolo_tpu/ops/flash_mhsa.py:89,
// launched at :180) as `mhsa_fwd_bf16_kernel`, and K3 (`_bwd_kernel`, :107,
// launched at :202) as `mhsa_bwd_dq_bf16_kernel` + `mhsa_bwd_dkdv_bf16_kernel`.
//
// What they compute is JAX's bf16 arithmetic (flash_mhsa.py:101-104,
// :129-146): the forward's dropped and scaled probabilities are rounded to
// bfloat16 for P.V and the output is bfloat16; the backward rounds
// ds * scale and pd to bfloat16 before its products and writes dq, dk, dv
// in bfloat16 from float32 sums.  Every product is bfloat16 x bfloat16 with
// float32 accumulation.  Differences from JAX, each at bfloat16 rounding
// level: the online form rounds the unnormalised exp(s - m) to bfloat16
// (JAX the normalised p * kscale), and the backward takes D = rowsum(dO o O)
// from the float32 output that the forward writes beside the bfloat16 one
// (D from the bfloat16 output would carry that rounding into every ds of
// the row where dp ~ D cancels).  exp2 is ex2.approx.ftz.f32 (relative
// error ~2^-22, flushing below 2^-126), far under the bfloat16 step of
// 2^-8 that every product's operands carry.
//
// What bounds them: at (B, T) = (16, 800) the forward's two products are
// 10.5 GFLOP, 0.0106 ms at the H100's 989 TFLOP/s of dense bfloat16, and
// the backward's five 26.2 GFLOP, 0.0265 ms; their bytes (26 and 52 MB)
// take 0.008 and 0.016 ms.  Beside the tensor cores each of the 41 M
// (query, key) elements costs an exp2 on the MUFU pipe (16 a clock an SM)
// and the splitmix32 keep test (8 integer operations, 64 a clock an SM) in
// every pass that touches it: one in the forward, two in the backward.  At
// 132 SMs x 1.83 GHz those floors are 0.0106 ms (exp2) and 0.021 ms (keep
// test) a pass (from those issue rates, not measured), above the
// tensor-core bound, so the tensor-core bound cannot be reached; the
// design's aim is to run them while the tensor cores work.
//
// The design, for Hopper:
//   * wgmma m64n64k16 for every product, one consumer warpgroup owning a
//     64-row tile.  Q.K^T and dO.V^T (and in the dk/dv pass K.Q^T and
//     V.dO^T, keys as rows) read both operands from shared memory, K-major.
//     P.V, dS.K, Pd^T.dO and dS^T.Q take A from registers, the bf16-packed
//     accumulator of the previous product (an m64nN accumulator's two
//     adjacent n8 column groups are one k16 A fragment), and B from shared
//     memory with the transpose bit (MN-major).  In the dk/dv pass the
//     accumulators of K.Q^T are P^T itself, and each element's keep bit is
//     hashed at its own (query, key).
//   * TMA: 64 x 64 bf16 tiles (128 B rows, 128-byte swizzle, the layout
//     wgmma reads) land by cp.async.bulk.tensor on mbarriers.  Tensor maps
//     describe q/k/v/dO in place as (64, H, T, B) with a (64, 1, 64, 1)
//     box; rows past T arrive as zeros and keys in [L, T) are masked on the
//     edge tile.  One producer warp keeps a ring of STAGES tile pairs in
//     flight (the forward and the dq pass stream K and V; the dk/dv pass Q
//     and dO, and its lanes write the tile's lse, D and hash row bases
//     beside them), plus the work item's own tiles (Q; Q and dO; K and V).
//   * No setmaxnreg.  With one producer warp (a warpgroup of one warp) the
//     consumers' setmaxnreg.inc never returned on the H100, even with 8
//     or 16 registers of slack in the pool.  A whole producer warpgroup
//     would free no room for more consumers: at 24 registers a producer
//     thread, a fourth 128-thread consumer warpgroup an SM would need
//     <= 104 registers a thread, and the consumers need ~123.  They fit
//     in what 3 (dk/dv pass: 2) blocks an SM leave them.
//   * Overlap.  Three (dk/dv pass: two) independent blocks an SM, each
//     one consumer warpgroup.  A ping-pong forward, two consumer
//     warpgroups a block sharing K and V and issuing their S products in
//     turn through two named barriers, 1 block an SM, ran 0.076 ms at
//     (16, 800) on the H100 against this design's 0.056; the same block
//     without the turns 0.075, with three warpgroups 0.078, built for 2
//     blocks an SM (<= 112 registers) 0.076.  Within a warpgroup the backward
//     passes issue the next tile's S and dP behind the current dq (dk, dv)
//     product.  ptxas (12.9) then serialises every wgmma of those kernels
//     (C7515), and still they ran faster than without the overlap
//     (0.2075 against 0.212 ms at (16, 800) on the H100), where it
//     serialises them for registers instead (C7512).  The forward runs
//     S, softmax, P.V in turn: FA3's order (S_{i+1} issued before the
//     softmax of S_i) made ptxas serialise it (C7514) and ran 0.064 ms
//     against this order's 0.056.
//   * Fill: a persistent grid of (SMs x resident blocks) walks a work list
//     of (64-row tile, b*h[, key split]), tile fastest, so neighbouring
//     blocks share a head's K and V in L2, and a block's producer loads the
//     next item's tiles while its consumers finish the last one.  Key
//     splits and the merge stay for grids under a wave (pick_splits).
// The backward stays deterministic with no atomics: dq from a pass over
// query tiles, dk/dv from a pass over key tiles.

typedef __nv_bfloat16 bf16;

constexpr int WG_THREADS = 128;                 // the consumer warpgroup
constexpr int WS_THREADS = WG_THREADS + 32;     // and one producer warp
constexpr int STAGES = 3;                       // tile pairs in flight
constexpr unsigned TILE_BYTES = BT * DH * 2;    // one 64 x 64 bf16 tile
// Blocks an SM each kernel is built for: 3 x (4 + 1) warps at <= 136
// registers a thread for the forward and the dq pass, 2 x 5 at <= 200 for
// the dk/dv pass, which keeps dk, dv, S^T, dP^T and the packed Pd^T and
// dS^T live at once.
constexpr int FWDB_MINB = 3, DQB_MINB = 3, DKDVB_MINB = 2;

// Shared memory of a kernel with `nfix` tiles of its own and, `rows`, the
// dk/dv pass's per-stage lse, D and hash bases: tiles first (1024-aligned
// for the swizzle), then the rows, then the barriers; 1024 B of slack to
// align the base.
constexpr size_t ws_smem(int nfix, bool rows) {
    return 1024 + (size_t)(nfix + 2 * STAGES) * TILE_BYTES +
           (rows ? (size_t)STAGES * 3 * BT * 4 : 0) + (2 * STAGES + 2) * 8;
}
constexpr size_t FWDB_SMEM = ws_smem(1, false);
constexpr size_t DQB_SMEM = ws_smem(2, false);
constexpr size_t DKDVB_SMEM = ws_smem(2, true);

template <int NFIX, bool ROWS>
struct WsSmem {
    unsigned char* fix;   // NFIX tiles
    unsigned char* ring;  // STAGES x 2 tiles
    float* rows;          // STAGES x [lse * log2 e | D | hash base] x BT
    unsigned long long* full;   // STAGES
    unsigned long long* empty;  // STAGES
    unsigned long long* fix_full;
    unsigned long long* fix_empty;
    __device__ WsSmem(unsigned char* raw) {
        const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(raw));
        unsigned char* p = raw + ((1024u - (a & 1023u)) & 1023u);
        fix = p;
        ring = fix + NFIX * TILE_BYTES;
        rows = reinterpret_cast<float*>(ring + 2 * STAGES * TILE_BYTES);
        full = reinterpret_cast<unsigned long long*>(
            reinterpret_cast<unsigned char*>(rows) + (ROWS ? STAGES * 3 * BT * 4 : 0));
        empty = full + STAGES;
        fix_full = empty + STAGES;
        fix_empty = fix_full + 1;
    }
    __device__ unsigned char* tile(int stage, int which) const {
        return ring + (2 * stage + which) * TILE_BYTES;
    }
};

// keep_bit without its last xorshift: x ^ (x >> 16) leaves the top 8 bits
// of x as they are, and t24 = thresh << 24 compares only those, so the two
// tests agree on every x.
__device__ __forceinline__ bool keep24(const Drop& d, unsigned base, int key) {
    unsigned x = base + (unsigned)key;
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x >= d.t24;
}

// A stage and the parity of its barrier's phase, walking a ring.
struct Ring {
    int stage;
    unsigned phase;
    __device__ void next() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
        }
    }
};

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
    const unsigned a = smem_addr(b);
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    }
}

// The 64 x 64 tile of rows [t0, t0 + 64) of head h of batch row b.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int h, int t0, int b,
                                         unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(h), "r"(t0), "r"(b),
        "r"(smem_addr(bar))
        : "memory");
}

// The wgmma descriptor of a 1024-aligned 64 x 64 bf16 tile in the 128-byte
// swizzle: 8-row groups 1024 B apart (SBO); LBO unused at 64 columns.
// A k16 step adds 32 B along a K-major row (+2) or 16 rows (+128) of an
// MN-major one.
__device__ __forceinline__ unsigned long long sw128_desc(const void* p) {
    const unsigned long long a = smem_addr(p);
    return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// a wgmma issue or wait: it does not know the hardware writes it late.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

__device__ __forceinline__ void fence_frag(unsigned (&a)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

#define WG_D32(d)                                                                             \
    "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
        "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),            \
        "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_REGS32                                                                           \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) (+)= A . B over one k16 step, A and B in shared memory,
// both K-major.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], unsigned long long da,
                                         unsigned long long db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A . B over one k16 step, A a k16 fragment in registers,
// B in shared memory MN-major (its k index runs along the tile's rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const unsigned (&a)[4],
                                         unsigned long long db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d = A . B^T over DH: both tiles in shared memory with DH along the rows.
__device__ __forceinline__ void gemm_ss(float (&d)[8][4], const void* a, const void* b) {
    const unsigned long long da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk > 0);
}

// d += P . X over 64 rows of X: P packed (k16 fragments), X in shared memory.
__device__ __forceinline__ void gemm_rs(float (&d)[8][4], const unsigned (&p)[4][4],
                                        const void* x) {
    const unsigned long long dx = sw128_desc(x);
#pragma unroll
    for (int kt = 0; kt < BT / 16; ++kt) wgmma_rs(d, p[kt], dx + 128 * kt);
}

// An accumulator's 64 columns as bf16 A fragments of four k16 steps.
__device__ __forceinline__ void pack_frags(unsigned (&a)[4][4], const float (&s)[8][4]) {
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
        a[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
        a[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
        a[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
        a[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
    }
}

// Store a warp's 16 x DH of an accumulator as bfloat16 rows r0 + g (+ 8) of
// one head (and, dst32 not null, as float32), rows >= T skipped.
__device__ __forceinline__ void store_rows_bf16(bf16* dst, float* dst32, const float acc[8][4],
                                                long long base, long long frame, int r0,
                                                int T, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        if (r >= T) continue;
        const long long off = base + (long long)r * frame + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const float x0 = acc[nt][2 * half], x1 = acc[nt][2 * half + 1];
            *reinterpret_cast<unsigned*>(dst + off + nt * 8) = pack_bf16(x0, x1);
            if (dst32 != nullptr)
                *reinterpret_cast<float2*>(dst32 + off + nt * 8) = make_float2(x0, x1);
        }
    }
}

// Zeros for rows [r0, r0 + BT) of one bfloat16 head (rows >= T skipped).
__device__ __forceinline__ void zero_rows_bf16(bf16* dst, long long base, long long frame,
                                               int r0, int T, int tid) {
#pragma unroll
    for (int p = 0; p < BT * DH / 8 / WG_THREADS; ++p) {
        const int idx = tid + p * WG_THREADS;
        const int r = r0 + (idx >> 3);
        if (r < T)
            *reinterpret_cast<uint4*>(dst + base + (long long)r * frame + (idx & 7) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
    }
}

// Barriers of a warp-specialised block: the ring's full (`full_count`
// arrivals, one with the TMA bytes) and empty (one arrival a consumer
// warp), and the work item's own tiles'.  Every thread of the block calls
// it, before the roles split.
template <int NFIX, bool ROWS>
__device__ __forceinline__ void ws_init(const WsSmem<NFIX, ROWS>& sm, unsigned full_count) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(sm.full + s, full_count);
            mbar_init(sm.empty + s, WG_THREADS / 32);
        }
        mbar_init(sm.fix_full, 1);
        mbar_init(sm.fix_empty, WG_THREADS / 32);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// One consumer warp's arrival on an empty barrier.
__device__ __forceinline__ void release(unsigned long long* b, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(b);
}

// A work item of a persistent block: (64-row tile, b*h, split), tile fastest.
struct Work {
    int tile, bh, split;
};

__device__ __forceinline__ Work work_item(int w, int n_tiles, int BH) {
    Work x;
    x.tile = w % n_tiles;
    const int r = w / n_tiles;
    x.bh = r % BH;
    x.split = r / BH;
    return x;
}

// The bf16 forward, persistent over (64-query tile, b*h, key split): out
// (bfloat16) and, TRAIN, out32 (float32) and the row logsumexp, or with
// splits > 1 the partial (O, m, l) for mhsa_fwd_merge_kernel, as
// mhsa_fwd_kernel<TRAIN>.  !TRAIN is the eval forward (route k2_bf16): no
// keep hash, and out32, lse and seed are not touched (may be null).
template <bool TRAIN>
__global__ void __launch_bounds__(WS_THREADS, FWDB_MINB)
mhsa_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ kv_len,
                     const int* __restrict__ seed, bf16* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse,
                     float* __restrict__ part, float* __restrict__ pm, float* __restrict__ pl,
                     int B, int T, int H, int splits, float scale_log2, Drop d) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const WsSmem<1, false> sm(smem_raw);
    ws_init(sm, 1);
    const int nq = (T + BT - 1) / BT;
    const int BH = B * H;
    const int n_work = nq * BH * splits;
    const long long frame = (long long)H * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp == WG_THREADS / 32) {  // the producer warp
        if (lane != 0) return;
        Ring r{0, 0u};
        unsigned fph = 0;
        for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
            const Work x = work_item(w, nq, BH);
            const int b = x.bh / H, h = x.bh - b * H;
            const int L = min(max(kv_len[b], 0), T);
            const int n_tiles = (L + BT - 1) / BT;
            if (x.split >= n_tiles) continue;  // nothing to load (L == 0 included)
            mbar_wait(sm.fix_empty, fph ^ 1u);
            fph ^= 1u;
            mbar_expect_tx(sm.fix_full, TILE_BYTES);
            tma_tile(sm.fix, &tq, h, x.tile * BT, b, sm.fix_full);
            for (int it = x.split; it < n_tiles; it += splits) {
                mbar_wait(sm.empty + r.stage, r.phase ^ 1u);
                mbar_expect_tx(sm.full + r.stage, 2 * TILE_BYTES);
                tma_tile(sm.tile(r.stage, 0), &tk, h, it * BT, b, sm.full + r.stage);
                tma_tile(sm.tile(r.stage, 1), &tv, h, it * BT, b, sm.full + r.stage);
                r.next();
            }
        }
        return;
    }

    const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
    const bool drop = TRAIN && d.t24 != 0u;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;
    Ring r{0, 0u};
    unsigned fph = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work x = work_item(w, nq, BH);
        const int b = x.bh / H, h = x.bh - b * H;
        const int q0 = x.tile * BT;
        const long long base = (long long)b * T * frame + (long long)h * DH;
        const int L = min(max(kv_len[b], 0), T);
        const int n_tiles = (L + BT - 1) / BT;
        if (L == 0 && splits == 1) {  // no valid key: zeros, lse = -inf
            zero_rows_bf16(out, base, frame, q0, T, tid);
            if (TRAIN) {
                zero_rows(out32, base, frame, q0, T, tid);
                if (tid < BT && q0 + tid < T) lse[(long long)x.bh * T + q0 + tid] = -INFINITY;
            }
            continue;
        }
        if (x.split >= n_tiles) continue;  // no key tile for this split
        const int n_my = (n_tiles - x.split + splits - 1) / splits;

        const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
        unsigned rbase[2] = {0u, 0u};
        if (drop) {
#pragma unroll
            for (int u = 0; u < 2; ++u) rbase[u] = row_base(d, seed_term, x.bh, row[u]);
        }
        float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
        float l[2] = {0.f, 0.f};              // this lane's part of the row sum
        float o[8][4], sc[8][4];
        unsigned pa[4][4];
        zero_acc(o);

        // Per key tile: S_i, its softmax, O = O * alpha + bf16(P_i) . V_i,
        // each waited for before the next (see "Overlap" above).
        mbar_wait(sm.fix_full, fph);
        fph ^= 1u;
        for (int i = 0; i < n_my; ++i) {
            const int cur = r.stage;
            mbar_wait(sm.full + cur, r.phase);
            fence_acc(sc);
            wgmma_fence();
            gemm_ss(sc, sm.fix, sm.tile(cur, 0));  // S_i = Q . K_i^T
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(sc);
            if (i + 1 == n_my) release(sm.fix_empty, lane);  // Q is read
            // the online softmax of S_i: running max and sum, O's rescale
            const int j0 = (x.split + i * splits) * BT;
            if (j0 + BT > L) {  // the edge tile (block-uniform)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (j0 + nt * 8 + 2 * t + (e & 1) >= L) sc[nt][e] = -INFINITY;
            }
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
            float mnew[2], alpha[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
                mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
                mnew[u] = fmaxf(m[u], mx[u] * scale_log2);
                alpha[u] = exp2_ftz(m[u] - mnew[u]);  // 0 on the first tile
                m[u] = mnew[u];
                l[u] *= alpha[u];
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int u = e >> 1;
                    float p = exp2_ftz(fmaf(sc[nt][e], scale_log2, -mnew[u]));
                    l[u] += p;  // the normaliser sums the undropped probabilities
                    if (drop && !keep24(d, rbase[u], j0 + nt * 8 + 2 * t + (e & 1))) p = 0.f;
                    sc[nt][e] = p;
                }
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
            pack_frags(pa, sc);
            fence_acc(o);
            fence_frag(pa);
            wgmma_fence();
            gemm_rs(o, pa, sm.tile(cur, 1));  // O = O * alpha + bf16(P_i) . V_i
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(o);
            fence_frag(pa);
            release(sm.empty + cur, lane);  // K_i and V_i are read
            r.next();
        }

#pragma unroll
        for (int u = 0; u < 2; ++u) {
            l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
            l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
        }
        if (splits == 1) {
            const float ks = drop ? d.kscale : 1.f;
            const float inv[2] = {ks / l[0], ks / l[1]};
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];
            store_rows_bf16(out, TRAIN ? out32 : nullptr, o, base, frame, q0 + warp * 16, T,
                            lane);
            if (TRAIN && t == 0) {
#pragma unroll
                for (int u = 0; u < 2; ++u)
                    if (row[u] < T) lse[(long long)x.bh * T + row[u]] = (m[u] + log2f(l[u])) * LN2;
            }
            continue;
        }
        const long long n_out = (long long)B * T * frame;
        store_rows(part + x.split * n_out, o, base, frame, q0 + warp * 16, T, lane);
        if (t == 0) {
            const long long st = ((long long)x.split * BH + x.bh) * T;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                if (row[u] < T) {
                    pm[st + row[u]] = m[u];
                    pl[st + row[u]] = l[u];
                }
            }
        }
    }
}

// bf16 K3, dq pass, persistent over (64-query tile, b*h): dq (bfloat16),
// and D = rowsum(dO o O) of those rows (O the forward's float32 output)
// into `delta`.
__global__ void __launch_bounds__(WS_THREADS, DQB_MINB)
mhsa_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const int* __restrict__ kv_len,
                        const int* __restrict__ seed, const float* __restrict__ out32,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int B, int T, int H,
                        float scale, Drop d) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const WsSmem<2, false> sm(smem_raw);
    ws_init(sm, 1);
    const int nq = (T + BT - 1) / BT;
    const int BH = B * H;
    const int n_work = nq * BH;
    const long long frame = (long long)H * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp == WG_THREADS / 32) {  // the producer warp
        if (lane != 0) return;
        Ring r{0, 0u};
        unsigned fph = 0;
        for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
            const Work x = work_item(w, nq, BH);
            const int b = x.bh / H, h = x.bh - b * H;
            const int L = min(max(kv_len[b], 0), T);
            if (L == 0) continue;
            mbar_wait(sm.fix_empty, fph ^ 1u);
            fph ^= 1u;
            mbar_expect_tx(sm.fix_full, 2 * TILE_BYTES);
            tma_tile(sm.fix, &tq, h, x.tile * BT, b, sm.fix_full);
            tma_tile(sm.fix + TILE_BYTES, &tdo, h, x.tile * BT, b, sm.fix_full);
            for (int j0 = 0; j0 < L; j0 += BT) {
                mbar_wait(sm.empty + r.stage, r.phase ^ 1u);
                mbar_expect_tx(sm.full + r.stage, 2 * TILE_BYTES);
                tma_tile(sm.tile(r.stage, 0), &tk, h, j0, b, sm.full + r.stage);
                tma_tile(sm.tile(r.stage, 1), &tv, h, j0, b, sm.full + r.stage);
                r.next();
            }
        }
        return;
    }

    const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
    const bool drop = d.t24 != 0u;
    const float scale_log2 = scale * LOG2E;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;
    Ring r{0, 0u};
    unsigned fph = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work x = work_item(w, nq, BH);
        const int b = x.bh / H, h = x.bh - b * H;
        const int q0 = x.tile * BT;
        const long long base = (long long)b * T * frame + (long long)h * DH;
        const int L = min(max(kv_len[b], 0), T);
        if (L == 0) {  // no valid key: zeros
            zero_rows_bf16(dq, base, frame, q0, T, tid);
            continue;
        }
        // D = rowsum(dO o O), while the tiles fly: threads 2r, 2r + 1 take
        // the halves of row r (warp w holds rows 16 w .. 16 w + 15)
        float dsum = 0.f;
        {
            const int rr = q0 + (tid >> 1);
            if (rr < T) {
                const long long off = base + (long long)rr * frame + (tid & 1) * (DH / 2);
#pragma unroll
                for (int c = 0; c < DH / 2; c += 8) {
                    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(dout + off + c));
                    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
                    const float4 o0 = __ldg(reinterpret_cast<const float4*>(out32 + off + c));
                    const float4 o1 = __ldg(reinterpret_cast<const float4*>(out32 + off + c + 4));
                    const float2 d0 = __bfloat1622float2(pr[0]), d1 = __bfloat1622float2(pr[1]);
                    const float2 d2 = __bfloat1622float2(pr[2]), d3 = __bfloat1622float2(pr[3]);
                    dsum = dot4(make_float4(d0.x, d0.y, d1.x, d1.y), o0, dsum);
                    dsum = dot4(make_float4(d2.x, d2.y, d3.x, d3.y), o1, dsum);
                }
            }
            dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
            if (rr < T && (tid & 1) == 0) delta[(long long)x.bh * T + rr] = dsum;
        }
        const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
        const float dlt[2] = {__shfl_sync(0xffffffffu, dsum, 2 * g),
                              __shfl_sync(0xffffffffu, dsum, 2 * g + 16)};
        float lse2[2];
        unsigned rbase[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            lse2[u] = row[u] < T ? lse[(long long)x.bh * T + row[u]] * LOG2E : 0.f;
            rbase[u] = drop ? row_base(d, seed_term, x.bh, row[u]) : 0u;
        }

        float acc[8][4], s[8][4], dp[8][4];
        zero_acc(acc);
        const int n_tiles = (L + BT - 1) / BT;
        mbar_wait(sm.fix_full, fph);
        fph ^= 1u;
        mbar_wait(sm.full + r.stage, r.phase);
        wgmma_fence();
        gemm_ss(s, sm.fix, sm.tile(r.stage, 0));                // S = Q . K^T
        gemm_ss(dp, sm.fix + TILE_BYTES, sm.tile(r.stage, 1));  // dPd = dO . V^T
        wgmma_commit();
        for (int it = 0; it < n_tiles; ++it) {
            const int cur = r.stage;
            wgmma_wait<0>();  // S, dP of this tile and dq of the last are done
            fence_acc(s);
            fence_acc(dp);
            fence_acc(acc);
            if (it > 0) release(sm.empty + (cur == 0 ? STAGES - 1 : cur - 1), lane);
            if (it + 1 == n_tiles) release(sm.fix_empty, lane);  // Q and dO are read
            const int j0 = it * BT;
            // ds of one element into s; keys >= L masked on the edge tile only
            auto ds_at = [&](int nt, int e, bool edge) {
                const int u = e >> 1;
                const int key = j0 + nt * 8 + 2 * t + (e & 1);
                const float p = exp2_ftz(fmaf(s[nt][e], scale_log2, -lse2[u]));
                float dpv = dp[nt][e];
                if (drop) dpv *= keep24(d, rbase[u], key) ? d.kscale : 0.f;
                const float ds = p * (dpv - dlt[u]) * scale;
                s[nt][e] = edge && key >= L ? 0.f : ds;
            };
            if (j0 + BT > L) {  // block-uniform
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) ds_at(nt, e, true);
            } else {
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) ds_at(nt, e, false);
            }
            unsigned da[4][4];
            pack_frags(da, s);
            fence_acc(acc);
            fence_frag(da);
            wgmma_fence();
            gemm_rs(acc, da, sm.tile(cur, 0));  // dq += bf16(dS * scale) . K
            wgmma_commit();
            r.next();
            if (it + 1 < n_tiles) {  // the next tile's S and dP run beside it
                mbar_wait(sm.full + r.stage, r.phase);
                fence_acc(s);
                fence_acc(dp);
                wgmma_fence();
                gemm_ss(s, sm.fix, sm.tile(r.stage, 0));
                gemm_ss(dp, sm.fix + TILE_BYTES, sm.tile(r.stage, 1));
                wgmma_commit();
            }
            fence_frag(da);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        release(sm.empty + (r.stage == 0 ? STAGES - 1 : r.stage - 1), lane);
        store_rows_bf16(dq, nullptr, acc, base, frame, q0 + warp * 16, T, lane);
    }
}

// bf16 K3, dk/dv pass, persistent over (64-key tile, b*h): dk, dv
// (bfloat16) walking every 64-query tile; one writer per element, float32
// sums.  The producer warp's lanes write each query tile's lse * log2 e, D
// and hash row bases beside its Q and dO.
__global__ void __launch_bounds__(WS_THREADS, DKDVB_MINB)
mhsa_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const int* __restrict__ kv_len, const int* __restrict__ seed,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int T, int H,
                          float scale, Drop d) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const WsSmem<2, true> sm(smem_raw);
    ws_init(sm, 32);
    const int nk = (T + BT - 1) / BT;
    const int BH = B * H;
    const int n_work = nk * BH;
    const long long frame = (long long)H * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool drop = d.t24 != 0u;
    const unsigned seed_term = drop ? (unsigned)seed[0] * 0x9E3779B9u : 0u;

    if (warp == WG_THREADS / 32) {  // the producer warp, all 32 lanes
        Ring r{0, 0u};
        unsigned fph = 0;
        for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
            const Work x = work_item(w, nk, BH);
            const int b = x.bh / H, h = x.bh - b * H;
            const int L = min(max(kv_len[b], 0), T);
            if (x.tile * BT >= L) continue;  // keys no query sees
            if (lane == 0) {
                mbar_wait(sm.fix_empty, fph ^ 1u);
                mbar_expect_tx(sm.fix_full, 2 * TILE_BYTES);
                tma_tile(sm.fix, &tk, h, x.tile * BT, b, sm.fix_full);
                tma_tile(sm.fix + TILE_BYTES, &tv, h, x.tile * BT, b, sm.fix_full);
            }
            fph ^= 1u;
            const long long stats = (long long)x.bh * T;
            for (int c0 = 0; c0 < T; c0 += BT) {
                mbar_wait(sm.empty + r.stage, r.phase ^ 1u);
                float* rows = sm.rows + r.stage * 3 * BT;
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                    const int qr = c0 + lane + 32 * k;
                    const bool ok = qr < T;
                    rows[lane + 32 * k] = ok ? lse[stats + qr] * LOG2E : 0.f;
                    rows[BT + lane + 32 * k] = ok ? delta[stats + qr] : 0.f;
                    rows[2 * BT + lane + 32 * k] =
                        __uint_as_float(drop && ok ? row_base(d, seed_term, x.bh, qr) : 0u);
                }
                if (lane == 0) {
                    mbar_expect_tx(sm.full + r.stage, 2 * TILE_BYTES);
                    tma_tile(sm.tile(r.stage, 0), &tq, h, c0, b, sm.full + r.stage);
                    tma_tile(sm.tile(r.stage, 1), &tdo, h, c0, b, sm.full + r.stage);
                } else {
                    mbar_arrive(sm.full + r.stage);
                }
                r.next();
            }
        }
        return;
    }

    const int tid = threadIdx.x, g = lane >> 2, t = lane & 3;
    const float scale_log2 = scale * LOG2E;
    Ring r{0, 0u};
    unsigned fph = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work x = work_item(w, nk, BH);
        const int b = x.bh / H, h = x.bh - b * H;
        const int k0 = x.tile * BT;
        const long long base = (long long)b * T * frame + (long long)h * DH;
        const int L = min(max(kv_len[b], 0), T);
        if (k0 >= L) {  // keys no query sees: zero gradients
            zero_rows_bf16(dk, base, frame, k0, T, tid);
            zero_rows_bf16(dv, base, frame, k0, T, tid);
            continue;
        }
        const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
        const bool key_edge = k0 + BT > L;
        float gk[8][4], gv[8][4], s[8][4], dp[8][4];
        zero_acc(gk);
        zero_acc(gv);
        mbar_wait(sm.fix_full, fph);
        fph ^= 1u;
        mbar_wait(sm.full + r.stage, r.phase);
        wgmma_fence();
        gemm_ss(s, sm.fix, sm.tile(r.stage, 0));                // S^T = K . Q^T
        gemm_ss(dp, sm.fix + TILE_BYTES, sm.tile(r.stage, 1));  // dPd^T = V . dO^T
        wgmma_commit();
        const int n_tiles = (T + BT - 1) / BT;
        for (int it = 0; it < n_tiles; ++it) {
            const int cur = r.stage;
            wgmma_wait<0>();
            fence_acc(s);
            fence_acc(dp);
            fence_acc(gk);
            fence_acc(gv);
            if (it > 0) release(sm.empty + (cur == 0 ? STAGES - 1 : cur - 1), lane);
            if (it + 1 == n_tiles) release(sm.fix_empty, lane);  // K and V are read
            const float* Lt = sm.rows + cur * 3 * BT;
            const float* Dt = Lt + BT;
            const float* Rt = Dt + BT;
            const int c0 = it * BT;
            // pd and ds of the 4 elements of column group nt into s and dp;
            // keys >= L and queries >= T masked on edge tiles only
            auto pd_ds_at = [&](int nt, bool edge) {
                const int col = nt * 8 + 2 * t;
                const float2 lt = *reinterpret_cast<const float2*>(Lt + col);
                const float2 dt = *reinterpret_cast<const float2*>(Dt + col);
                const float2 rt = *reinterpret_cast<const float2*>(Rt + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int u = e >> 1, c = e & 1;
                    const float p = exp2_ftz(fmaf(s[nt][e], scale_log2, -(c ? lt.y : lt.x)));
                    float dpv = dp[nt][e];
                    float pd = p;
                    if (drop) {
                        const float f =
                            keep24(d, __float_as_uint(c ? rt.y : rt.x), key[u]) ? d.kscale : 0.f;
                        pd = p * f;
                        dpv *= f;
                    }
                    float ds = p * (dpv - (c ? dt.y : dt.x)) * scale;
                    if (edge && ((key_edge && key[u] >= L) || c0 + col + c >= T)) {
                        pd = 0.f;
                        ds = 0.f;
                    }
                    s[nt][e] = pd;
                    dp[nt][e] = ds;
                }
            };
            if (key_edge || c0 + BT > T) {  // block-uniform
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) pd_ds_at(nt, true);
            } else {
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) pd_ds_at(nt, false);
            }
            unsigned pa[4][4], sa[4][4];
            pack_frags(pa, s);
            pack_frags(sa, dp);
            fence_acc(gk);
            fence_acc(gv);
            fence_frag(pa);
            fence_frag(sa);
            wgmma_fence();
            gemm_rs(gv, pa, sm.tile(cur, 1));  // dv += bf16(Pd)^T . dO
            gemm_rs(gk, sa, sm.tile(cur, 0));  // dk += bf16(dS * scale)^T . Q
            wgmma_commit();
            r.next();
            if (it + 1 < n_tiles) {  // the next query tile's S^T and dP^T beside them
                mbar_wait(sm.full + r.stage, r.phase);
                fence_acc(s);
                fence_acc(dp);
                wgmma_fence();
                gemm_ss(s, sm.fix, sm.tile(r.stage, 0));
                gemm_ss(dp, sm.fix + TILE_BYTES, sm.tile(r.stage, 1));
                wgmma_commit();
            }
            fence_frag(pa);
            fence_frag(sa);
        }
        wgmma_wait<0>();
        fence_acc(gk);
        fence_acc(gv);
        release(sm.empty + (r.stage == 0 ? STAGES - 1 : r.stage - 1), lane);
        store_rows_bf16(dk, nullptr, gk, base, frame, k0 + warp * 16, T, lane);
        store_rows_bf16(dv, nullptr, gv, base, frame, k0 + warp * 16, T, lane);
    }
}

int check_shape(int B, int T, int H, int dh) {
    if (B < 1 || T < 1 || H < 1 || dh != DH || (long long)B * H > 65535) {
        return fail((int)cudaErrorInvalidValue,
                    "shape check: B=%d T=%d H=%d dh=%d (B, T, H >= 1, dh == %d, B*H <= 65535)",
                    B, T, H, dh, DH);
    }
    return 0;
}

// The dropout of a launch over heads [h0, h0 + H) of a model with ht heads.
Drop make_drop(int thresh, int bq, int tp, int H, int h0, int ht) {
    Drop d;
    d.t24 = thresh > 0 ? (unsigned)thresh << 24 : 0u;
    d.kscale = thresh > 0 ? 256.0f / (256.0f - (float)thresh) : 1.0f;
    d.bq = bq;
    d.nq = 1;  // set by the caller from T
    d.tp = (unsigned)tp;
    d.hl = H;
    d.h0 = h0;
    d.ht = ht;
    return d;
}

// The hash arguments of a training launch, checked: 0 or the failure.
int check_hash_args(int T, int H, int thresh, int bq, int tp, int h0, int ht) {
    if (thresh < 0 || thresh > 255 || bq < 1 || T % bq != 0 || tp < T || h0 < 0 ||
        ht < h0 + H) {
        return fail((int)cudaErrorInvalidValue,
                    "dropout hash arguments: thresh=%d bq=%d T=%d tp=%d heads [%d, %d) of %d",
                    thresh, bq, T, tp, h0, h0 + H, ht);
    }
    return 0;
}

// The dynamic shared-memory opt-in of `kernel` (named `name`) on the
// current device: 0 or the failure.
template <typename K>
int set_smem(K kernel, size_t bytes, const char* name) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return e == cudaSuccess
               ? 0
               : fail((int)e, "cudaFuncSetAttribute(%s, max dynamic shared memory %zu B)", name,
                      bytes);
}

// A forward's split count and scratch, checked: 0 or the failure.
int check_splits(int splits, const void* scratch) {
    if (splits < 1 || splits > MAX_SPLITS || (splits > 1 && scratch == nullptr)) {
        return fail((int)cudaErrorInvalidValue, "key splits %d (1..%d; scratch %s)", splits,
                    MAX_SPLITS, scratch ? "given" : "null");
    }
    return 0;
}

// The key splits of a forward launch over B*H*ceil(T/64) query tiles:
// the s <= MAX_SPLITS that least costs waves(s) * key tiles per split, with
// `slots` blocks resident at once, if that is at most 3/4 of the unsplit
// cost (the merge's extra traffic must pay).  Key tiles counted to T: L is
// on the device, and round-robin splits share any L alike.
int pick_splits(long long q_tiles, int k_tiles, long long slots) {
    const long long cost1 = ((q_tiles + slots - 1) / slots) * k_tiles;
    int best = 1;
    long long best_cost = cost1;
    for (int s = 2; s <= MAX_SPLITS && s <= k_tiles; ++s) {
        const long long c = ((q_tiles * s + slots - 1) / slots) * ((k_tiles + s - 1) / s);
        if (c < best_cost) {
            best = s;
            best_cost = c;
        }
    }
    return 4 * best_cost <= 3 * cost1 ? best : 1;
}

template <bool TRAIN>
int launch_fwd(const void* q, const void* k, const void* v, const void* kv_len,
               const void* seed, void* out, void* lse, void* scratch, int B, int T, int H,
               int splits, Drop d, void* stream) {
    if (int rc = check_splits(splits, scratch)) return rc;
    // per launch, as the attribute is per device
    if (int rc = set_smem(mhsa_fwd_kernel<TRAIN>, FWD_SMEM,
                          TRAIN ? "mhsa_fwd_kernel<true>" : "mhsa_fwd_kernel<false>")) {
        return rc;
    }
    const float scale_log2 = (1.0f / sqrtf((float)DH)) * LOG2E;
    cudaStream_t st = (cudaStream_t)stream;
    const long long n_out = (long long)B * T * H * DH;
    const long long n_stat = (long long)B * H * T;
    float* part = static_cast<float*>(scratch);
    float* pm = splits > 1 ? part + splits * n_out : nullptr;
    float* pl = splits > 1 ? pm + splits * n_stat : nullptr;
    dim3 grid((T + BT - 1) / BT, B * H, splits);
    mhsa_fwd_kernel<TRAIN><<<grid, THREADS, FWD_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<float*>(out), static_cast<float*>(lse),
        part, pm, pl, T, H, splits, scale_log2, d);
    if (int rc = check_launch(TRAIN ? "mhsa_fwd_kernel<true>" : "mhsa_fwd_kernel<false>")) {
        return rc;
    }
    if (splits > 1) {
        const long long n = n_out / 4;
        mhsa_fwd_merge_kernel<<<(unsigned)((n + MERGE_THREADS - 1) / MERGE_THREADS),
                                MERGE_THREADS, 0, st>>>(
            part, pm, pl, static_cast<const int*>(kv_len), static_cast<float*>(out), nullptr,
            static_cast<float*>(lse), B, T, H, splits,
            TRAIN && d.t24 != 0u ? d.kscale : 1.0f);
        return check_launch("mhsa_fwd_merge_kernel");
    }
    return 0;
}

// cuTensorMapEncodeTiled, looked up in the driver at run time, so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Makes the current device's primary context current on the calling
// thread, which the CUDA driver call in head_map needs (cuTensorMapEncodeTiled
// fails with CUDA_ERROR_INVALID_CONTEXT without one).  The runtime binds
// it only at its first call on a thread that needs a context, and a
// thread may reach a launcher before any such call: autograd's device
// thread, whose first CUDA work is the bf16 backward when the caching
// allocator serves all of that backward's tensors from blocks it holds
// (PyTorch binds no context to the thread for its default device).  Since
// CUDA 12 cudaSetDevice initialises and binds the primary context.
int bind_context() {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e) return fail((int)e, "bind_context: cudaGetDevice");
    e = cudaSetDevice(dev);
    return e ? fail((int)e, "bind_context: cudaSetDevice(%d)", dev) : 0;
}

// The tensor map of a (B, T, H, 64) bfloat16 tensor `name` in place, as
// (64, H, T, B) with a (64, 1, 64, 1) box in the 128-byte swizzle; rows
// past T read as zeros.  0, or the failure: the CUDA driver's lookup, the
// address's alignment, or the encode's own CUresult.
int head_map(CUtensorMap* map, const void* x, int B, int T, int H, const char* name) {
    static EncodeTiledFn encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
        if (e != cudaSuccess) {
            return fail((int)e, "head_map(%s): cudaGetDriverEntryPointByVersion"
                        "(cuTensorMapEncodeTiled)", name);
        }
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
            return fail((int)cudaErrorNotSupported, "head_map(%s): cuTensorMapEncodeTiled not "
                        "found in the driver (query result %d)", name, (int)found);
        }
        encode = reinterpret_cast<EncodeTiledFn>(fn);
    }
    if (reinterpret_cast<unsigned long long>(x) % 16 != 0) {
        return fail((int)cudaErrorInvalidValue, "head_map(%s): address %p is not 16-byte "
                    "aligned", name, x);
    }
    const cuuint64_t dims[4] = {DH, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[3] = {DH * 2, (cuuint64_t)H * DH * 2, (cuuint64_t)T * H * DH * 2};
    const cuuint32_t box[4] = {DH, 1, BT, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
        return fail_driver((int)r, "head_map(%s): cuTensorMapEncodeTiled at %p, (B, T, H) = "
                           "(%d, %d, %d)", name, x, B, T, H);
    }
    return 0;
}

// Blocks of `kernel` (named `name`) resident on the current device at
// once (SMs x blocks an SM, >= 1), or -cudaError, recorded.
template <typename K>
long long resident_blocks(K kernel, size_t smem, int threads, const char* name) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e) return -(long long)fail((int)e, "resident_blocks(%s): cudaGetDevice", name);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e) {
        return -(long long)fail((int)e, "resident_blocks(%s): cudaDeviceGetAttribute"
                                "(multiprocessor count, device %d)", name, dev);
    }
    if (int rc = set_smem(kernel, smem, name)) return -(long long)rc;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e) {
        return -(long long)fail((int)e, "resident_blocks(%s): cudaOccupancyMaxActiveBlocks"
                                "PerMultiprocessor(%d threads, %zu B)", name, threads, smem);
    }
    if (per_sm < 1) {
        return -(long long)fail((int)cudaErrorInvalidConfiguration, "resident_blocks(%s): no "
                                "block of %d threads and %zu B fits an SM", name, threads, smem);
    }
    return (long long)sms * per_sm;
}

// The persistent grid of a warp-specialised kernel over n_work items, or
// -cudaError, recorded.
template <typename K>
int ws_grid(K kernel, size_t smem, long long n_work, const char* name) {
    const long long slots = resident_blocks(kernel, smem, WS_THREADS, name);
    if (slots < 0) return (int)slots;
    return (int)(n_work < slots ? n_work : slots);
}

template <bool TRAIN>
int launch_fwd_bf16(const void* q, const void* k, const void* v, const void* kv_len,
                    const void* seed, void* out, void* out32, void* lse, void* scratch, int B,
                    int T, int H, int splits, Drop d, void* stream) {
    if (int rc = check_splits(splits, scratch)) return rc;
    if (int rc = bind_context()) return rc;
    CUtensorMap mq, mk, mv;
    if (int rc = head_map(&mq, q, B, T, H, "q")) return rc;
    if (int rc = head_map(&mk, k, B, T, H, "k")) return rc;
    if (int rc = head_map(&mv, v, B, T, H, "v")) return rc;
    const char* name = TRAIN ? "mhsa_fwd_bf16_kernel<true>" : "mhsa_fwd_bf16_kernel<false>";
    const long long n_work = (long long)((T + BT - 1) / BT) * B * H * splits;
    const int grid = ws_grid(mhsa_fwd_bf16_kernel<TRAIN>, FWDB_SMEM, n_work, name);
    if (grid < 0) return -grid;
    const float scale_log2 = (1.0f / sqrtf((float)DH)) * LOG2E;
    cudaStream_t st = (cudaStream_t)stream;
    const long long n_out = (long long)B * T * H * DH;
    const long long n_stat = (long long)B * H * T;
    float* part = static_cast<float*>(scratch);
    float* pm = splits > 1 ? part + splits * n_out : nullptr;
    float* pl = splits > 1 ? pm + splits * n_stat : nullptr;
    mhsa_fwd_bf16_kernel<TRAIN><<<grid, WS_THREADS, FWDB_SMEM, st>>>(
        mq, mk, mv, static_cast<const int*>(kv_len), static_cast<const int*>(seed),
        static_cast<bf16*>(out), static_cast<float*>(out32), static_cast<float*>(lse), part, pm,
        pl, B, T, H, splits, scale_log2, d);
    if (int rc = check_launch(name)) return rc;
    if (splits > 1) {
        const long long n = n_out / 4;
        mhsa_fwd_merge_kernel<<<(unsigned)((n + MERGE_THREADS - 1) / MERGE_THREADS),
                                MERGE_THREADS, 0, st>>>(
            part, pm, pl, static_cast<const int*>(kv_len), static_cast<float*>(out32),
            static_cast<bf16*>(out), static_cast<float*>(lse), B, T, H, splits,
            TRAIN && d.t24 != 0u ? d.kscale : 1.0f);
        return check_launch("mhsa_fwd_merge_kernel");
    }
    return 0;
}

// The key splits of a forward of kernel `kernel` run in blocks of
// `threads` (see pick_splits), or -cudaError.
template <typename K>
int fwd_splits(K kernel, size_t smem, int threads, int B, int T, int H, const char* name) {
    const long long slots = resident_blocks(kernel, smem, threads, name);
    if (slots < 0) return (int)slots;
    const int n = (T + BT - 1) / BT;
    return pick_splits((long long)B * H * n, n, slots);
}

}  // namespace

// C entry points (bound with ctypes).  q, k, v, out, dout, dq, dk, dv:
// (B, T, H, dh) float32, contiguous; kv_len: (B,) int32 and seed: (1,)
// int32 on the device; lse, delta: (B, H, T) float32.  dh must be 64.
// thresh = round(rate * 256) in [0, 255]; bq the JAX query block (T % bq
// == 0) and tp = ceil(T / 128) * 128 index the dropout hash.  A forward
// takes `splits` from adyolo_mhsa_fwd_splits and, when it is above 1, a
// float32 `scratch` of adyolo_mhsa_fwd_scratch_floats elements.  Each
// launches on `stream` and returns 0 on success, else the CUDA error of
// the site that failed, which adyolo_last_error (csrc/errors.cu) names.

// Dynamic shared memory a kernel launches with: 0 the forward, 1 the dq
// pass, 2 the dk/dv pass; 3, 4, 5 the same of the bfloat16 kernels.
extern "C" long long adyolo_mhsa_smem_bytes(int which) {
    const size_t bytes[6] = {FWD_SMEM, DQ_SMEM, DKDV_SMEM, FWDB_SMEM, DQB_SMEM, DKDVB_SMEM};
    return which >= 0 && which < 6 ? (long long)bytes[which] : -1LL;
}

// The key splits a forward of this shape runs in on the current device
// (>= 1), or -cudaError.  Not cached: the caller keeps a plan per device.
extern "C" int adyolo_mhsa_fwd_splits(int B, int T, int H) {
    if (int rc = enter("adyolo_mhsa_fwd_splits")) return -rc;
    return fwd_splits(mhsa_fwd_kernel<true>, FWD_SMEM, THREADS, B, T, H,
                      "mhsa_fwd_kernel<true>");
}

// The same for the bfloat16 forwards (train and eval: one shared-memory
// size and launch bound, so one occupancy).
extern "C" int adyolo_mhsa_fwd_bf16_splits(int B, int T, int H) {
    if (int rc = enter("adyolo_mhsa_fwd_bf16_splits")) return -rc;
    return fwd_splits(mhsa_fwd_bf16_kernel<true>, FWDB_SMEM, WS_THREADS, B, T, H,
                      "mhsa_fwd_bf16_kernel<true>");
}

// Floats of the scratch a forward in `splits` > 1 key splits needs.
extern "C" long long adyolo_mhsa_fwd_scratch_floats(int B, int T, int H, int splits) {
    return (long long)splits * B * T * H * (DH + 2);
}

// Eval forward (K2 at rate 0, K4).
extern "C" int adyolo_mhsa_fwd(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, void* scratch, int B, int T,
                               int H, int dh, int splits, void* stream) {
    if (int rc = enter("adyolo_mhsa_fwd")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    return launch_fwd<false>(q, k, v, kv_len, nullptr, out, nullptr, scratch, B, T, H, splits,
                             make_drop(0, 1, 128, H, 0, H), stream);
}

// Train forward (K2 with its dropout branch): out and the row logsumexp.  The
// launch holds heads [head_offset, head_offset + H) of a model with heads_total
// heads (the keep hash's head index); the train entry points below take the same.
extern "C" int adyolo_mhsa_fwd_train(const void* q, const void* k, const void* v,
                                     const void* kv_len, const void* seed, void* out,
                                     void* lse, void* scratch, int B, int T, int H, int dh,
                                     int thresh, int bq, int tp, int head_offset, int heads_total,
                                     int splits, void* stream) {
    if (int rc = enter("adyolo_mhsa_fwd_train")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (int rc = check_hash_args(T, H, thresh, bq, tp, head_offset, heads_total)) return rc;
    Drop d = make_drop(thresh, bq, tp, H, head_offset, heads_total);
    d.nq = T / bq;
    return launch_fwd<true>(q, k, v, kv_len, seed, out, lse, scratch, B, T, H, splits, d,
                            stream);
}

// Backward (K3): dq (and D into `delta`), then dk and dv.
extern "C" int adyolo_mhsa_bwd(const void* q, const void* k, const void* v,
                               const void* kv_len, const void* seed, const void* out,
                               const void* dout, const void* lse, void* delta,
                               void* dq, void* dk, void* dv, int B, int T, int H,
                               int dh, int thresh, int bq, int tp, int head_offset,
                               int heads_total, void* stream) {
    if (int rc = enter("adyolo_mhsa_bwd")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (int rc = check_hash_args(T, H, thresh, bq, tp, head_offset, heads_total)) return rc;
    if (int rc = set_smem(mhsa_bwd_dq_kernel, DQ_SMEM, "mhsa_bwd_dq_kernel")) return rc;
    if (int rc = set_smem(mhsa_bwd_dkdv_kernel, DKDV_SMEM, "mhsa_bwd_dkdv_kernel")) return rc;
    Drop d = make_drop(thresh, bq, tp, H, head_offset, heads_total);
    d.nq = T / bq;
    const float scale = 1.0f / sqrtf((float)DH);
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid((T + BT - 1) / BT, B * H);
    mhsa_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(out),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq), T, H, scale, d);
    if (int rc = check_launch("mhsa_bwd_dq_kernel")) return rc;
    mhsa_bwd_dkdv_kernel<<<grid, THREADS, DKDV_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(kv_len),
        static_cast<const int*>(seed), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), T, H, scale, d);
    return check_launch("mhsa_bwd_dkdv_kernel");
}

// bf16 train forward (K2 with its dropout branch on bfloat16 q/k/v): out
// (bfloat16), out32 (the same output in float32, for the backward's D) and
// the row logsumexp.
extern "C" int adyolo_mhsa_fwd_train_bf16(const void* q, const void* k, const void* v,
                                          const void* kv_len, const void* seed, void* out,
                                          void* out32, void* lse, void* scratch, int B, int T,
                                          int H, int dh, int thresh, int bq, int tp,
                                          int head_offset, int heads_total, int splits,
                                          void* stream) {
    if (int rc = enter("adyolo_mhsa_fwd_train_bf16")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (int rc = check_hash_args(T, H, thresh, bq, tp, head_offset, heads_total)) return rc;
    Drop d = make_drop(thresh, bq, tp, H, head_offset, heads_total);
    d.nq = T / bq;
    return launch_fwd_bf16<true>(q, k, v, kv_len, seed, out, out32, lse, scratch, B, T, H,
                                 splits, d, stream);
}

// bf16 eval forward (K2 at rate 0 on bfloat16 q/k/v, route k2_bf16): out
// (bfloat16) only, any T; no hash arguments, no lse.
extern "C" int adyolo_mhsa_fwd_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* out, void* scratch, int B, int T,
                                    int H, int dh, int splits, void* stream) {
    if (int rc = enter("adyolo_mhsa_fwd_bf16")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    return launch_fwd_bf16<false>(q, k, v, kv_len, nullptr, out, nullptr, nullptr, scratch, B,
                                  T, H, splits, make_drop(0, 1, 128, H, 0, H), stream);
}

// bf16 backward (K3 on bfloat16 q/k/v/dO): dq (and D into `delta`, from
// out32), then dk and dv, all bfloat16.
extern "C" int adyolo_mhsa_bwd_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_len, const void* seed, const void* out32,
                                    const void* dout, const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, int B, int T, int H, int dh,
                                    int thresh, int bq, int tp, int head_offset,
                                    int heads_total, void* stream) {
    if (int rc = enter("adyolo_mhsa_bwd_bf16")) return rc;
    if (int rc = check_shape(B, T, H, dh)) return rc;
    if (int rc = check_hash_args(T, H, thresh, bq, tp, head_offset, heads_total)) return rc;
    if (int rc = bind_context()) return rc;
    CUtensorMap mq, mk, mv, mdo;
    if (int rc = head_map(&mq, q, B, T, H, "q")) return rc;
    if (int rc = head_map(&mk, k, B, T, H, "k")) return rc;
    if (int rc = head_map(&mv, v, B, T, H, "v")) return rc;
    if (int rc = head_map(&mdo, dout, B, T, H, "dout")) return rc;
    const long long n_work = (long long)((T + BT - 1) / BT) * B * H;  // both passes
    const int grid_dq = ws_grid(mhsa_bwd_dq_bf16_kernel, DQB_SMEM, n_work,
                                "mhsa_bwd_dq_bf16_kernel");
    if (grid_dq < 0) return -grid_dq;
    const int grid_dkdv = ws_grid(mhsa_bwd_dkdv_bf16_kernel, DKDVB_SMEM, n_work,
                                  "mhsa_bwd_dkdv_bf16_kernel");
    if (grid_dkdv < 0) return -grid_dkdv;
    Drop d = make_drop(thresh, bq, tp, H, head_offset, heads_total);
    d.nq = T / bq;
    const float scale = 1.0f / sqrtf((float)DH);
    cudaStream_t st = (cudaStream_t)stream;
    mhsa_bwd_dq_bf16_kernel<<<grid_dq, WS_THREADS, DQB_SMEM, st>>>(
        mq, mk, mv, mdo, static_cast<const int*>(kv_len), static_cast<const int*>(seed),
        static_cast<const float*>(out32), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), B, T,
        H, scale, d);
    if (int rc = check_launch("mhsa_bwd_dq_bf16_kernel")) return rc;
    mhsa_bwd_dkdv_bf16_kernel<<<grid_dkdv, WS_THREADS, DKDVB_SMEM, st>>>(
        mq, mk, mv, mdo, static_cast<const int*>(kv_len), static_cast<const int*>(seed),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), B, T, H, scale, d);
    return check_launch("mhsa_bwd_dkdv_bf16_kernel");
}
