// K2: blocked online-softmax attention (GQA, causal, sliding window) for
// Hopper, hand-written CUDA C++ built for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::_kernel.
// Same function: q (B, Sq, H, D) and k, v (B, Sk, KV, D) in the JAX
// layouts, query positions offset by Sk - Sq, keys masked by padding,
// causality and the window with -1e30, running max / denominator /
// accumulator in float32, output acc / max(l, 1e-30) in q's dtype. The KV
// head of query head h is h / (H / KV): K and V are read in place, never
// repeated. Key tiles wholly outside the causal / window band of a block's
// queries are skipped; they would add nothing.
//
// What bounds it on the card: at the shapes the one-shot path gives it
// (gemma-2b: B 4, S 256, H 8, KV 1, D 256, bf16) the function moves 9.4 MB
// and does 2.1 GFLOP, so its least time is the bytes (2.8 us at 3.35 TB/s);
// at paligemma's S 512 the operations (8.7 us at 989 TFLOP/s). In float32
// (the float32 one-shot paths, cifar10-scorenet) the operations: 2.1 GFLOP
// at 165 TFLOP/s (the tensor cores' TF32 rate over the three products of
// 3xTF32) is 13 us at gemma's shape.
//
// Four kernels, one per route (the `route` argument of flash_attention_fwd;
// flash_attention.py's route() picks it from the operands):
//
// * wgmma (bfloat16 that TMA can describe: base pointers 16-byte aligned, D
//   64, 128 or 256) -> flash_fwd_wgmma_kernel<D, KSPLIT>, on Hopper's
//   warpgroup tensor-core path. A block is three warpgroups: a producer and
//   two consumers. The producer gives back all but 40 of its registers
//   (setmaxnreg) so each consumer can hold 232 (O is 64 x D float32 across
//   a warpgroup: 128 registers a thread at D 256); ptxas alone would allot
//   168 to each of the three. One producer thread keeps TMA copies in
//   flight: Q once, then K and V tiles of 64 keys into a ring of 2-4
//   shared-memory stages (128-byte swizzle, each 64-column box at a 1024-byte
//   boundary), with completion on "full" mbarriers and reuse gated by
//   "empty" mbarriers: a Ring (ptx.cuh), whose waits name only their
//   barrier's current phase or the one before it. With the key tiles
//   split, tile i is for warpgroup i % 2 alone, which waits on that stage's
//   full barrier of its own, for its tiles in order; else both warpgroups
//   wait for every tile, in order, and both release it (empty counts 256).
//   (With the split over 3 stages (D 128, 256) tiles i and i + 3 share a
//   stage and go to different warpgroups, so with one full barrier a stage
//   warpgroup 1 could wait for a stage's next phase before warpgroup 0's
//   copy had landed and pass at once; with 4 stages (D 64) a stage's tiles
//   all go to one warpgroup, and unsplit both wait in order, so one
//   barrier would do there.) A consumer
//   warpgroup owns 64 query rows. The heads that share a KV head are packed
//   into those rows (G = the largest power of two dividing H / KV, at most
//   64: row r is position p0 + r / G of head h0 + r % G, one 4-d TMA box), so
//   at MQA 8/1 one K/V tile serves 8 positions x 8 heads. Per tile:
//     S = Q K^T   wgmma m64n64k16 over D, Q and K K-major from shared memory
//     masks (skipped when the whole tile is visible to every row), scale,
//     online softmax in base 2 (the scale folds in log2 e; running max and
//     sum in float32, -1e30 masks, as before), quad shuffles
//     O += P V    wgmma with P as the register A operand (the m64nNk16
//                 accumulator of two n8 tiles is the A fragment of 16 keys,
//                 P rounded to bf16 once) and V MN-major (transpose bit)
//   Two block shapes (launch_wgmma_dim): where blocks of 128 rows fill at
//   least 3/4 of a wave of the 132 SMs (mixtral, glm4, paligemma), the two
//   consumers each own a Q tile and read every K/V stage (one load for 128
//   rows, no merge); where they would not (gemma's 64 blocks, whisper's 48),
//   both share one Q tile and split its key tiles, and merge their partial
//   softmax states at the end, each merging half of the columns, so the
//   grid keeps 128 and 96 blocks. The epilogue writes O / max(l, 1e-30) in
//   bf16 into the Q tile's place and out by a TMA store, which drops the
//   rows past Sq. What holds it at 1.3-2.8x SDPA (PERF.md, tools/
//   kernel_stages.py): each warpgroup's tile is a serial chain S -> softmax
//   -> P V with one block an SM, and the epilogue; not the loads.
// * mma_sync (any other bf16: unaligned views, D 32) ->
//   flash_fwd_mma_kernel, the Ampere-style tensor-core kernel. One block of
//   4 warps owns 64 query rows (16 a warp) of one (batch, head). Q, K and V
//   stay bf16 in shared memory, rows padded by 16 bytes so that ldmatrix's 8
//   row addresses fall in distinct banks. K and V tiles of BK rows (64, or 32
//   at D 256 where the output accumulator takes 128 registers a thread) are
//   filled by 16-byte cp.async copies (element loads where a row start is
//   not 16-byte aligned), double-buffered: tile j + 1 loads while tile j
//   multiplies. Per tile and warp:
//     S = Q K^T   mma.sync m16n8k16 over D, Q by ldmatrix, K by ldmatrix
//                 (its rows are the product's columns), float32 accumulator
//     masks (padding, causal, window) on the accumulator fragments, scale,
//     online max / sum / rescale in float32 with quad shuffles (a fragment
//     row lives in the 4 lanes of a quad)
//     O += P V    P rounded to bf16 once, straight from the S accumulators
//                 (the m16n8 accumulator layout is the m16n8k16 A layout,
//                 two n8 tiles at a time), V by ldmatrix.trans
//   The products of two bf16 values are exact in the float32 accumulator,
//   so S loses only summation order; P's one rounding to bf16 is what
//   FlashAttention-2 does (about 1e-4 on outputs of about 0.1 at N(0, 1)
//   inputs, against the bf16 check's 2e-2).
//
// * tf32x3 (float32 whose base pointers are 16-byte aligned) ->
//   flash_fwd_tf32x3_kernel<D, KS>, float32 on the tensor cores. One TF32
//   product keeps 10 bits of each significand and misses the float32 check
//   (2e-5) by far; three meet it: each float32 value x is split in registers
//   into hi = tf32(x) (rounded to nearest) and lo = tf32(x - hi), and a b is
//   taken as a_lo b_hi + a_hi b_lo + a_hi b_hi (mma.sync m16n8k8 .tf32,
//   float32 accumulators; a_lo b_lo, about 2^-22 of a b, dropped). The
//   rounding is an integer add and mask (ptx.cuh), the value of
//   cvt.rna.tf32.f32, which issues at a fraction of the integer rate. A
//   block's 64 rows are 4 warps of 16 with the heads of a KV head packed
//   into them as in the wgmma kernel (G heads at each of 64 / G positions),
//   so one K/V tile serves all of them. Q, K and V stay float32 in shared
//   memory, each value once, rows padded to D + 4 floats so that the 8 rows
//   of every fragment load fall in distinct banks; K and V tiles of 32 keys
//   (64 at D <= 64, or with KS 2 at D 128) are double-buffered by 16-byte
//   cp.async copies, the next loading while this one multiplies. Per tile
//   and warp:
//     S = Q K^T   Q's and K's fragments split as they are loaded (no
//                 operand transposed: K's rows are the product's columns)
//     masks (skipped when every key of the warp's share of the tile is
//     visible to every row of the block), scale, online softmax in float32
//     (-1e30 masks; __expf, ex2.approx of x log2 e, within about |x| 2^-24
//     of expf), quad shuffles, as the other kernels
//     O += P V    P straight from the S accumulators, split in registers:
//                 an accumulator holds columns 2t and 2t+1 where the m16n8k8
//                 A fragment wants k = t and t + 4, so key 2t is taken as
//                 k = t and 2t + 1 as k = t + 4, and V's rows are read in
//                 that order (ptx.cuh)
//   each product's three terms issued across 4 or 8 independent
//   accumulators (mma_3xtf32). Where D <= 128 and the grid of 64-row blocks
//   gives fewer than two blocks an SM (whisper's 96 blocks, cifar10-
//   scorenet's 64), a block is 8 warps (KS 2): the second 4 take the second
//   half of every key tile for the same rows, and the two halves' softmax
//   states are merged through shared memory at the end. Output acc /
//   max(l, 1e-30), as float2 stores. What holds it back and its times:
//   PERF.md, tools/kernel_stages.py.
// * cuda_cores (any other float32: a view whose base is not 16-byte
//   aligned) -> flash_fwd_kernel, the first port, on the CUDA cores: one
//   block of 256 threads (a 16 x 16 grid) owns BQ = 32 query rows and walks
//   key tiles of BK = 32 rows. Per tile:
//     S = Q K^T * scale      each thread 2 x 2 of the 32 x 32 tile, over D
//     mask, row max and row sum by half-warp shuffles (a row's 16 threads
//     are the lanes of one half-warp), online rescale of the accumulator
//     O = alpha O + P V      each thread 2 rows x D/16 columns of O
//   Q, K and V tiles are held in shared memory with a padded row stride
//   (D + 1) so that the 16 rows a warp reads fall in distinct banks; at
//   D = 256 that is 100 KB of dynamic shared memory. The accumulator lives
//   in registers: 2 x D/16 floats a thread (32 at D = 256).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int BQ = 32;        // float32 kernel: query rows per block
constexpr int BK = 32;        // float32 kernel: key rows per tile
constexpr int THREADS = 256;  // float32 kernel: 16 x 16
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
        const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ out, int H, int KV, int sq, int sk, int causal, int window,
        float scale) {
    extern __shared__ float smem[];
    float* qs = smem;                    // BQ x (D + 1)
    float* ks = qs + BQ * (D + 1);       // BK x (D + 1)
    float* vs = ks + BK * (D + 1);       // BK x D
    float* ps = vs + BK * D;             // BQ x (BK + 1)

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q_off = sk - sq;
    const long long q_stride = (long long)H * D;    // between sequence positions
    const long long kv_stride = (long long)KV * D;
    const float* qb = q + ((long long)b * sq * H + h) * D;
    const float* kb = k + ((long long)b * sk * KV + kvh) * D;
    const float* vb = v + ((long long)b * sk * KV + kvh) * D;
    float* ob = out + ((long long)b * sq * H + h) * D;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, d = e % D;
        const int s = q0 + r;
        qs[r * (D + 1) + d] = s < sq ? qb[s * q_stride + d] : 0.f;
    }

    float m[2], l[2], o[2][D / 16];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < D / 16; ++j) o[i][j] = 0.f;
    }

    // keys this tile's queries can see (positions q_off + q0 .. + BQ - 1)
    int k_lo = 0, k_hi = sk;
    if (causal) k_hi = min(sk, q_off + q0 + BQ);
    if (window) k_lo = max(0, q_off + q0 - window + 1);

    for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
        __syncthreads();   // the previous tile's readers are done (and Q is loaded)
        for (int e = tid; e < BK * D; e += THREADS) {
            const int r = e / D, d = e % D;
            const int s = k0 + r;
            const bool in = s < sk;
            ks[r * (D + 1) + d] = in ? kb[s * kv_stride + d] : 0.f;
            vs[r * D + d] = in ? vb[s * kv_stride + d] : 0.f;
        }
        __syncthreads();

        float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            const float a0 = qs[ty * (D + 1) + d], a1 = qs[(ty + 16) * (D + 1) + d];
            const float b0 = ks[tx * (D + 1) + d], b1 = ks[(tx + 16) * (D + 1) + d];
            sc[0][0] += a0 * b0;
            sc[0][1] += a0 * b1;
            sc[1][0] += a1 * b0;
            sc[1][1] += a1 * b1;
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int qpos = q_off + q0 + ty + 16 * i;
            bool ok[2];
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int kpos = k0 + tx + 16 * j;
                ok[j] = kpos < sk;
                if (causal) ok[j] = ok[j] && kpos <= qpos;
                if (window) ok[j] = ok[j] && kpos > qpos - window;
                sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
            // a row's 16 threads are the lanes of one half-warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
                ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
                psum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = alpha * l[i] + psum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < D / 16; ++j) o[i][j] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float p0 = ps[ty * (BK + 1) + c], p1 = ps[(ty + 16) * (BK + 1) + c];
#pragma unroll
            for (int j = 0; j < D / 16; ++j) {
                const float vv = vs[c * D + tx + 16 * j];
                o[0][j] += p0 * vv;
                o[1][j] += p1 * vv;
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
            ob[s * q_stride + tx + 16 * j] = o[i][j] / den;
    }
}


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel

constexpr int MQ = 64;             // query rows per block, 16 a warp
constexpr int MMA_THREADS = 128;   // 4 warps

template <int D>
struct MmaTile {
    static constexpr int BK = D == 256 ? 32 : 64;   // key rows per tile
    static constexpr int LD = D + 8;                // row stride in bf16: 16 bytes of padding
    static constexpr size_t SMEM = sizeof(__nv_bfloat16) * LD * (MQ + 4 * BK);  // Q, 2 x (K, V)
};

// rows [row0, row0 + rows) of one head of a (seq, heads, D) operand into a
// tile of row stride D + 8; rows at or past lim are zeros. vec: every row
// start is 16-byte aligned, so the copies are 16-byte cp.async (else plain
// element stores)
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int rows, int lim,
                                          bool vec) {
    constexpr int LD = D + 8, CH = D / 8;    // 16-byte chunks a row
    if (vec) {
        for (int c = threadIdx.x; c < rows * CH; c += MMA_THREADS) {
            const int r = c / CH, col = (c % CH) * 8;
            const bool in = row0 + r < lim;
            cp_async_16(dst + r * LD + col, in ? src + (row0 + r) * stride + col : src, in);
        }
    } else {
        for (int e = threadIdx.x; e < rows * D; e += MMA_THREADS) {
            const int r = e / D, col = e % D;
            dst[r * LD + col] = row0 + r < lim ? src[(row0 + r) * stride + col]
                                               : __float2bfloat16(0.f);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H, int KV,
        int sq, int sk, int causal, int window, float scale, int vec) {
    constexpr int TK = MmaTile<D>::BK, LD = MmaTile<D>::LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // MQ x LD
    __nv_bfloat16* ks = qs + MQ * LD;                                   // 2 stages x TK x LD
    __nv_bfloat16* vs = ks + 2 * TK * LD;                               // 2 stages x TK x LD

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int q0 = blockIdx.x * MQ;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q_off = sk - sq;
    const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
    const __nv_bfloat16* qb = q + ((long long)b * sq * H + h) * D;
    const __nv_bfloat16* kb = k + ((long long)b * sk * KV + kvh) * D;
    const __nv_bfloat16* vb = v + ((long long)b * sk * KV + kvh) * D;
    __nv_bfloat16* ob = out + ((long long)b * sq * H + h) * D;

    // key tiles this block's queries can see (positions q_off + q0 .. + MQ - 1)
    int k_lo = 0, k_hi = sk;
    if (causal) k_hi = min(sk, q_off + q0 + MQ);
    if (window) k_lo = max(0, q_off + q0 - window + 1);
    const int t_begin = k_lo / TK, t_end = (k_hi + TK - 1) / TK;

    if (t_begin < t_end) {
        load_rows<D>(qs, qb, q_stride, q0, MQ, sq, vec);
        load_rows<D>(ks, kb, kv_stride, t_begin * TK, TK, sk, vec);
        load_rows<D>(vs, vb, kv_stride, t_begin * TK, TK, sk, vec);
        cp_async_commit();
    }

    // this thread's two query rows: g and g + 8 of the warp's 16
    const int qpos[2] = {q_off + q0 + warp * 16 + g, q_off + q0 + warp * 16 + g + 8};
    auto visible = [&](int kpos, int qp) {
        return kpos < sk && (!causal || kpos <= qp) && (!window || kpos > qp - window);
    };
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int kt = t_begin; kt < t_end; ++kt) {
        const int stage = (kt - t_begin) & 1;
        if (kt + 1 < t_end) {   // the next tile loads while this one multiplies
            const int nxt = (stage ^ 1) * TK * LD;
            load_rows<D>(ks + nxt, kb, kv_stride, (kt + 1) * TK, TK, sk, vec);
            load_rows<D>(vs + nxt, vb, kv_stride, (kt + 1) * TK, TK, sk, vec);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* kst = ks + stage * TK * LD;
        const __nv_bfloat16* vst = vs + stage * TK * LD;

        // S = Q K^T: 16 rows x TK keys a warp
        float s[TK / 8][4];
#pragma unroll
        for (int j = 0; j < TK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nb = 0; nb < TK / 16; ++nb) {
                uint32_t bk[4];
                ldmatrix_x4(bk, kst + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                                    + kk * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16_16816(s[2 * nb], a, bk[0], bk[1]);
                mma_bf16_16816(s[2 * nb + 1], a, bk[2], bk[3]);
            }
        }

        // masks, scale, online softmax: element e of tile j is row e / 2,
        // key kt * TK + 8 j + 2 t4 + e % 2; a row's 4 threads are a quad
        const int key0 = kt * TK + 2 * t4;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                s[j][e] = visible(key0 + 8 * j + (e & 1), qpos[r]) ? s[j][e] * scale : NEG_INF;
                mx[r] = fmaxf(mx[r], s[j][e]);
            }
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            mx[r] = fmaxf(m[r], mx[r]);                 // the new running max
            alpha[r] = expf(m[r] - mx[r]);
            m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < TK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const float p = visible(key0 + 8 * j + (e & 1), qpos[r])
                                    ? expf(s[j][e] - m[r]) : 0.f;
                s[j][e] = p;
                psum[r] += p;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = alpha[r] * l[r] + psum[r];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
        }

        // O += P V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
            const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                   pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                   pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                   pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int nb = 0; nb < D / 16; ++nb) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                          + nb * 16 + (lane >> 4) * 8);
                mma_bf16_16816(o[2 * nb], a, bv[0], bv[1]);
                mma_bf16_16816(o[2 * nb + 1], a, bv[2], bv[3]);
            }
        }
        __syncthreads();   // every warp is done with this stage before it refills
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int srow = q0 + warp * 16 + g + 8 * r;
        if (srow >= sq) continue;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(ob + srow * q_stride + 8 * j + 2 * t4) =
                pack_bf16x2(o[j][2 * r] / den, o[j][2 * r + 1] / den);
    }
}


// ---------------------------------------------------------------------------
// bfloat16 on Hopper: the wgmma kernel

// KSPLIT: the two consumer warpgroups share one 64-row Q tile and split its
// key tiles (partial softmax states merged at the end); else each has a Q
// tile of its own (128 rows a block) and both read every K/V stage
template <int D, bool KSPLIT>
struct WgTile {
    static constexpr int NC = 2;                           // consumer warpgroups
    static constexpr int QT = KSPLIT ? 1 : 2;              // 64-row Q tiles a block
    static constexpr int STAGES = D == 64 ? 4 : (D == 128 || KSPLIT ? 3 : 2);
    static constexpr int CH = D / 64;                      // 64-column boxes a row
    static constexpr int BOX = 64 * 128;                   // bytes of a box of 64 rows
    static constexpr int Q_BYTES = CH * BOX;               // a Q tile
    static constexpr int STAGE_BYTES = 2 * CH * BOX;       // K, then V, of 64 keys
    static constexpr int THREADS = 128 * (NC + 1);         // and the producer warpgroup
    // registers a thread: ptxas sizes every warpgroup alike (65536 / 384 =
    // 168); the producer gives back all but 40, the consumers take 232
    static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
    static constexpr size_t SMEM = 1024 + QT * Q_BYTES + STAGES * STAGE_BYTES;
};

template <int D, bool KSPLIT>
__global__ void __launch_bounds__(WgTile<D, KSPLIT>::THREADS, 1) flash_fwd_wgmma_kernel(
        const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
        int H, int KV, int sq, int sk, int causal, int window, float scale, int G) {
    using T = WgTile<D, KSPLIT>;
    constexpr int NC = T::NC, QT = T::QT, STAGES = T::STAGES, CH = T::CH, BOX = T::BOX;
    extern __shared__ unsigned char smem_raw[];
    // the K/V tiles (ptx.cuh's Ring): with KSPLIT tile i is for warpgroup
    // i % 2 alone, which waits on a full barrier of its own; else for both
    __shared__ Ring<STAGES, KSPLIT ? NC : 1> kv;
    __shared__ __align__(8) uint64_t qbar[1];     // the Q tiles have landed
    unsigned char* qs = align_1024(smem_raw);      // QT tiles of CH boxes: 64 rows of Q each
    unsigned char* ring = qs + QT * T::Q_BYTES;    // STAGES x (CH boxes of K, CH of V)

    // a Q tile's 64 rows: G heads (sharing one KV head) at each of 64 / G
    // positions, row r = position p0 + r / G, head h0 + r % G; the block's QT
    // tiles follow one another
    const int npos = 64 / G;
    const int p0 = blockIdx.x * QT * npos;
    const int groups = H / G;
    const int b = blockIdx.y / groups, h0 = (blockIdx.y % groups) * G;
    const int kvh = h0 / (H / KV);
    const int q_off = sk - sq;
    int k_lo = 0, k_hi = sk;
    if (causal) k_hi = min(sk, q_off + min(p0 + QT * npos, sq));
    if (window) k_lo = max(0, q_off + p0 - window + 1);
    const int t_begin = k_lo / 64;
    const int n_tiles = k_hi > k_lo ? (k_hi + 63) / 64 - t_begin : 0;

    if (threadIdx.x == 0) {
        kv.init(128 * QT);
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= 128 * NC) {   // the producer warpgroup: one thread issues every copy
        reg_dealloc<T::PRODUCER_REGS>();
        if (threadIdx.x == 128 * NC && n_tiles > 0) {
            mbar_expect_tx(qbar, QT * T::Q_BYTES);
            for (int qt = 0; qt < QT; ++qt)
                for (int c = 0; c < CH; ++c)
                    tma_load_4d(qs + qt * T::Q_BYTES + c * BOX, &qmap, qbar, 64 * c, h0,
                                p0 + qt * npos, b);
            struct Copy {   // K and V of tile i into its stage, reported to bar
                uint64_t* bar;
                int i;
            };
            auto issue = [&](const Copy& t) {
                unsigned char* st = ring + (t.i % STAGES) * T::STAGE_BYTES;
                const int k0 = (t_begin + t.i) * 64;
                for (int c = 0; c < CH; ++c) {
                    tma_load_4d(st + c * BOX, &kmap, t.bar, 64 * c, kvh, k0, b);
                    tma_load_4d(st + (CH + c) * BOX, &vmap, t.bar, 64 * c, kvh, k0, b);
                }
            };
            HeldCopy<Copy> copies;
            for (int i = 0; i < n_tiles; ++i)
                copies.push(Copy{kv.fill(i, KSPLIT ? i % NC : 0, T::STAGE_BYTES, blockIdx.y), i},
                            issue);
            copies.flush(issue);
        }
        return;
    }

    // consumer warpgroup wg: KSPLIT, the block's key tiles wg, wg + NC, ..
    // of the one Q tile; else every key tile of Q tile wg
    reg_alloc<T::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, ctid = threadIdx.x % 128;
    const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t4 = lane % 4;
    const int r0 = 16 * warp + g;                  // this thread's rows: r0 and r0 + 8
    unsigned char* qw = qs + (KSPLIT ? 0 : wg * T::Q_BYTES);   // this warpgroup's Q tile
    const int pw = KSPLIT ? p0 : p0 + wg * npos;               // and its first position
    int qpos[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qpos[i] = q_off + pw + (r0 + 8 * i) / G;
    // keys this warpgroup's rows can see (only KSPLIT's blocks share them)
    const int w_hi = causal ? q_off + min(pw + npos, sq) : sk;
    const int w_lo = window ? q_off + pw - window + 1 : 0;
    auto visible = [&](int kpos, int qp) {
        return kpos < sk && (!causal || kpos <= qp) && (!window || kpos > qp - window);
    };
    float o[CH][32];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // running max (base 2), denominator
    const float scale2 = scale * 1.4426950408889634f;      // log2 e

    if (n_tiles > 0) mbar_wait(qbar, 0);
    RingPhases ph = 0;
    for (int i = KSPLIT ? wg : 0; i < n_tiles; i += KSPLIT ? NC : 1) {
        kv.wait(i, KSPLIT ? wg : 0, ph, blockIdx.y);
        const unsigned char* ks = ring + (i % STAGES) * T::STAGE_BYTES;
        const unsigned char* vs = ks + CH * BOX;
        const int k0 = (t_begin + i) * 64, key0 = k0 + 2 * t4;
        if (k0 >= w_hi || k0 + 64 <= w_lo) {   // no key of the tile for these rows
            kv.release(i);
            continue;
        }

        // S = Q K^T: 64 rows x 64 keys, k-slices of 16 along D
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(sc, wgmma_desc(qw + (kk / 4) * BOX + (kk % 4) * 32),
                     wgmma_desc(ks + (kk / 4) * BOX + (kk % 4) * 32), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);

        // masks, scale, online softmax in base 2 (scores, maxima and exponents
        // times log2 e, so each exponential is one exp2f: the same function,
        // rounded within a few ulp): sc[4 j + e] is row r0 + 8 (e / 2),
        // key k0 + 8 j + 2 t4 + e % 2; a row's 4 threads are a quad
        // every key of the tile visible to every row of the Q tile: no mask
        const bool whole = k0 + 64 <= sk && (!causal || k0 + 63 <= q_off + pw)
                           && (!window || k0 > q_off + pw + npos - 1 - window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float& v = sc[4 * j + e];
                v = whole || visible(key0 + 8 * j + (e & 1), qpos[r]) ? v * scale2 : NEG_INF;
                mx[r] = fmaxf(mx[r], v);
            }
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            mx[r] = fmaxf(m[r], mx[r]);                 // the new running max
            alpha[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float& v = sc[4 * j + e];
                v = whole || visible(key0 + 8 * j + (e & 1), qpos[r]) ? exp2f(v - m[r]) : 0.f;
                psum[r] += v;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = alpha[r] * l[r] + psum[r];
        }
        if (alpha[0] != 1.f || alpha[1] != 1.f)   // a row maximum moved
#pragma unroll
            for (int c = 0; c < CH; ++c)
#pragma unroll
                for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];

        // O += P V: P, rounded to bf16 once, is the register A operand (the
        // accumulators of n8 tiles 2 kk and 2 kk + 1 are the A fragment of
        // keys 16 kk .. 16 kk + 15); V is MN-major, rows of keys
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
            pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
            pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
            pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) reg_fence(o[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 0; c < CH; ++c)
                wgmma_rs<1>(o[c], pa[kk], wgmma_desc(vs + c * BOX + kk * 16 * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < CH; ++c) reg_fence(o[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
        kv.release(i);
    }

    if constexpr (!KSPLIT) {
        // epilogue: O / max(l, 1e-30) in bf16 into this warpgroup's Q tile,
        // in Q's layout, and out by TMA (rows past Sq are not written)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
            for (int c = 0; c < CH; ++c)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    *reinterpret_cast<uint32_t*>(qw + c * BOX + sw128(r0 + 8 * r, 8 * j + 2 * t4)) =
                        pack_bf16x2(o[c][4 * j + 2 * r] / den, o[c][4 * j + 2 * r + 1] / den);
        }
        fence_proxy_async();
        bar_sync(2 + wg, 128);
        if (ctid == 0) {
            for (int c = 0; c < CH; ++c) tma_store_4d(&omap, qw + c * BOX, 64 * c, h0, pw, b);
            bulk_commit();
            bulk_wait_read();
        }
        return;
    } else {
        // epilogue: the two warpgroups' partial softmax states, merged as the
        // online softmax merges two tiles, each warpgroup merging half of the
        // n8 column tiles (t < 4 CH: warpgroup 0) after swapping the other
        // half through the ring (every copy has landed and been consumed);
        // then O / max(l, 1e-30) in bf16 into the Q tile's place, in Q's
        // layout, and out by TMA (rows past Sq are not written)
        constexpr int HALF = 4 * CH;                   // n8 column tiles a warpgroup merges
        bar_sync(1, 256);
        float* xo = reinterpret_cast<float*>(ring);    // [warpgroup][4 HALF values][128 threads]
        float* xm = xo + 2 * 4 * HALF * 128;           // [warpgroup][64 rows] running maxima
        float* xl = xm + 2 * 64;                       // [warpgroup][64 rows] denominators
        const int give = 1 - wg;                       // the half this warpgroup hands over
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int t = 8 * c + j;
                if ((t >= HALF) != give) continue;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    xo[(wg * 4 * HALF + 4 * (t % HALF) + e) * 128 + ctid] = o[c][4 * j + e];
            }
        if (t4 == 0) {
            xm[wg * 64 + r0] = m[0];
            xm[wg * 64 + r0 + 8] = m[1];
            xl[wg * 64 + r0] = l[0];
            xl[wg * 64 + r0 + 8] = l[1];
        }
        bar_sync(1, 256);
        float a0[2], a1[2], den[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m1 = xm[give * 64 + r0 + 8 * r], mn = fmaxf(m[r], m1);
            a0[r] = exp2f(m[r] - mn);
            a1[r] = exp2f(m1 - mn);
            den[r] = fmaxf(a0[r] * l[r] + a1[r] * xl[give * 64 + r0 + 8 * r], 1e-30f);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int t = 8 * c + j;
                if ((t >= HALF) != wg) continue;
                const float* other = xo + (give * 4 * HALF + 4 * (t % HALF)) * 128 + ctid;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const float v0 = a0[r] * o[c][4 * j + 2 * r] + a1[r] * other[2 * r * 128];
                    const float v1 =
                        a0[r] * o[c][4 * j + 2 * r + 1] + a1[r] * other[(2 * r + 1) * 128];
                    *reinterpret_cast<uint32_t*>(qs + c * BOX + sw128(r0 + 8 * r, 8 * j + 2 * t4)) =
                        pack_bf16x2(v0 / den[r], v1 / den[r]);
                }
            }
        fence_proxy_async();
        bar_sync(1, 256);
        if (threadIdx.x == 0) {
            for (int c = 0; c < CH; ++c) tma_store_4d(&omap, qs + c * BOX, 64 * c, h0, p0, b);
            bulk_commit();
            bulk_wait_read();
        }
    }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: the 3xTF32 kernel

// KS: the block's 64 rows (4 groups of 16, a warp each) once (KS 1, 128
// threads) or twice (KS 2, 256 threads), warp group k taking the k-th half
// of every key tile and the halves' softmax states merged at the end
template <int D, int KS>
struct Tf32Tile {
    static constexpr int THREADS = 128 * KS;
    // key rows a stage, and a warp's share of them: 32 at D 256 (shared
    // memory) and at D 128 with one warp group (two blocks an SM), else 64
    // (32 a warp with two; the launcher takes two only at D <= 128)
    static constexpr int BK = D == 256 || (D == 128 && KS == 1) ? 32 : 64;
    static constexpr int KW = BK / KS;
    static constexpr int LD = D + 4;                 // row stride in floats
    // n8 tiles of O a P V pass: 4 at D 256 (registers) and D 32 (all of them)
    static constexpr int NBG = D == 256 || D == 32 ? 4 : 8;
    static constexpr size_t SMEM = sizeof(float) * LD * (MQ + 4 * BK);   // Q, 2 x (K, V)
};

// rows of a float32 (positions, heads, D) operand into a tile of row stride
// D + 4 by 16-byte cp.async copies, all `threads` of the block: tile row r is
// position p0 + r / G (stride `stride` between positions) of the G heads from
// src on (r % G); positions at or past lim read as zeros
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int p0, int G, int rows, int lim, int threads) {
    constexpr int LD = D + 4, CH = D / 4;   // 16-byte chunks a row
    for (int c = threadIdx.x; c < rows * CH; c += threads) {
        const int r = c / CH, col = (c % CH) * 4;
        const int pos = p0 + r / G;
        const bool in = pos < lim;
        cp_async_16(dst + r * LD + col, in ? src + pos * stride + (r % G) * D + col : src, in);
    }
}

template <int D, int KS>
__global__ void __launch_bounds__(Tf32Tile<D, KS>::THREADS) flash_fwd_tf32x3_kernel(
        const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        float* __restrict__ out, int H, int KV, int sq, int sk, int causal, int window,
        float scale, int G) {
    using T = Tf32Tile<D, KS>;
    constexpr int TK = T::BK, KW = T::KW, LD = T::LD, NB = KW / 8;
    extern __shared__ __align__(16) float smem_f[];
    float* qs = smem_f;              // MQ x LD
    float* ks = qs + MQ * LD;        // 2 stages x TK x LD
    float* vs = ks + 2 * TK * LD;    // 2 stages x TK x LD

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int rg = warp & 3, kh = warp >> 2;   // row group, key half
    // the block's 64 rows: G heads (sharing one KV head) at each of 64 / G
    // positions, row r = position p0 + r / G of head h0 + r % G
    const int npos = MQ / G;
    const int p0 = blockIdx.x * npos, p_last = min(p0 + npos, sq) - 1;
    const int groups = H / G;
    const int b = blockIdx.y / groups, h0 = (blockIdx.y % groups) * G;
    const int kvh = h0 / (H / KV);
    const int q_off = sk - sq;
    const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
    const float* qb = q + ((long long)b * sq * H + h0) * D;
    const float* kb = k + ((long long)b * sk * KV + kvh) * D;
    const float* vb = v + ((long long)b * sk * KV + kvh) * D;

    // key tiles the block's queries can see (positions q_off + p0 .. q_off + p_last)
    int k_lo = 0, k_hi = sk;
    if (causal) k_hi = min(sk, q_off + p_last + 1);
    if (window) k_lo = max(0, q_off + p0 - window + 1);
    const int t_begin = k_lo / TK, t_end = (k_hi + TK - 1) / TK;

    if (t_begin < t_end) {
        load_rows_f32<D>(qs, qb, q_stride, p0, G, MQ, sq, T::THREADS);
        load_rows_f32<D>(ks, kb, kv_stride, t_begin * TK, 1, TK, sk, T::THREADS);
        load_rows_f32<D>(vs, vb, kv_stride, t_begin * TK, 1, TK, sk, T::THREADS);
        cp_async_commit();
    }

    // this thread's two rows: r0 = 16 rg + g and r0 + 8 of the block's 64
    const int r0 = 16 * rg + g;
    const int qpos[2] = {q_off + p0 + r0 / G, q_off + p0 + (r0 + 8) / G};
    auto visible = [&](int kpos, int qp) {
        return kpos < sk && (!causal || kpos <= qp) && (!window || kpos > qp - window);
    };
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int kt = t_begin; kt < t_end; ++kt) {
        const int stage = (kt - t_begin) & 1;
        if (kt + 1 < t_end) {   // the next tile loads while this one multiplies
            const int nxt = (stage ^ 1) * TK * LD;
            load_rows_f32<D>(ks + nxt, kb, kv_stride, (kt + 1) * TK, 1, TK, sk, T::THREADS);
            load_rows_f32<D>(vs + nxt, vb, kv_stride, (kt + 1) * TK, 1, TK, sk, T::THREADS);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        // this warp's KW keys of the tile: k0 ..
        const float* kst = ks + stage * TK * LD + kh * KW * LD;
        const float* vst = vs + stage * TK * LD + kh * KW * LD;
        const int k0 = kt * TK + kh * KW;

        // S = Q K^T: 16 rows x KW keys a warp, k-steps of 8 along D; Q's and
        // K's fragments split into TF32 hi and lo in registers
        float s[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < D / 8; ++kk) {
            const float* qa = qs + r0 * LD + 8 * kk + t4;
            uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
            split_tf32(qa[0], ah[0], al[0]);
            split_tf32(qa[8 * LD], ah[1], al[1]);
            split_tf32(qa[4], ah[2], al[2]);
            split_tf32(qa[8 * LD + 4], ah[3], al[3]);
#pragma unroll
            for (int jn = 0; jn < NB; ++jn) {
                const float* kr = kst + (8 * jn + g) * LD + 8 * kk + t4;   // B[k][n] = K[n][k]
                split_tf32(kr[0], bh[jn][0], bl[jn][0]);
                split_tf32(kr[4], bh[jn][1], bl[jn][1]);
            }
            mma_3xtf32<NB>(s, ah, al, bh, bl);
        }

        // masks (skipped when every key of the warp's share is visible to
        // every row of the block), scale, online softmax: element e of tile j
        // is row r0 + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2; a row's 4
        // threads are a quad
        const bool whole = k0 + KW <= sk && (!causal || k0 + KW - 1 <= q_off + p0)
                           && (!window || k0 > q_off + p_last - window);
        const int key0 = k0 + 2 * t4;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float& x = s[j][e];
                x = whole || visible(key0 + 8 * j + (e & 1), qpos[r]) ? x * scale : NEG_INF;
                mx[r] = fmaxf(mx[r], x);
            }
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            mx[r] = fmaxf(m[r], mx[r]);                 // the new running max
            alpha[r] = __expf(m[r] - mx[r]);
            m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float& x = s[j][e];
                x = whole || visible(key0 + 8 * j + (e & 1), qpos[r]) ? __expf(x - m[r]) : 0.f;
                psum[r] += x;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
            psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
            l[r] = alpha[r] * l[r] + psum[r];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
        }

        // O += P V: P's accumulators of keys 8 kk .. 8 kk + 7 are the A
        // fragment with key 2 t4 at k = t4 and key 2 t4 + 1 at k = t4 + 4, so
        // V's rows are read in that order (b0 from row 2 t4, b1 from 2 t4 + 1);
        // O's n8 tiles NBG at a time
#pragma unroll
        for (int kk = 0; kk < NB; ++kk) {
            uint32_t ph[4], pl[4];
            split_tf32(s[kk][0], ph[0], pl[0]);
            split_tf32(s[kk][2], ph[1], pl[1]);
            split_tf32(s[kk][1], ph[2], pl[2]);
            split_tf32(s[kk][3], ph[3], pl[3]);
            const float* vr = vst + (8 * kk + 2 * t4) * LD + g;
#pragma unroll
            for (int nb0 = 0; nb0 < D / 8; nb0 += T::NBG) {
                uint32_t bh[T::NBG][2], bl[T::NBG][2];
#pragma unroll
                for (int nb = 0; nb < T::NBG; ++nb) {
                    split_tf32(vr[8 * (nb0 + nb)], bh[nb][0], bl[nb][0]);
                    split_tf32(vr[LD + 8 * (nb0 + nb)], bh[nb][1], bl[nb][1]);
                }
                mma_3xtf32<T::NBG>(o + nb0, ph, pl, bh, bl);
            }
        }
        __syncthreads();   // every warp is done with this stage before it refills
    }

    if constexpr (KS == 2) {
        // the two key halves' softmax states, merged as the online softmax
        // merges two tiles: the second half's through the stages (every copy
        // has landed and been read), merged by the first half's warps
        float* xo = ks;                              // [row group][D / 2 values][32 lanes]
        float* xm = xo + 4 * (D / 2) * 32;           // [row group][4][32 lanes]: m, l
        const int slot = rg * 32 + lane;
        if (kh == 1) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) xo[(rg * (D / 2) + 4 * j + e) * 32 + lane] = o[j][e];
            xm[slot * 4 + 0] = m[0];
            xm[slot * 4 + 1] = m[1];
            xm[slot * 4 + 2] = l[0];
            xm[slot * 4 + 3] = l[1];
        }
        __syncthreads();
        if (kh == 1) return;
        float a0[2], a1[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m1 = xm[slot * 4 + r], mn = fmaxf(m[r], m1);
            a0[r] = __expf(m[r] - mn);
            a1[r] = __expf(m1 - mn);
            l[r] = a0[r] * l[r] + a1[r] * xm[slot * 4 + 2 + r];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                o[j][e] = a0[e >> 1] * o[j][e] + a1[e >> 1] * xo[(rg * (D / 2) + 4 * j + e) * 32 + lane];
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r, pos = p0 + row / G;
        if (pos >= sq) continue;
        float* orow = out + (((long long)b * sq + pos) * H + h0 + row % G) * D;
        const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
                make_float2(o[j][2 * r] / den, o[j][2 * r + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// launches

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int sq,
                       int sk, int H, int KV, int causal, int window, float scale,
                       cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), H, KV, sq, sk, causal, window,
        scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int sq,
                       int sk, int H, int KV, int causal, int window, float scale,
                       cudaStream_t stream) {
    const size_t smem = MmaTile<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    const dim3 grid((sq + MQ - 1) / MQ, B * H);
    flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, KV, sq, sk,
        causal, window, scale, vec);
    return cudaGetLastError();
}

template <bool MMA>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* out, int B,
                       int sq, int sk, int H, int KV, int causal, int window, float scale,
                       cudaStream_t st) {
#define FA_LAUNCH(DIM)                                                                     \
    return MMA ? launch_mma<DIM>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st) \
               : launch_f32<DIM>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st)
    switch (D) {
        case 32: FA_LAUNCH(32);
        case 64: FA_LAUNCH(64);
        case 128: FA_LAUNCH(128);
        case 256: FA_LAUNCH(256);
        default: return cudaErrorInvalidValue;
    }
#undef FA_LAUNCH
}


template <int D, bool KSPLIT>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int sq,
                         int sk, int H, int KV, int causal, int window, float scale,
                         cudaStream_t stream) {
    using T = WgTile<D, KSPLIT>;
    // G heads sharing a KV head fill a block's 64 rows together: the
    // largest power of two dividing H / KV, at most 64
    const int n_rep = H / KV;
    const int G = min(n_rep & -n_rep, 64);
    const cuuint64_t es = sizeof(__nv_bfloat16);
    const cuuint64_t qdims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)sq, (cuuint64_t)B};
    const cuuint64_t qstr[3] = {D * es, (cuuint64_t)H * D * es, (cuuint64_t)sq * H * D * es};
    const cuuint32_t qbox[4] = {64, (cuuint32_t)G, (cuuint32_t)(64 / G), 1};
    const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)sk, (cuuint64_t)B};
    const cuuint64_t kstr[3] = {D * es, (cuuint64_t)KV * D * es, (cuuint64_t)sk * KV * D * es};
    const cuuint32_t kbox[4] = {64, 1, 64, 1};
    CUtensorMap qm, km, vm, om;
    if (!bf16_map(&qm, q, 4, qdims, qstr, qbox) || !bf16_map(&km, k, 4, kdims, kstr, kbox)
        || !bf16_map(&vm, v, 4, kdims, kstr, kbox) || !bf16_map(&om, out, 4, qdims, qstr, qbox))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D, KSPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::SMEM);
    if (err != cudaSuccess) return err;
    const int rows = T::QT * (64 / G);   // query positions a block
    const dim3 grid((sq + rows - 1) / rows, B * (H / G));
    flash_fwd_wgmma_kernel<D, KSPLIT><<<grid, T::THREADS, T::SMEM, stream>>>(
        qm, km, vm, om, H, KV, sq, sk, causal, window, scale, G);
    return cudaGetLastError();
}

// blocks of 128 rows (each K/V tile read once for both warpgroups) where
// they fill at least 3/4 of a wave of the card's 132 SMs; else blocks of 64
// rows with the key tiles split between the warpgroups (twice the blocks)
cudaError_t launch_wgmma_dim(int D, const void* q, const void* k, const void* v, void* out,
                             int B, int sq, int sk, int H, int KV, int causal, int window,
                             float scale, cudaStream_t st) {
    const int n_rep = H / KV, G = min(n_rep & -n_rep, 64);
    const bool ksplit = 4LL * ((sq + 128 / G - 1) / (128 / G)) * B * (H / G) < 3 * 132;
#define FA_WG(DIM)                                                                            \
    return ksplit ? launch_wgmma<DIM, true>(q, k, v, out, B, sq, sk, H, KV, causal, window,   \
                                            scale, st)                                       \
                  : launch_wgmma<DIM, false>(q, k, v, out, B, sq, sk, H, KV, causal, window,  \
                                             scale, st)
    switch (D) {
        case 64: FA_WG(64);
        case 128: FA_WG(128);
        case 256: FA_WG(256);
        default: return cudaErrorInvalidValue;
    }
#undef FA_WG
}

template <int D, int KS>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* out, int B, int sq,
                          int sk, int H, int KV, int causal, int window, float scale, int G,
                          cudaStream_t stream) {
    using T = Tf32Tile<D, KS>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32x3_kernel<D, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    const int npos = MQ / G;
    const dim3 grid((sq + npos - 1) / npos, B * (H / G));
    flash_fwd_tf32x3_kernel<D, KS><<<grid, T::THREADS, T::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), H, KV, sq, sk, causal, window,
        scale, G);
    return cudaGetLastError();
}

// two warp groups splitting the key tiles (KS 2) where D <= 128 and the grid
// of 64-row blocks gives fewer than two blocks an SM (whisper's 96 blocks,
// cifar10-scorenet's 64); one elsewhere
cudaError_t launch_tf32x3_dim(int D, const void* q, const void* k, const void* v, void* out,
                              int B, int sq, int sk, int H, int KV, int causal, int window,
                              float scale, cudaStream_t st) {
    // every tile row starts on a 16-byte line (cp.async)
    if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
          | reinterpret_cast<uintptr_t>(v)) & 15) != 0)
        return cudaErrorInvalidValue;
    // G heads sharing a KV head fill a block's 64 rows together: the
    // largest power of two dividing H / KV, at most 64
    const int n_rep = H / KV, G = min(n_rep & -n_rep, MQ);
    int dev = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    const long long blocks = (long long)((sq + MQ / G - 1) / (MQ / G)) * B * (H / G);
    const bool split = D <= 128 && blocks < 2LL * sms;
#define FA_T3(DIM)                                                                          \
    return split ? launch_tf32x3<DIM, 2>(q, k, v, out, B, sq, sk, H, KV, causal, window,     \
                                         scale, G, st)                                      \
                 : launch_tf32x3<DIM, 1>(q, k, v, out, B, sq, sk, H, KV, causal, window,     \
                                         scale, G, st)
    switch (D) {
        case 32: FA_T3(32);
        case 64: FA_T3(64);
        case 128: FA_T3(128);
        case 256:
            return launch_tf32x3<256, 1>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, G,
                                         st);
        default: return cudaErrorInvalidValue;
    }
#undef FA_T3
}

}  // namespace

// route: 0 float32 on the CUDA cores, 1 bfloat16 on mma.sync, 2 bfloat16 on
// wgmma, 3 float32 on the tensor cores (3xTF32). Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int route, int B, int sq, int sk, int H, int KV, int D,
                                   int causal, int window, float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (route) {
        case 0: return launch_dim<false>(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        case 1: return launch_dim<true>(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        case 2: return launch_wgmma_dim(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        case 3: return launch_tf32x3_dim(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        default: return cudaErrorInvalidValue;
    }
}
