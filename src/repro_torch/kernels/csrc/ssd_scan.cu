// K3: Mamba2 SSD chunked scan for Hopper, hand-written CUDA C++ built for
// sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::_kernel. Same
// function, in the JAX layouts: x (Bb, S, H, P), a (Bb, S, H) float32, B and
// C (Bb, S, N) shared by every head. Per chunk of L steps, with the state h
// (P x N, float32) carried from chunk to chunk:
//   cum   = inclusive prefix of log(max(a, 1e-37))
//   y     = (C B^T o tril exp(cum_t - cum_u)) x + (C o exp(cum)) h^T
//   h     = exp(cum_L) h + x^T (B o exp(cum_L - cum))
// Steps past S are the reference's padding (a = 1, x = B = C = 0). Returns
// y in x's dtype and the final state (Bb, H, P, N) in float32. B and C rows
// are read at b = g / H for every head (the reference's bc_map), never
// copied; one block per (batch, head) walks the chunks in order with the
// float32 state on chip, never in device memory.
//
// What bounds it on the card: at mamba2-2.7b's shape (Bb 4, S 256, H 80,
// P 64, N 128, chunk 256, bf16) the function moves 32.3 MB and needs
// 4.1 GFLOP (the lower triangle of each chunk's L x L products, C B^T once
// per batch as B and C carry no head axis, and the two L x P x N products
// per head), so its least time is the bytes (9.6 us at 3.35 TB/s); in
// float32 the operations (24.6 us at 165 TFLOP/s, the tensor cores' TF32
// rate over the three products of 3xTF32).
//
// Four kernels, one per route (the `route` argument of ssd_scan_fwd;
// ssd_scan.py's route() picks it from the operands):
//
// * wgmma (bfloat16 that TMA can describe: base pointers 16-byte aligned, P
//   and N multiples of 8) -> ssd_scan_wgmma_kernel<HG>. Its numerics are the
//   mma_sync kernel's below (the hi/lo splits against exact bf16 operands,
//   exp(cum_t - cum_u) never factored, the 1e-37 clamp, padding with a = 1,
//   the float32 state carried from chunk to chunk, no inter-chunk term on
//   the first chunk), with the prefix of log a and every exponential in
//   base 2 (log2f, exp2f: the same functions, rounded within a few ulp). B
//   and C carry no head axis, so a block owns HG = 2 heads (1 where H is
//   odd) and computes each C_t B_u^T once for both. The work of a (batch,
//   head pair) is cut into items: y of each 64-row query tile (for every
//   chunk), and the state's columns of each 64-column box of B, so mamba2's
//   shape has 4 x 40 x (4 + 2) = 960 items. A block (three warpgroups, as
//   in K2: a producer that keeps 40 registers, two consumers that take 232)
//   is persistent, one an SM, walking items w, w + gridDim.x, ..; its
//   producer thread runs ahead across items, filling a ring of three stages
//   (B of a key tile and x of the heads, by TMA: x through a 4-d map over
//   (P, H, S, Bb), boxes of 64 steps x 64 columns, out-of-range columns
//   read as zeros) and the C tile of each query tile (its own full / empty
//   mbarriers). Both are Rings (ptx.cuh), which keep the barriers' contract:
//   a wait names only its barrier's current phase or the one before it.
//   Each key tile of the ring is for one consumer warpgroup (tile u of a y
//   item for warpgroup u % 2, the pair (tile, head j) of a state item for
//   warpgroup j % 2), which waits on that stage's full barrier of its own;
//   a warpgroup takes its tiles in ring order (u, then j, ascending within
//   an item; items in walk order), which is all the proof in ptx.cuh asks.
//   The C tile is for both warpgroups and each waits for every one, in
//   order. (A stage's consecutive tiles go to different warpgroups, so with
//   one full barrier a stage a warpgroup could wait a phase ahead and pass
//   before its copy landed: a wrong y or a trap in a few hundred launches;
//   tools/kernel_stress.py --diag --shared-full records such a wait.)
//   In a y item the two consumers split the key tiles u <= t:
//     1. scores C_t B_u^T: wgmma m64n64k16 over N, C and B K-major;
//     2. per head, W = scores o exp(cum_t - cum_u) on u <= t, split into
//        bf16 high and low parts in registers, each 16-key group's W
//        computed while the previous group's products run;
//     3. y += W_hi x_u + W_lo x_u: wgmma with W as the register A operand
//        and x MN-major;
//   then warpgroup 1's partial y is added to warpgroup 0's through shared
//   memory and stored. In a state item each consumer takes one head: h +=
//   (x o exp(cum_L - cum))^T B over the chunk's key tiles, the decayed x
//   (from ldmatrix.trans of the swizzled tile) split into high and low
//   parts as the register A operand, B MN-major. Across chunks, each
//   query-tile item keeps its own float32 copy of the state (scratch) for
//   the inter-chunk term C_t (h_hi + h_lo)^T (h split into a swizzled bf16
//   tile, wgmma with C), and the state items write the final state. What
//   holds it at 0.15 of its bound (PERF.md, tools/kernel_stages.py): the W x
//   stage and the merge and store of y.
// * mma_sync (any other bf16) -> ssd_scan_mma_kernel, on the tensor cores
//   (mma.sync m16n8k16, bf16 in, float32 accumulate). One block of 4 warps
//   per (batch, head). Per chunk: the block scan of log a into cum, then exp(cum)
//   and exp(cum_L - cum) per step (float32 in shared memory); then, per
//   query tile of 64 steps (16 rows a warp), for each key tile u <= t:
//     1. scores C_t B_u^T over N, in k-steps of 16 (N below a multiple of
//        16 is zero-padded), C and B by ldmatrix as they are;
//     2. decay exp(cum_t - cum_u) and the causal mask on the accumulators;
//     3. W split into bf16 high and low parts, W_hi = bf16(W) and
//        W_lo = bf16(W - W_hi), used as A fragments in registers;
//     4. y += W_hi x_u + W_lo x_u, x by ldmatrix.trans.
//   The inter-chunk term C_t h^T (skipped on the first chunk, where h is 0)
//   splits h and keeps C exact, and applies exp(cum_t) in float32 after the
//   product. The state update splits the decayed x (x o exp(cum_L - cum))
//   and keeps B exact. One bf16 rounding of W or h would cost about 2^-9
//   of each term; the split leaves about 2^-17 at twice the MMA work, which
//   the byte-bound kernel can spare. (exp(cum_t - cum_u) is never factored
//   as exp(cum_t) exp(-cum_u): exp(-cum) overflows float32 within a chunk.)
//   Tiles stay bf16: C of the query tile, and B and x of the key tile in two
//   stages, the next filled by 16-byte cp.async copies while the current
//   one multiplies, rows padded by 16 bytes for ldmatrix. That is 72 KB of
//   shared memory, so three blocks fit an SM and the 320 blocks of mamba2's
//   shape run in one wave; a sequence of more than one chunk adds the
//   float32 state (33 KB) in shared memory, two blocks an SM.
//
// * tf32x3 (float32 that the bf16 route's conditions hold for: base
//   pointers 16-byte aligned, P and N multiples of 8) ->
//   ssd_scan_tf32x3_kernel<HG>, float32 on the tensor cores in 3xTF32 (one
//   TF32 product misses the float32 check, 2e-4, by far; three meet it):
//   every product on mma.sync m16n8k8 .tf32 with each float32 factor split
//   in registers into hi = tf32(x) and lo = tf32(x - hi) (an integer add
//   and mask, the value of cvt.rna.tf32.f32), taken as lo hi + hi lo + hi
//   hi with float32 accumulators, the three terms issued across 8
//   independent accumulators. The plain version's numerics otherwise: the
//   1e-37 clamp, exp(cum_t - cum_u) never factored, padding with a = 1, the
//   float32 state carried from chunk to chunk (in the state output). A
//   block of 8 warps owns HG = 2 heads of a batch (1 where H is odd) and
//   computes each C_t B_u^T once for both. Tiles are float32 in shared
//   memory at the largest widths (P 64, N 128; the columns past P or N
//   zeros, so every loop has a fixed count), rows padded by 4 floats so
//   that the 8 rows of every fragment load fall in distinct banks; key
//   tiles of 64 steps (B and x of each head) are double-buffered by 16-byte
//   cp.async copies. Per chunk: the prefix of log a per head (a warp scan);
//   y in passes of 128 query rows (C of the pass in shared memory, 16 rows a
//   warp), per key tile at or before a warp's rows:
//     1. scores C_t B_u^T over N (only the n8 key tiles at or before the
//        warp's last row on the diagonal);
//     2. per head, W = scores o exp(cum_t - cum_u) on u <= t, straight from
//        the accumulators as the A fragment (key 2t at k = t, 2t + 1 at
//        k = t + 4, ptx.cuh), x's rows read in that order;
//     3. y += W x_u;
//   and the inter-chunk term exp(cum_t) (C_t h^T) on every chunk but the
//   first. Then the state h = exp(cum_L) h + (x o exp(cum_L - cum))^T B,
//   the decayed x as the A fragment, units of (head, 16 rows of P, 64
//   columns of N) over the warps. A sequence of one chunk (the one-shot
//   path's) is cut into a block for each pass of y and one for the state,
//   which spreads mamba2's 160 head pairs over 480 blocks on the 132 SMs;
//   several chunks run whole in one block. What holds it back and its
//   times: PERF.md, tools/kernel_stages.py.
// * cuda_cores (any other float32: unaligned views, odd widths) ->
//   ssd_scan_kernel, the first port, on the CUDA cores: one block of 256
//   threads (16 x 16) per (batch, head); the state stays in shared memory.
//   A chunk of 256 steps would need a 256 x 256 float32 score matrix (256
//   KB, more than a block's 227 KB), so each chunk is cut into tiles of 64
//   steps:
//   1. the chunk's log a and its full inclusive prefix (a block scan in
//      shared memory) before any tile reads it, and exp(cum), exp(cum_L -
//      cum) per step;
//   2. per tile of 64 query rows t: the inter-chunk term (C_t . h) exp(cum_t),
//      then for every key tile u <= t: the 64 x 64 scores C_t . B_u, decayed
//      and masked to u <= t, times x_u; each thread owns 4 x 4 of y's tile;
//   3. the state update over all key tiles, each thread owning 4 x 8 of h.
//   All tiles are float32 in shared memory with padded row strides (129,
//   65) so that the rows a warp reads fall in distinct banks: 132 KB of
//   dynamic shared memory for P <= 64, N <= 128, L <= 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int TILE = 64;        // steps per query or key tile
constexpr int MAXP = 64;        // head dim
constexpr int MAXN = 128;       // state dim
constexpr int MAXL = 256;       // chunk length (== THREADS: one step a thread in the scan)
constexpr int THREADS = 256;    // float32 kernel: 16 x 16
constexpr int NS = MAXN + 1;    // padded row stride of h, C and B tiles
constexpr int WS = TILE + 1;    // padded row stride of the score tile

constexpr size_t SMEM_FLOATS =
    MAXP * NS + 2 * TILE * NS + TILE * MAXP + TILE * WS + 3 * MAXL;

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
        const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ Bm,
        const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ state,
        int S, int H, int P, int N, int L) {
    extern __shared__ float smem[];
    float* hs = smem;                    // MAXP x NS     state h[p][n]
    float* cq = hs + MAXP * NS;          // TILE x NS     C rows of the query tile
    float* bu = cq + TILE * NS;          // TILE x NS     B rows of the key tile
    float* xu = bu + TILE * NS;          // TILE x MAXP   x rows of the key tile
    float* ws = xu + TILE * MAXP;        // TILE x WS     decayed, masked scores
    float* cum = ws + TILE * WS;         // MAXL          inclusive prefix of log a
    float* ein = cum + MAXL;             // MAXL          exp(cum_t)
    float* eout = ein + MAXL;            // MAXL          exp(cum_L - cum_u)

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const long long x_stride = (long long)H * P;       // between steps of x and y
    const float* xb = x + ((long long)b * S * H + h) * P;
    float* yb = y + ((long long)b * S * H + h) * P;
    const float* ab = a + (long long)b * S * H + h;
    const float* Bb = Bm + (long long)b * S * N;
    const float* Cb = Cm + (long long)b * S * N;
    const int n_tiles = (L + TILE - 1) / TILE;

    // columns past P / N stay zero for the whole run: the loads below write
    // only columns < P / N, and zero columns add nothing to any product
    for (int e = tid; e < MAXP * NS + 2 * TILE * NS + TILE * MAXP; e += THREADS) smem[e] = 0.f;

    // loads rows [u0, u0 + TILE) of the chunk starting at c0 into bu and xu;
    // rows past the chunk or past S are zero
    auto load_key_tile = [&](int c0, int u0) {
        for (int e = tid; e < TILE * N; e += THREADS) {
            const int r = e / N, n = e % N;
            const int s = c0 + u0 + r;
            bu[r * NS + n] = (u0 + r < L && s < S) ? Bb[(long long)s * N + n] : 0.f;
        }
        for (int e = tid; e < TILE * P; e += THREADS) {
            const int r = e / P, p = e % P;
            const int s = c0 + u0 + r;
            xu[r * MAXP + p] = (u0 + r < L && s < S) ? xb[s * x_stride + p] : 0.f;
        }
    };

    for (int c0 = 0; c0 < S; c0 += L) {
        // 1. the chunk's inclusive prefix of log a (Hillis-Steele in shared memory)
        __syncthreads();
        {
            float la = 0.f;
            if (tid < L) {
                const int s = c0 + tid;
                const float av = s < S ? ab[(long long)s * H] : 1.f;
                la = logf(fmaxf(av, 1e-37f));
            }
            cum[tid] = la;
        }
        __syncthreads();
        // over all MAXL entries, so that steps past the chunk hold cum_L
        for (int off = 1; off < MAXL; off <<= 1) {
            const float add = tid >= off ? cum[tid - off] : 0.f;
            __syncthreads();
            cum[tid] += add;
            __syncthreads();
        }
        const float c_last = cum[L - 1];
        ein[tid] = expf(cum[tid]);
        eout[tid] = expf(c_last - cum[tid]);

        // 2. y, one tile of query rows at a time
        for (int qt = 0; qt < n_tiles; ++qt) {
            const int t0 = qt * TILE;
            __syncthreads();   // earlier readers of cq (and of cum, ein) are done
            for (int e = tid; e < TILE * N; e += THREADS) {
                const int r = e / N, n = e % N;
                const int s = c0 + t0 + r;
                cq[r * NS + n] = (t0 + r < L && s < S) ? Cb[(long long)s * N + n] : 0.f;
            }
            __syncthreads();

            // inter-chunk term: (C_t . h_p) * exp(cum_t)
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
            for (int n = 0; n < N; ++n) {
                float cv[4], hv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) cv[i] = cq[(ty + 16 * i) * NS + n];
#pragma unroll
                for (int j = 0; j < 4; ++j) hv[j] = hs[(tx + 16 * j) * NS + n];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * hv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = ein[t0 + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] *= e;
            }

            // intra-chunk term over the key tiles at or before this one
            for (int ut = 0; ut <= qt; ++ut) {
                const int u0 = ut * TILE;
                __syncthreads();   // earlier readers of bu, xu and ws are done
                load_key_tile(c0, u0);
                __syncthreads();
                float sc[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
                for (int n = 0; n < N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) cv[i] = cq[(ty + 16 * i) * NS + n];
#pragma unroll
                    for (int j = 0; j < 4; ++j) bv[j] = bu[(tx + 16 * j) * NS + n];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = t0 + ty + 16 * i;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int u = u0 + tx + 16 * j;
                        ws[(ty + 16 * i) * WS + tx + 16 * j] =
                            u <= t ? sc[i][j] * expf(cum[t] - cum[u]) : 0.f;
                    }
                }
                __syncthreads();
                const int u_len = min(TILE, L - u0);
                for (int u = 0; u < u_len; ++u) {
                    float wv[4], xv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * WS + u];
#pragma unroll
                    for (int j = 0; j < 4; ++j) xv[j] = xu[u * MAXP + tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
                }
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = t0 + ty + 16 * i;
                const int s = c0 + t;
                if (t >= L || s >= S) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int p = tx + 16 * j;
                    if (p < P) yb[s * x_stride + p] = acc[i][j];
                }
            }
        }

        // 3. state: h = exp(cum_L) h + x^T (B o exp(cum_L - cum))
        float hacc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) hacc[i][j] = 0.f;
        for (int ut = 0; ut < n_tiles; ++ut) {
            const int u0 = ut * TILE;
            __syncthreads();
            load_key_tile(c0, u0);
            __syncthreads();
            const int u_len = min(TILE, L - u0);
            for (int u = 0; u < u_len; ++u) {
                const float e = eout[u0 + u];
                float xv[4], bv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) xv[i] = xu[u * MAXP + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 8; ++j) bv[j] = bu[u * NS + tx + 16 * j] * e;
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) hacc[i][j] += xv[i] * bv[j];
            }
        }
        __syncthreads();   // every reader of this chunk's h is done
        const float a_chunk = expf(c_last);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float* hp = &hs[(ty + 16 * i) * NS + tx + 16 * j];
                *hp = *hp * a_chunk + hacc[i][j];
            }
    }

    __syncthreads();
    float* st = state + (long long)blockIdx.x * P * N;
    for (int e = tid; e < P * N; e += THREADS) {
        const int p = e / N, n = e % N;
        st[e] = hs[p * NS + n];
    }
}


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel

constexpr int MMA_THREADS = 128;          // 4 warps
constexpr int LDN = MAXN + 8;             // bf16 row stride of the C and B tiles
constexpr int LDX = MAXP + 8;             // bf16 row stride of the x tiles
constexpr int LDH = MAXN + 4;             // float row stride of the state
constexpr size_t MMA_TILE_BYTES = 2 * (3 * TILE * LDN + 2 * TILE * LDX);   // C, 2 x (B, x)
constexpr size_t MMA_SMEM = MMA_TILE_BYTES + 4 * 3 * MAXL;                 // + cum, exp in / out
constexpr size_t MMA_STATE_BYTES = 4 * MAXP * LDH;    // only when there is more than one chunk

// rows [row0, row0 + TILE) of the chunk that starts at step c0, of an
// operand with `cols` values a step and `stride` between steps, into a tile
// of row stride ld; rows past the chunk or past S are zeros. vec: every row
// start is 16-byte aligned, so the copies are 16-byte cp.async (else plain
// element stores)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long stride, int cols, int c0, int row0, int L,
                                          int S, bool vec) {
    if (vec) {
        const int ch = cols / 8;
        for (int c = threadIdx.x; c < TILE * ch; c += MMA_THREADS) {
            const int r = c / ch, col = (c % ch) * 8;
            const int s = c0 + row0 + r;
            const bool in = row0 + r < L && s < S;
            cp_async_16(dst + r * ld + col, in ? src + s * stride + col : src, in);
        }
    } else {
        for (int e = threadIdx.x; e < TILE * cols; e += MMA_THREADS) {
            const int r = e / cols, col = e % cols;
            const int s = c0 + row0 + r;
            dst[r * ld + col] = row0 + r < L && s < S ? src[s * stride + col]
                                                      : __float2bfloat16(0.f);
        }
    }
}

__global__ void __launch_bounds__(MMA_THREADS, 3) ssd_scan_mma_kernel(
        const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
        const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
        __nv_bfloat16* __restrict__ y, float* __restrict__ state, int S, int H, int P, int N,
        int L, int vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* cq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // TILE x LDN   C rows t
    __nv_bfloat16* bs = cq + TILE * LDN;                                // 2 x TILE x LDN  B rows u
    __nv_bfloat16* xs = bs + 2 * TILE * LDN;                            // 2 x TILE x LDX  x rows u
    float* cum = reinterpret_cast<float*>(smem_raw + MMA_TILE_BYTES);   // MAXL
    float* ein = cum + MAXL;                                            // MAXL  exp(cum_t)
    float* eout = ein + MAXL;                                           // MAXL  exp(cum_L - cum_u)
    float* hs = eout + MAXL;            // MAXP x LDH state, present when S > L
    __shared__ float warp_sum[MMA_THREADS / 32];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const long long x_stride = (long long)H * P;       // between steps of x and y
    const __nv_bfloat16* xb = x + ((long long)b * S * H + h) * P;
    __nv_bfloat16* yb = y + ((long long)b * S * H + h) * P;
    const float* ab = a + (long long)b * S * H + h;
    const __nv_bfloat16* Bb = Bm + (long long)b * S * N;
    const __nv_bfloat16* Cb = Cm + (long long)b * S * N;
    const int n_tiles = (L + TILE - 1) / TILE, n_chunks = (S + L - 1) / L;
    const int nks = (N + 15) / 16;      // k-steps of 16 over the state dim
    const int npt = (P + 7) / 8;        // n8 tiles of y's columns

    // columns past N / P stay zero for the whole run: the loads write only
    // columns < N / P, and zero columns add nothing to any product
    for (int e = tid; e < (int)(MMA_TILE_BYTES / 16); e += MMA_THREADS)
        reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    auto load_keys = [&](int c0, int u0, int stage) {
        load_tile(bs + stage * TILE * LDN, LDN, Bb, N, N, c0, u0, L, S, vec);
        load_tile(xs + stage * TILE * LDX, LDX, xb, x_stride, P, c0, u0, L, S, vec);
    };

    for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * L;
        // 1. the chunk's inclusive prefix of log a, two steps a thread; over
        //    all MAXL entries, so that steps past the chunk hold cum_L
        __syncthreads();
        {
            const int i0 = 2 * tid;
            float v0 = 0.f, v1 = 0.f;
            if (i0 < L && c0 + i0 < S) v0 = logf(fmaxf(ab[(long long)(c0 + i0) * H], 1e-37f));
            if (i0 + 1 < L && c0 + i0 + 1 < S)
                v1 = logf(fmaxf(ab[(long long)(c0 + i0 + 1) * H], 1e-37f));
            float run = v0 + v1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float up = __shfl_up_sync(0xffffffffu, run, off);
                if (lane >= off) run += up;
            }
            if (lane == 31) warp_sum[warp] = run;
            __syncthreads();
            float before = run - (v0 + v1);
            for (int w = 0; w < warp; ++w) before += warp_sum[w];
            cum[i0] = before + v0;
            cum[i0 + 1] = before + v0 + v1;
        }
        __syncthreads();
        const float c_last = cum[L - 1];
        for (int i = tid; i < MAXL; i += MMA_THREADS) {
            ein[i] = expf(cum[i]);
            eout[i] = expf(c_last - cum[i]);
        }
        __syncthreads();

        // 2. y, one tile of 64 query rows at a time, 16 a warp
        for (int qt = 0; qt < n_tiles; ++qt) {
            const int t0 = qt * TILE;
            const int tr[2] = {t0 + warp * 16 + g, t0 + warp * 16 + g + 8};   // in the chunk
            load_tile(cq, LDN, Cb, N, N, c0, t0, L, S, vec);
            load_keys(c0, 0, 0);
            cp_async_commit();
            float acc[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

            for (int ut = 0; ut <= qt; ++ut) {
                const int st = ut & 1;
                if (ut < qt) {   // the next key tile loads while this one multiplies
                    load_keys(c0, (ut + 1) * TILE, st ^ 1);
                    cp_async_commit();
                    cp_async_wait<1>();
                } else {
                    cp_async_wait<0>();
                }
                __syncthreads();
                const __nv_bfloat16* bst = bs + st * TILE * LDN;
                const __nv_bfloat16* xst = xs + st * TILE * LDX;

                if (ut == 0 && c > 0) {   // inter-chunk: exp(cum_t) (C_t h^T), h split
#pragma unroll
                    for (int kk = 0; kk < MAXN / 16; ++kk) {
                        if (kk >= nks) break;
                        uint32_t af[4];
                        ldmatrix_x4(af, cq + (warp * 16 + (lane & 15)) * LDN + kk * 16
                                            + (lane >> 4) * 8);
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            if (j >= npt) break;
                            const float* hr = hs + (j * 8 + g) * LDH + kk * 16 + 2 * t4;
                            uint32_t hi0, lo0, hi1, lo1;
                            split_bf16x2(hr[0], hr[1], hi0, lo0);
                            split_bf16x2(hr[8], hr[9], hi1, lo1);
                            mma_bf16_16816(acc[j], af, hi0, hi1);
                            mma_bf16_16816(acc[j], af, lo0, lo1);
                        }
                    }
                    const float e0 = ein[tr[0]], e1 = ein[tr[1]];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        acc[j][0] *= e0;
                        acc[j][1] *= e0;
                        acc[j][2] *= e1;
                        acc[j][3] *= e1;
                    }
                }

                // on the diagonal tile, warp w's rows see keys of the first w + 1
                // groups of 16 only
                const int nkg = ut == qt ? warp + 1 : TILE / 16;
                float sc[8][4];
#pragma unroll
                for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
                for (int kk = 0; kk < MAXN / 16; ++kk) {   // scores C_t B_u^T over N
                    if (kk >= nks) break;
                    uint32_t af[4];
                    ldmatrix_x4(af, cq + (warp * 16 + (lane & 15)) * LDN + kk * 16
                                        + (lane >> 4) * 8);
#pragma unroll
                    for (int nb = 0; nb < TILE / 16; ++nb) {
                        if (nb >= nkg) break;
                        uint32_t bf[4];
                        ldmatrix_x4(bf, bst + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN
                                            + kk * 16 + ((lane >> 3) & 1) * 8);
                        mma_bf16_16816(sc[2 * nb], af, bf[0], bf[1]);
                        mma_bf16_16816(sc[2 * nb + 1], af, bf[2], bf[3]);
                    }
                }

                const float ct[2] = {cum[tr[0]], cum[tr[1]]};
#pragma unroll
                for (int kg = 0; kg < TILE / 16; ++kg) {   // y += (W_hi + W_lo) x_u
                    if (kg >= nkg) break;
                    uint32_t wh[4], wl[4];
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int j = 2 * kg + half;
                        const int u = ut * TILE + 8 * j + 2 * t4;   // in the chunk
                        const float cu0 = cum[u], cu1 = cum[u + 1];
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
                            const float w0 = u <= tr[r] ? sc[j][2 * r] * expf(ct[r] - cu0) : 0.f;
                            const float w1 =
                                u + 1 <= tr[r] ? sc[j][2 * r + 1] * expf(ct[r] - cu1) : 0.f;
                            split_bf16x2(w0, w1, wh[2 * half + r], wl[2 * half + r]);
                        }
                    }
#pragma unroll
                    for (int nb = 0; nb < MAXP / 16; ++nb) {
                        if (nb * 16 >= P) break;
                        uint32_t bx[4];
                        ldmatrix_x4_trans(bx, xst + (kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                                  * LDX + nb * 16 + (lane >> 4) * 8);
                        mma_bf16_16816(acc[2 * nb], wh, bx[0], bx[1]);
                        mma_bf16_16816(acc[2 * nb], wl, bx[0], bx[1]);
                        mma_bf16_16816(acc[2 * nb + 1], wh, bx[2], bx[3]);
                        mma_bf16_16816(acc[2 * nb + 1], wl, bx[2], bx[3]);
                    }
                }
                __syncthreads();   // every warp is done with this stage (and cq)
            }

#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int s = c0 + tr[r];
                if (tr[r] >= L || s >= S) continue;
                __nv_bfloat16* yr = yb + s * x_stride;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int p = 8 * j + 2 * t4;
                    if (p >= P) break;
                    if ((P & 1) == 0) {
                        *reinterpret_cast<uint32_t*>(yr + p) =
                            pack_bf16x2(acc[j][2 * r], acc[j][2 * r + 1]);
                    } else {
                        yr[p] = __float2bfloat16(acc[j][2 * r]);
                        if (p + 1 < P) yr[p + 1] = __float2bfloat16(acc[j][2 * r + 1]);
                    }
                }
            }
        }

        // 3. state: h = exp(cum_L) h + (x o exp(cum_L - cum))^T B, warp w owning
        //    rows p of 16 w .. 16 w + 15 and every n; the decayed x split
        float hacc[16][4];
#pragma unroll
        for (int j = 0; j < 16; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
        load_keys(c0, 0, 0);
        cp_async_commit();
        for (int ut = 0; ut < n_tiles; ++ut) {
            const int st = ut & 1;
            if (ut + 1 < n_tiles) {
                load_keys(c0, (ut + 1) * TILE, st ^ 1);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const __nv_bfloat16* bst = bs + st * TILE * LDN;
            const __nv_bfloat16* xst = xs + st * TILE * LDX;
            if (warp * 16 < P) {
#pragma unroll
                for (int kg = 0; kg < TILE / 16; ++kg) {
                    const int u = ut * TILE + kg * 16 + 2 * t4;   // in the chunk
                    uint32_t xf[4], ah[4], al[4];
                    ldmatrix_x4_trans(xf, xst + (kg * 16 + (lane & 7) + (lane >> 4) * 8) * LDX
                                              + warp * 16 + ((lane >> 3) & 1) * 8);
                    const float e0 = eout[u], e1 = eout[u + 1], e8 = eout[u + 8], e9 = eout[u + 9];
                    split_bf16x2(bf16_lo(xf[0]) * e0, bf16_hi(xf[0]) * e1, ah[0], al[0]);
                    split_bf16x2(bf16_lo(xf[1]) * e0, bf16_hi(xf[1]) * e1, ah[1], al[1]);
                    split_bf16x2(bf16_lo(xf[2]) * e8, bf16_hi(xf[2]) * e9, ah[2], al[2]);
                    split_bf16x2(bf16_lo(xf[3]) * e8, bf16_hi(xf[3]) * e9, ah[3], al[3]);
#pragma unroll
                    for (int nb = 0; nb < MAXN / 16; ++nb) {
                        if (nb >= nks) break;
                        uint32_t bf[4];
                        ldmatrix_x4_trans(bf, bst + (kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                                  * LDN + nb * 16 + (lane >> 4) * 8);
                        mma_bf16_16816(hacc[2 * nb], ah, bf[0], bf[1]);
                        mma_bf16_16816(hacc[2 * nb], al, bf[0], bf[1]);
                        mma_bf16_16816(hacc[2 * nb + 1], ah, bf[2], bf[3]);
                        mma_bf16_16816(hacc[2 * nb + 1], al, bf[2], bf[3]);
                    }
                }
            }
            __syncthreads();
        }
        const float a_chunk = expf(c_last);
        const bool last = c + 1 == n_chunks;
        float* st_out = state + (long long)blockIdx.x * P * N;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int p = warp * 16 + g + 8 * r;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int n = 8 * j + 2 * t4;
                float h0 = hacc[j][2 * r], h1 = hacc[j][2 * r + 1];
                if (c > 0) {
                    h0 += hs[p * LDH + n] * a_chunk;
                    h1 += hs[p * LDH + n + 1] * a_chunk;
                }
                if (!last) {   // each warp rewrites only its own rows
                    hs[p * LDH + n] = h0;
                    hs[p * LDH + n + 1] = h1;
                } else if (p < P) {
                    if (n < N) st_out[p * N + n] = h0;
                    if (n + 1 < N) st_out[p * N + n + 1] = h1;
                }
            }
        }
    }
}


// ---------------------------------------------------------------------------
// bfloat16 on Hopper: the wgmma kernel

constexpr int WG_BOX = 64 * 128;       // bytes of a TMA box: 64 steps x 64 bf16 columns
constexpr int WG_STAGES = 3;

template <int HG>
struct ScanWg {
    static constexpr int STAGE_BYTES = (2 + HG) * WG_BOX;   // B of a key tile (2 boxes), x of each head
    static constexpr int XACC_BYTES = HG * 64 * 64 * 4;     // warpgroup 1's partial y
    static constexpr int THREADS = 3 * 128;                 // two consumer warpgroups, the producer's
    // registers a thread: ptxas sizes every warpgroup alike (65536 / 384 =
    // 168); the producer gives back all but 40, the consumers take 232
    static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
    // C of the query tile (2 boxes), the ring, the partial y, [h split into
    // high and low parts, 2 boxes each, when S > L], cum / exp(cum) /
    // exp(cum_L - cum)
    static size_t smem(bool chunks) {
        return 1024 + 2 * WG_BOX + WG_STAGES * STAGE_BYTES + XACC_BYTES
               + (chunks ? 4 * WG_BOX : 0) + 3 * HG * MAXL * sizeof(float);
    }
};

// y += (W_hi + W_lo) x over one key tile (64 steps) of one head, W = the
// scores o exp(cum_t - cum_u) on u <= t: each k-group's W (keys 16 kg ..) is
// computed while the previous one's products run (A registers double-
// buffered). cj: the head's cum; tr: the thread's two rows in the chunk;
// u0: the tile's first step in the chunk; xs: the head's x box
__device__ __forceinline__ void decayed_scores_times_x(float (&acc)[32], const float (&sc)[32],
                                                       const float* cj, const int (&tr)[2], int u0,
                                                       const unsigned char* xs, int t4) {
    const float ct[2] = {cj[tr[0]], cj[tr[1]]};
    uint32_t wh[2][4], wl[2][4];
    reg_fence(acc);
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
        const int bf = kg & 1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int jn = 2 * kg + half;
            const int uu = u0 + 8 * jn + 2 * t4;
            const float cu0 = cj[uu], cu1 = cj[uu + 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float w0 = uu <= tr[r] ? sc[4 * jn + 2 * r] * exp2f(ct[r] - cu0) : 0.f;
                const float w1 = uu + 1 <= tr[r] ? sc[4 * jn + 2 * r + 1] * exp2f(ct[r] - cu1) : 0.f;
                split_bf16x2(w0, w1, wh[bf][2 * half + r], wl[bf][2 * half + r]);
            }
        }
        wgmma_fence();
        const uint64_t dx = wgmma_desc(xs + kg * 16 * 128);
        wgmma_rs<1>(acc, wh[bf], dx, 1);
        wgmma_rs<1>(acc, wl[bf], dx, 1);
        wgmma_commit();
        wgmma_wait<1>();      // the previous k-group is done: its registers are free
        reg_fence(wh[bf ^ 1]);
        reg_fence(wl[bf ^ 1]);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(wh[1]);
    reg_fence(wl[1]);
}

template <int HG>
__global__ void __launch_bounds__(ScanWg<HG>::THREADS, 1) ssd_scan_wgmma_kernel(
        const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
        const __grid_constant__ CUtensorMap cmap, const float* __restrict__ a,
        __nv_bfloat16* __restrict__ y, float* __restrict__ state, float* __restrict__ scratch,
        int Bb, int S, int H, int P, int N, int L) {
    constexpr int BOX = WG_BOX, STAGES = WG_STAGES, STAGE_BYTES = ScanWg<HG>::STAGE_BYTES;
    extern __shared__ unsigned char smem_raw[];
    __shared__ Ring<STAGES, 2, 0> kring;   // key tiles, each for one consumer warpgroup
    __shared__ Ring<1, 1, 1> cring;         // C of the query tile, for both
    __shared__ float warp_sum[2][4];
    const int n_chunks = (S + L - 1) / L;
    unsigned char* cq = align_1024(smem_raw);               // C rows of the query tile
    unsigned char* ring = cq + 2 * BOX;                      // STAGES x (B: 2 boxes, x: HG)
    float* xacc = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);   // HG x 32 x 128
    unsigned char* hsplit = reinterpret_cast<unsigned char*>(xacc) + ScanWg<HG>::XACC_BYTES;
    float* cum = reinterpret_cast<float*>(hsplit + (n_chunks > 1 ? 4 * BOX : 0));  // HG x MAXL
    float* ein = cum + HG * MAXL;                            // exp(cum_t)
    float* eout = ein + HG * MAXL;                           // exp(cum_L - cum_u), 0 past L

    // work items, walked by the persistent blocks (w = blockIdx.x, + gridDim.x,
    // ..): per (batch, head group), the state's columns of each box of B
    // (job nq + box) and y of each query tile of every chunk (job < nq), the
    // larger first: the state's boxes, then query tiles nq - 1 .. 0
    const int nq = (L + 63) / 64, nbox = (N + 63) / 64, nks = (N + 15) / 16;
    const int groups = H / HG, n_bg = Bb * groups, n_work = (nq + nbox) * n_bg;
    struct Work {
        int job, b, h0, bx0, nbx;
        bool ytile;
    };
    auto work = [&](int w) {
        const int k = w / n_bg, bg = w % n_bg;
        const int job = k < nbox ? nq + k : nq - 1 - (k - nbox);
        const bool ytile = job < nq;
        return Work{job, bg / groups, (bg % groups) * HG, ytile ? 0 : job - nq, ytile ? nbox : 1,
                    ytile};
    };

    if (threadIdx.x == 0) {
        kring.init(128);
        cring.init(256);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= 256) {   // the producer warpgroup: one thread issues every copy
        reg_dealloc<ScanWg<HG>::PRODUCER_REGS>();
        if (threadIdx.x == 256) {
            // the copies of key tile u of the chunk at c0 into stage s, reported
            // to bar: B's boxes bx0 .. bx0 + nb - 1, and x of heads h0 + j0 ..
            // h0 + j1 - 1 (head j in x slot j - j0) of batch b
            struct Copy {
                uint64_t* bar;
                int s, c0, u, nb, j0, j1, bx0, b, h0;
            };
            auto issue = [&](const Copy& k) {
                unsigned char* st = ring + k.s * STAGE_BYTES;
                for (int bx = k.bx0; bx < k.bx0 + k.nb; ++bx)
                    tma_load_3d(st + bx * BOX, &bmap, k.bar, 64 * bx, k.c0 + 64 * k.u, k.b);
                for (int j = k.j0; j < k.j1; ++j)
                    tma_load_4d(st + (2 + j - k.j0) * BOX, &xmap, k.bar, 0, k.h0 + j,
                                k.c0 + 64 * k.u, k.b);
            };
            HeldCopy<Copy> copies;
            int item = 0, cl = 0;   // key tiles and C tiles filled so far
            for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
                const Work it = work(w);
                // the next item of the key-tile ring, for consumer warpgroup wg
                auto push = [&](int c0, int u, int nb, int j0, int j1, int wg) {
                    uint64_t* bar = kring.fill(item, wg, (nb + j1 - j0) * BOX, w);
                    copies.push(Copy{bar, item % STAGES, c0, u, nb, j0, j1, it.bx0, it.b, it.h0},
                                issue);
                    ++item;
                };
                for (int c = 0; c < n_chunks; ++c) {
                    const int c0 = c * L;
                    if (it.ytile) {
                        copies.flush(issue);
                        uint64_t* bar = cring.fill(cl, 0, nbox * BOX, w);
                        for (int bx = 0; bx < nbox; ++bx)
                            tma_load_3d(cq + bx * BOX, &cmap, bar, 64 * bx, c0 + 64 * it.job, it.b);
                        ++cl;
                        for (int u = 0; u <= it.job; ++u) push(c0, u, nbox, 0, HG, u & 1);
                    }
                    if (!it.ytile || c + 1 < n_chunks)   // the state: (key tile, head) pairs
                        for (int u = 0; u < nq; ++u)
                            for (int j = 0; j < HG; ++j) push(c0, u, it.nbx, j, j + 1, j & 1);
                }
            }
            copies.flush(issue);
        }
        return;
    }

    // consumer warpgroup wg: key tiles u = wg, wg + 2, .. of the query tile
    // (its partial y merged into warpgroup 0's at the end); heads j = wg,
    // wg + 2, .. of the state
    reg_alloc<ScanWg<HG>::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * warp + g;     // this thread's accumulator rows: r0 and r0 + 8
    int item = 0, cl = 0;   // key tiles and C tiles consumed so far
    RingPhases kph = 0, cph = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Work it = work(w);
        const int job = it.job, b = it.b, h0 = it.h0, bx0 = it.bx0, nbx = it.nbx;
        const bool ytile = it.ytile;
        for (int c = 0; c < n_chunks; ++c) {
            const int c0 = c * L;
            // 1. per head: the chunk's inclusive prefix of log a, two steps a
            //    thread, in base 2 (log2 a; every exponential below is then one
            //    exp2f: the same function, rounded within a few ulp); over all
            //    MAXL entries, so that steps past the chunk hold cum_L. Then
            //    exp(cum) and exp(cum_L - cum), the latter 0 past the chunk
            //    (those rows of a key tile belong to the next chunk)
            for (int j = wg; j < HG; j += 2) {
                const float* ah = a + (long long)b * S * H + h0 + j;
                const int i0 = 2 * tid;
                float v0 = 0.f, v1 = 0.f;
                if (i0 < L && c0 + i0 < S) v0 = log2f(fmaxf(ah[(long long)(c0 + i0) * H], 1e-37f));
                if (i0 + 1 < L && c0 + i0 + 1 < S)
                    v1 = log2f(fmaxf(ah[(long long)(c0 + i0 + 1) * H], 1e-37f));
                float run = v0 + v1;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const float up = __shfl_up_sync(0xffffffffu, run, off);
                    if (lane >= off) run += up;
                }
                if (lane == 31) warp_sum[wg][warp] = run;
                bar_sync(2 + wg, 128);
                float before = run - (v0 + v1);
                for (int w = 0; w < warp; ++w) before += warp_sum[wg][w];
                cum[j * MAXL + i0] = before + v0;
                cum[j * MAXL + i0 + 1] = before + v0 + v1;
                bar_sync(2 + wg, 128);   // warp_sum is read before the next head rewrites it
            }
            bar_sync(1, 256);
            for (int i = threadIdx.x; i < HG * MAXL; i += 256) {
                const float c_last = cum[(i / MAXL) * MAXL + L - 1];
                ein[i] = exp2f(cum[i]);
                eout[i] = i % MAXL < L ? exp2f(c_last - cum[i]) : 0.f;
            }
            bar_sync(1, 256);

            if (ytile) {
                // 2. y of query tile `job`, every head of the block
                const int t0 = 64 * job;
                const int tr[2] = {t0 + r0, t0 + r0 + 8};      // in the chunk
                float acc[HG][32];
#pragma unroll
                for (int j = 0; j < HG; ++j)
#pragma unroll
                    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
                cring.wait(cl, 0, cph, w);
                if (c > 0 && wg == 0) {
                    // inter-chunk: exp(cum_t) (C_t h^T), h split into bf16 high and
                    // low parts in the 128-byte swizzle (n along a row), C exact
#pragma unroll
                    for (int j = 0; j < HG; ++j) {
                        const float* hp = scratch + ((long long)(b * H + h0 + j) * nq + job) * P * N;
                        for (int e = tid; e < 64 * 64; e += 128) {
                            const int p = e / 64, n = 2 * (e % 64);
                            float h0v = 0.f, h1v = 0.f;
                            if (p < P && n < N) {
                                h0v = hp[p * N + n];
                                h1v = hp[p * N + n + 1];
                            }
                            uint32_t hi, lo;
                            split_bf16x2(h0v, h1v, hi, lo);
                            const int off = (n / 64) * BOX + sw128(p, n % 64);
                            *reinterpret_cast<uint32_t*>(hsplit + off) = hi;
                            *reinterpret_cast<uint32_t*>(hsplit + 2 * BOX + off) = lo;
                        }
                        fence_proxy_async();
                        bar_sync(2, 128);
                        wgmma_fence();
#pragma unroll
                        for (int part = 0; part < 2; ++part)
#pragma unroll
                            for (int kk = 0; kk < MAXN / 16; ++kk) {
                                if (kk >= nks) break;
                                const int k_off = (kk / 4) * BOX + (kk % 4) * 32;
                                wgmma_ss(acc[j], wgmma_desc(cq + k_off),
                                         wgmma_desc(hsplit + part * 2 * BOX + k_off), 1);
                            }
                        wgmma_commit();
                        wgmma_wait<0>();
                        reg_fence(acc[j]);
                        const float e0 = ein[j * MAXL + tr[0]], e1 = ein[j * MAXL + tr[1]];
#pragma unroll
                        for (int e = 0; e < 32; ++e) acc[j][e] *= (e & 2) ? e1 : e0;
                        bar_sync(2, 128);   // every warp's product has read hsplit
                    }
                }

                for (int u = wg; u <= job; u += 2) {
                    const int k = item + u;
                    kring.wait(k, wg, kph, w);
                    const unsigned char* bs = ring + (k % STAGES) * STAGE_BYTES;
                    // scores C_t B_u^T over N, once for every head of the block
                    float sc[32];
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < MAXN / 16; ++kk) {
                        if (kk >= nks) break;
                        const int k_off = (kk / 4) * BOX + (kk % 4) * 32;
                        wgmma_ss(sc, wgmma_desc(cq + k_off), wgmma_desc(bs + k_off), kk > 0);
                    }
                    wgmma_commit();
                    wgmma_wait<0>();
                    reg_fence(sc);
#pragma unroll
                    for (int j = 0; j < HG; ++j)
                        decayed_scores_times_x(acc[j], sc, cum + j * MAXL, tr, 64 * u,
                                               bs + (2 + j) * BOX, t4);
                    kring.release(k);
                }
                item += job + 1;
                cring.release(cl);
                ++cl;

                // warpgroup 1's partial y into warpgroup 0's, then y out
                if (wg == 1)
#pragma unroll
                    for (int j = 0; j < HG; ++j)
#pragma unroll
                        for (int e = 0; e < 32; ++e) xacc[(j * 32 + e) * 128 + tid] = acc[j][e];
                bar_sync(1, 256);
                if (wg == 0) {
#pragma unroll
                    for (int j = 0; j < HG; ++j)
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
                            const int s = c0 + tr[r];
                            if (tr[r] >= L || s >= S) continue;
                            __nv_bfloat16* yr = y + (((long long)b * S + s) * H + h0 + j) * P;
#pragma unroll
                            for (int jn = 0; jn < 8; ++jn) {
                                const int p = 8 * jn + 2 * t4, e = 4 * jn + 2 * r;
                                if (p >= P) break;
                                *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16x2(
                                    acc[j][e] + xacc[(j * 32 + e) * 128 + tid],
                                    acc[j][e + 1] + xacc[(j * 32 + e + 1) * 128 + tid]);
                            }
                        }
                }
            }

            if (!ytile || c + 1 < n_chunks) {
                // 3. state: h = exp(cum_L) h + (x o exp(cum_L - cum))^T B over the
                //    chunk's key tiles, for B's boxes bx0 .. bx0 + nbx - 1; warp w
                //    owns rows p of 16 w .. 16 w + 15. The decayed x, split into
                //    high and low parts, is the register A operand (each k-group's
                //    while the previous one's products run); B is MN-major. A
                //    query-tile block carries its own copy (scratch) into the next
                //    chunk; a state block's is the output.
                for (int j = wg; j < HG; j += 2) {
                    const float* ej = eout + j * MAXL;
                    float hacc[2][32];
#pragma unroll
                    for (int bi = 0; bi < 2; ++bi)
#pragma unroll
                        for (int e = 0; e < 32; ++e) hacc[bi][e] = 0.f;
                    for (int u = 0; u < nq; ++u) {
                        const int k = item + u * HG + j;
                        kring.wait(k, wg, kph, w);
                        const unsigned char* bs = ring + (k % STAGES) * STAGE_BYTES;
                        const unsigned char* xs = bs + 2 * BOX;
                        uint32_t ah[2][4], al[2][4];
#pragma unroll
                        for (int bi = 0; bi < 2; ++bi) reg_fence(hacc[bi]);
#pragma unroll
                        for (int kg = 0; kg < 4; ++kg) {
                            const int bf = kg & 1;
                            // matrix i: steps 16 kg + 8 (i / 2) .., columns p of
                            // 16 warp + 8 (i % 2) ..; transposed, register i is
                            // the A fragment's a_i
                            uint32_t xf[4];
                            ldmatrix_x4_trans(xf, xs + sw128(kg * 16 + (lane & 7) + (lane >> 4) * 8,
                                                             warp * 16 + ((lane >> 3) & 1) * 8));
                            const int uu = 64 * u + kg * 16 + 2 * t4;   // in the chunk
                            const float e0 = ej[uu], e1 = ej[uu + 1], e8 = ej[uu + 8], e9 = ej[uu + 9];
                            split_bf16x2(bf16_lo(xf[0]) * e0, bf16_hi(xf[0]) * e1, ah[bf][0], al[bf][0]);
                            split_bf16x2(bf16_lo(xf[1]) * e0, bf16_hi(xf[1]) * e1, ah[bf][1], al[bf][1]);
                            split_bf16x2(bf16_lo(xf[2]) * e8, bf16_hi(xf[2]) * e9, ah[bf][2], al[bf][2]);
                            split_bf16x2(bf16_lo(xf[3]) * e8, bf16_hi(xf[3]) * e9, ah[bf][3], al[bf][3]);
                            wgmma_fence();
#pragma unroll
                            for (int bi = 0; bi < 2; ++bi) {
                                if (bi >= nbx) break;
                                const uint64_t db = wgmma_desc(bs + (bx0 + bi) * BOX + kg * 16 * 128);
                                wgmma_rs<1>(hacc[bi], ah[bf], db, 1);
                                wgmma_rs<1>(hacc[bi], al[bf], db, 1);
                            }
                            wgmma_commit();
                            wgmma_wait<1>();   // the previous k-group is done: its registers are free
                            reg_fence(ah[bf ^ 1]);
                            reg_fence(al[bf ^ 1]);
                        }
                        wgmma_wait<0>();
#pragma unroll
                        for (int bi = 0; bi < 2; ++bi) reg_fence(hacc[bi]);
                        reg_fence(ah[1]);
                        reg_fence(al[1]);
                        kring.release(k);
                    }
                    const float a_chunk = exp2f(cum[j * MAXL + L - 1]);
                    float* hp = ytile ? scratch + ((long long)(b * H + h0 + j) * nq + job) * P * N
                                      : state + (long long)(b * H + h0 + j) * P * N;
#pragma unroll
                    for (int bi = 0; bi < 2; ++bi) {
                        if (bi >= nbx) break;
#pragma unroll
                        for (int e = 0; e < 32; ++e) {
                            const int p = r0 + 8 * ((e >> 1) & 1);
                            const int n = 64 * (bx0 + bi) + 8 * (e >> 2) + 2 * t4 + (e & 1);
                            if (p >= P || n >= N) continue;
                            float v = hacc[bi][e];
                            if (c > 0) v += a_chunk * hp[p * N + n];
                            hp[p * N + n] = v;
                        }
                    }
                }
                item += nq * HG;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: the 3xTF32 kernel

constexpr int T3_THREADS = 256;   // 8 warps
constexpr int T3_ROWS = 128;      // query rows a pass, 16 a warp
constexpr int T3_STAGES = 2;      // key tiles in flight
// float32 tiles at the largest widths, the columns past P or N zeros: the
// row strides (MAXN + 4, MAXP + 4) put the 8 rows of every fragment load
// in distinct banks
constexpr int T3_LDN = MAXN + 4, T3_LDX = MAXP + 4;

// floats of dynamic shared memory: C rows of a pass, the ring (B of a key
// tile and x of each head), cum / exp(cum) / exp(cum_L - cum) of each head
template <int HG>
constexpr size_t t3_smem_floats() {
    return (size_t)T3_ROWS * T3_LDN + (size_t)T3_STAGES * TILE * (T3_LDN + HG * T3_LDX)
           + 3 * (size_t)HG * MAXL;
}

// rows [row0, row0 + rows) of the chunk at c0 of a float32 operand (`cols`
// values a step, a multiple of 4; `stride` between steps) into a tile of row
// stride ld by 16-byte cp.async copies; rows past the chunk or past S are zeros
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long stride, int cols, int c0, int row0,
                                              int rows, int L, int S) {
    const int ch = cols / 4;
    for (int c = threadIdx.x; c < rows * ch; c += T3_THREADS) {
        const int r = c / ch, col = (c % ch) * 4;
        const int s = c0 + row0 + r;
        const bool in = row0 + r < L && s < S;
        cp_async_16(dst + r * ld + col, in ? src + s * stride + col : src, in);
    }
}

// the A fragment of 16 rows of a row-major float32 tile (row stride ld) at
// k-step kk (columns 8 kk ..), split into TF32 hi and lo
__device__ __forceinline__ void a_frag_tf32(const float* tile, int ld, int kk, int g, int t4,
                                            uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float* p = tile + g * ld + 8 * kk + t4;
    split_tf32(p[0], ah[0], al[0]);
    split_tf32(p[8 * ld], ah[1], al[1]);
    split_tf32(p[4], ah[2], al[2]);
    split_tf32(p[8 * ld + 4], ah[3], al[3]);
}

// scores C_t B_u^T of a warp's 16 rows against NB n8 tiles of keys, over N
// (k-steps of 8; the columns past N are zeros)
template <int NB>
__device__ __forceinline__ void scores_tf32x3(float (&sc)[8][4], const float* cw, const float* bs,
                                              int g, int t4) {
#pragma unroll 2
    for (int kk = 0; kk < MAXN / 8; ++kk) {
        uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
        a_frag_tf32(cw, T3_LDN, kk, g, t4, ah, al);
#pragma unroll
        for (int jn = 0; jn < NB; ++jn) {
            const float* br = bs + (8 * jn + g) * T3_LDN + 8 * kk + t4;   // B[k][n] = Bm[n][k]
            split_tf32(br[0], bh[jn][0], bl[jn][0]);
            split_tf32(br[4], bh[jn][1], bl[jn][1]);
        }
        mma_3xtf32<NB>(sc, ah, al, bh, bl);
    }
}

template <int HG>
__global__ void __launch_bounds__(T3_THREADS, 1) ssd_scan_tf32x3_kernel(
        const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ Bm,
        const float* __restrict__ Cm, float* __restrict__ y, float* state, int S, int H, int P,
        int N, int L) {
    extern __shared__ __align__(16) float smem_f[];
    __shared__ float warp_sum[T3_THREADS / 32];
    constexpr int LDN = T3_LDN, LDX = T3_LDX, STAGE = TILE * (LDN + HG * LDX);
    float* cq = smem_f;                                 // T3_ROWS x LDN: C rows of the pass
    float* ring = cq + T3_ROWS * LDN;                   // stages: B (TILE x LDN), x of each head (TILE x LDX)
    float* cum = ring + T3_STAGES * STAGE;              // HG x MAXL
    float* ein = cum + HG * MAXL;                       // exp(cum_t)
    float* eout = ein + HG * MAXL;                      // exp(cum_L - cum_u), 0 past L

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int groups = H / HG;
    const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * HG;
    const long long x_stride = (long long)H * P;       // between steps of x and y
    const float* xb = x + ((long long)b * S * H + h0) * P;   // head h0 + j at + j P
    float* yb = y + ((long long)b * S * H + h0) * P;
    const float* Bb = Bm + (long long)b * S * N;
    const float* Cb = Cm + (long long)b * S * N;
    // the state of head h0 + j (P x N) at + j P N: the previous chunk's h
    // while a chunk's y is computed, the final state at the end
    float* hb = state + ((long long)b * H + h0) * P * N;
    const int n_chunks = (S + L - 1) / L, n_kt = (L + TILE - 1) / TILE;
    // a sequence of one chunk is cut into blocks (gridDim.y > 1): block y 0
    // takes y's last pass of 128 rows (the one with the most key tiles), y 1
    // the state, y 2 .. the other passes from the last down; each computes
    // the chunk's cum itself. Several chunks run whole in one block (y needs
    // the previous chunk's state)
    const int n_pass = (L + T3_ROWS - 1) / T3_ROWS;
    const bool do_state = gridDim.y == 1 || blockIdx.y == 1;
    const bool do_y = gridDim.y == 1 || blockIdx.y != 1;
    const int only_pass = gridDim.y == 1 ? -1 : blockIdx.y == 0 ? n_pass - 1 : n_pass - blockIdx.y;

    // columns past N / P stay zero for the whole run: the loads write only
    // columns < N / P, and zero columns add nothing to any product
    for (int e = tid; e < T3_ROWS * LDN + T3_STAGES * STAGE; e += T3_THREADS) smem_f[e] = 0.f;
    __syncthreads();

    // key tile ut of the chunk at c0 (B, and x of every head) into stage st
    auto load_keys = [&](int c0, int ut, int st) {
        float* bs = ring + st * STAGE;
        load_tile_f32(bs, LDN, Bb, N, N, c0, ut * TILE, TILE, L, S);
#pragma unroll
        for (int j = 0; j < HG; ++j)
            load_tile_f32(bs + TILE * LDN + j * TILE * LDX, LDX, xb + j * P, x_stride, P, c0,
                          ut * TILE, TILE, L, S);
    };
    // the next key tile of a walk over tiles 0 .. n - 1 loads while this one
    // multiplies (tile 0 was committed before the walk)
    auto next_keys = [&](int c0, int ut, int n) {
        if (ut + 1 < n) {
            load_keys(c0, ut + 1, (ut + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
    };

    for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * L;
        // 1. per head, the chunk's inclusive prefix of log(max(a, 1e-37)), one
        //    step a thread; over all MAXL entries, so that steps past the chunk
        //    hold cum_L. Then exp(cum) and exp(cum_L - cum)
        __syncthreads();   // the previous chunk's readers of cum, ein, eout are done
        for (int j = 0; j < HG; ++j) {
            float v = 0.f;
            if (tid < L && c0 + tid < S)
                v = logf(fmaxf(a[((long long)b * S + c0 + tid) * H + h0 + j], 1e-37f));
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float up = __shfl_up_sync(0xffffffffu, v, off);
                if (lane >= off) v += up;
            }
            if (lane == 31) warp_sum[warp] = v;
            __syncthreads();
            for (int w = 0; w < warp; ++w) v += warp_sum[w];
            cum[j * MAXL + tid] = v;
            __syncthreads();   // warp_sum is read before the next head rewrites it
        }
        for (int i = tid; i < HG * MAXL; i += T3_THREADS) {
            const float c_last = cum[(i / MAXL) * MAXL + L - 1];
            ein[i] = expf(cum[i]);
            eout[i] = i % MAXL < L ? expf(c_last - cum[i]) : 0.f;
        }
        __syncthreads();

        // 2. y, a pass of 128 query rows at a time, 16 a warp
        for (int t0 = 0; do_y && t0 < L; t0 += T3_ROWS) {
            if (only_pass >= 0 && t0 != only_pass * T3_ROWS) continue;
            const int tw = t0 + 16 * warp;                     // the warp's first row in the chunk
            const int tr[2] = {tw + g, tw + g + 8};            // this thread's rows
            const float* cw = cq + 16 * warp * LDN;            // the warp's C rows
            const int kt_end = (min(L, t0 + T3_ROWS) + TILE - 1) / TILE;   // key tiles of the pass
            const int w_end = tw < L ? min(L - 1, tw + 15) / TILE + 1 : 0;  // and of this warp
            load_tile_f32(cq, LDN, Cb, N, N, c0, t0, T3_ROWS, L, S);
            load_keys(c0, 0, 0);
            cp_async_commit();
            float acc[HG][8][4];
#pragma unroll
            for (int j = 0; j < HG; ++j)
#pragma unroll
                for (int jp = 0; jp < 8; ++jp)
                    acc[j][jp][0] = acc[j][jp][1] = acc[j][jp][2] = acc[j][jp][3] = 0.f;

            for (int ut = 0; ut < kt_end; ++ut) {
                next_keys(c0, ut, kt_end);
                const float* bs = ring + (ut & 1) * STAGE;
                const float* xs = bs + TILE * LDN;

                if (ut == 0 && c > 0 && tw < L) {
                    // inter-chunk: exp(cum_t) (C_t h^T), h the previous chunk's
                    // state (B[k][n] = h[p = n][k], zeros past P or N)
                    for (int kk = 0; kk < MAXN / 8; ++kk) {
                        uint32_t ah[4], al[4], bh[8][2], bl[8][2];
                        a_frag_tf32(cw, LDN, kk, g, t4, ah, al);
#pragma unroll
                        for (int j = 0; j < HG; ++j) {
#pragma unroll
                            for (int jp = 0; jp < 8; ++jp) {
                                const int p = 8 * jp + g, n = 8 * kk + t4;
                                const float* hr = hb + (long long)j * P * N + p * N + n;
                                split_tf32(p < P && n < N ? hr[0] : 0.f, bh[jp][0], bl[jp][0]);
                                split_tf32(p < P && n + 4 < N ? hr[4] : 0.f, bh[jp][1], bl[jp][1]);
                            }
                            mma_3xtf32<8>(acc[j], ah, al, bh, bl);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < HG; ++j) {
                        const float e0 = ein[j * MAXL + tr[0]], e1 = ein[j * MAXL + tr[1]];
#pragma unroll
                        for (int jp = 0; jp < 8; ++jp) {
                            acc[j][jp][0] *= e0;
                            acc[j][jp][1] *= e0;
                            acc[j][jp][2] *= e1;
                            acc[j][jp][3] *= e1;
                        }
                    }
                }

                if (ut < w_end) {
                    // the n8 key tiles with a key at or before the warp's last
                    // row: all 8 below the diagonal, 2, 4, 6 or 8 on it
                    const int nkg = min(8, (tw + 15 - ut * TILE) / 8 + 1);
                    // scores C_t B_u^T over N, once for every head of the block
                    float sc[8][4];
#pragma unroll
                    for (int jn = 0; jn < 8; ++jn) sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
                    if (nkg > 4) scores_tf32x3<8>(sc, cw, bs, g, t4);
                    else scores_tf32x3<4>(sc, cw, bs, g, t4);
                    // per head: y += W x_u, W = scores o exp(cum_t - cum_u) on
                    // u <= t (__expf: ex2.approx of x log2 e, its error about
                    // |x| 2^-24, small where the weight is not). The accumulators of keys 8 kg .. 8 kg + 7 are the A
                    // fragment with key 2 t4 at k = t4 and 2 t4 + 1 at k = t4 + 4,
                    // so x's rows are read in that order
#pragma unroll
                    for (int j = 0; j < HG; ++j) {
                        const float* cj = cum + j * MAXL;
                        const float ct0 = cj[tr[0]], ct1 = cj[tr[1]];
                        const float* xj = xs + j * TILE * LDX;
#pragma unroll
                        for (int kg = 0; kg < 8; ++kg) {
                            if (kg >= nkg) break;
                            const int u = ut * TILE + 8 * kg + 2 * t4;   // in the chunk
                            const float cu0 = cj[u], cu1 = cj[u + 1];
                            uint32_t wh[4], wl[4], bh[8][2], bl[8][2];
                            split_tf32(u <= tr[0] ? sc[kg][0] * __expf(ct0 - cu0) : 0.f, wh[0], wl[0]);
                            split_tf32(u <= tr[1] ? sc[kg][2] * __expf(ct1 - cu0) : 0.f, wh[1], wl[1]);
                            split_tf32(u + 1 <= tr[0] ? sc[kg][1] * __expf(ct0 - cu1) : 0.f, wh[2], wl[2]);
                            split_tf32(u + 1 <= tr[1] ? sc[kg][3] * __expf(ct1 - cu1) : 0.f, wh[3], wl[3]);
                            const float* xr = xj + (8 * kg + 2 * t4) * LDX + g;
#pragma unroll
                            for (int jp = 0; jp < 8; ++jp) {
                                split_tf32(xr[8 * jp], bh[jp][0], bl[jp][0]);
                                split_tf32(xr[LDX + 8 * jp], bh[jp][1], bl[jp][1]);
                            }
                            mma_3xtf32<8>(acc[j], wh, wl, bh, bl);
                        }
                    }
                }
                __syncthreads();   // every warp is done with this stage before it refills
            }

#pragma unroll
            for (int j = 0; j < HG; ++j)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int s = c0 + tr[r];
                    if (tr[r] >= L || s >= S) continue;
                    float* yr = yb + s * x_stride + j * P;
#pragma unroll
                    for (int jp = 0; jp < 8; ++jp) {
                        if (8 * jp >= P) break;
                        *reinterpret_cast<float2*>(yr + 8 * jp + 2 * t4) =
                            make_float2(acc[j][jp][2 * r], acc[j][jp][2 * r + 1]);
                    }
                }
        }

        // 3. state: h = exp(cum_L) h + (x o exp(cum_L - cum))^T B over the
        //    chunk's key tiles. Units of (head j, 16 rows of P, 64 columns of
        //    N), warp w taking units w and w + 8 (2 x 4 x 2 at most); A is the
        //    decayed x (k = t4: step 2 t4, k = t4 + 4: step 2 t4 + 1, as above)
        if (!do_state) continue;
        const int n_pg = (P + 15) / 16, n_ng = (N + 63) / 64, n_units = HG * n_pg * n_ng;
        float hacc[2][8][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
                hacc[i][jn][0] = hacc[i][jn][1] = hacc[i][jn][2] = hacc[i][jn][3] = 0.f;
        load_keys(c0, 0, 0);
        cp_async_commit();
        for (int ut = 0; ut < n_kt; ++ut) {
            next_keys(c0, ut, n_kt);
            const float* bs = ring + (ut & 1) * STAGE;
            const float* xs = bs + TILE * LDN;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int unit = warp + 8 * i;
                if (unit >= n_units) break;
                const int j = unit / (n_pg * n_ng), pg = (unit / n_ng) % n_pg, ng = unit % n_ng;
                const float* ej = eout + j * MAXL + ut * TILE;
                const float* xj = xs + j * TILE * LDX + 16 * pg + g;   // this thread's column p
                const float* bj = bs + 64 * ng + g;
#pragma unroll 2
                for (int ks = 0; ks < TILE / 8; ++ks) {
                    const int u = 8 * ks + 2 * t4;            // in the tile
                    const float e0 = ej[u], e1 = ej[u + 1];
                    uint32_t ah[4], al[4], bh[8][2], bl[8][2];
                    split_tf32(xj[u * LDX] * e0, ah[0], al[0]);
                    split_tf32(xj[u * LDX + 8] * e0, ah[1], al[1]);
                    split_tf32(xj[(u + 1) * LDX] * e1, ah[2], al[2]);
                    split_tf32(xj[(u + 1) * LDX + 8] * e1, ah[3], al[3]);
#pragma unroll
                    for (int jn = 0; jn < 8; ++jn) {
                        split_tf32(bj[u * LDN + 8 * jn], bh[jn][0], bl[jn][0]);
                        split_tf32(bj[(u + 1) * LDN + 8 * jn], bh[jn][1], bl[jn][1]);
                    }
                    mma_3xtf32<8>(hacc[i], ah, al, bh, bl);
                }
            }
            __syncthreads();   // every warp is done with this stage before it refills
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int unit = warp + 8 * i;
            if (unit >= n_units) break;
            const int j = unit / (n_pg * n_ng), pg = (unit / n_ng) % n_pg, ng = unit % n_ng;
            const float a_chunk = ein[j * MAXL + L - 1];   // exp(cum_L)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int p = 16 * pg + g + 8 * (e >> 1), n = 64 * ng + 8 * jn + 2 * t4 + (e & 1);
                    if (p >= P || n >= N) continue;
                    float* hp = hb + (long long)j * P * N + p * N + n;
                    float v = hacc[i][jn][e];
                    if (c > 0) v += *hp * a_chunk;
                    *hp = v;
                }
        }
    }
}

// ---------------------------------------------------------------------------
// launches

cudaError_t launch_f32(const void* x, const void* a, const void* B, const void* C, void* y,
                       void* state, int Bb, int S, int H, int P, int N, int L,
                       cudaStream_t stream) {
    const size_t smem = SMEM_FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<<<Bb * H, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(state),
        S, H, P, N, L);
    return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* a, const void* B, const void* C, void* y,
                       void* state, int Bb, int S, int H, int P, int N, int L,
                       cudaStream_t stream) {
    const size_t smem = MMA_SMEM + (S > L ? MMA_STATE_BYTES : 0);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ssd_scan_mma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    const int vec = N % 8 == 0 && P % 8 == 0
                    && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B)
                         | reinterpret_cast<uintptr_t>(C)) & 15) == 0;
    ssd_scan_mma_kernel<<<Bb * H, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), S, H, P, N, L, vec);
    return cudaGetLastError();
}


template <int HG>
cudaError_t launch_wgmma_hg(const void* x, const void* a, const void* B, const void* C, void* y,
                            void* state, void* scratch, int Bb, int S, int H, int P, int N,
                            int L, cudaStream_t stream) {
    const cuuint64_t es = sizeof(__nv_bfloat16);
    const cuuint64_t xdims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)Bb};
    const cuuint64_t xstr[3] = {P * es, (cuuint64_t)H * P * es, (cuuint64_t)S * H * P * es};
    const cuuint32_t xbox[4] = {64, 1, 64, 1};
    const cuuint64_t bdims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)Bb};
    const cuuint64_t bstr[2] = {N * es, (cuuint64_t)S * N * es};
    const cuuint32_t bbox[3] = {64, 64, 1};
    CUtensorMap xm, bm, cm;
    if (!bf16_map(&xm, x, 4, xdims, xstr, xbox) || !bf16_map(&bm, B, 3, bdims, bstr, bbox)
        || !bf16_map(&cm, C, 3, bdims, bstr, bbox))
        return cudaErrorInvalidValue;
    const size_t smem = ScanWg<HG>::smem(S > L);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_wgmma_kernel<HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    // persistent: one block an SM (the register file holds one), walking the work items
    const int n_work = ((L + 63) / 64 + (N + 63) / 64) * Bb * (H / HG);
    const int blocks = min(n_work, sms);
    ssd_scan_wgmma_kernel<HG><<<blocks, ScanWg<HG>::THREADS, smem, stream>>>(
        xm, bm, cm, static_cast<const float*>(a), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(state), static_cast<float*>(scratch), Bb, S, H, P, N, L);
    return cudaGetLastError();
}

// two heads a block where H is even (C B^T computed once for both), else one
cudaError_t launch_wgmma(const void* x, const void* a, const void* B, const void* C, void* y,
                         void* state, void* scratch, int Bb, int S, int H, int P, int N, int L,
                         cudaStream_t stream) {
    if (S > L && scratch == nullptr) return cudaErrorInvalidValue;
    return H % 2 == 0
               ? launch_wgmma_hg<2>(x, a, B, C, y, state, scratch, Bb, S, H, P, N, L, stream)
               : launch_wgmma_hg<1>(x, a, B, C, y, state, scratch, Bb, S, H, P, N, L, stream);
}

template <int HG>
cudaError_t launch_tf32x3_hg(const void* x, const void* a, const void* B, const void* C, void* y,
                             void* state, int Bb, int S, int H, int P, int N, int L,
                             cudaStream_t stream) {
    const size_t smem = t3_smem_floats<HG>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tf32x3_kernel<HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    // one chunk: a block for each pass of y and one for the state (the kernel's note)
    const dim3 grid(Bb * (H / HG), S <= L ? (L + T3_ROWS - 1) / T3_ROWS + 1 : 1);
    ssd_scan_tf32x3_kernel<HG><<<grid, T3_THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(y), static_cast<float*>(state), S, H,
        P, N, L);
    return cudaGetLastError();
}

// two heads a block where H is even (C B^T computed once for both), else one;
// P and N multiples of 8 and 16-byte aligned bases (the cp.async copies)
cudaError_t launch_tf32x3(const void* x, const void* a, const void* B, const void* C, void* y,
                          void* state, int Bb, int S, int H, int P, int N, int L,
                          cudaStream_t stream) {
    if (P % 8 || N % 8
        || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B)
             | reinterpret_cast<uintptr_t>(C)) & 15) != 0)
        return cudaErrorInvalidValue;
    return H % 2 == 0
               ? launch_tf32x3_hg<2>(x, a, B, C, y, state, Bb, S, H, P, N, L, stream)
               : launch_tf32x3_hg<1>(x, a, B, C, y, state, Bb, S, H, P, N, L, stream);
}

}  // namespace

// route: 0 float32 on the CUDA cores, 1 bfloat16 on mma.sync, 2 bfloat16 on
// wgmma, 3 float32 on the tensor cores (3xTF32). Limits: P <= 64, N <= 128,
// 1 <= L <= 256. scratch: the wgmma kernel's private states when S > L (see
// _scratch_floats in ssd_scan.py), else unused. Returns cudaGetLastError()
// after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* B, const void* C,
                            void* y, void* state, void* scratch, int route, int Bb, int S,
                            int H, int P, int N, int L, void* stream) {
    if (P < 1 || P > MAXP || N < 1 || N > MAXN || L < 1 || L > MAXL) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (route) {
        case 0: return launch_f32(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        case 1: return launch_mma(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        case 2: return launch_wgmma(x, a, B, C, y, state, scratch, Bb, S, H, P, N, L, st);
        case 3: return launch_tf32x3(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        default: return cudaErrorInvalidValue;
    }
}
