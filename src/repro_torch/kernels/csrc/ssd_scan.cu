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
// 6.7 GFLOP (the lower triangle of each chunk's L x L products, and the
// two L x P x N products), so its least time is the bytes (9.6 us at
// 3.35 TB/s).
//
// Two kernels, chosen by the dtype of x, B and C (the `dtype` argument of
// ssd_scan_fwd):
//
// * bfloat16 -> ssd_scan_mma_kernel, on the tensor cores (mma.sync
//   m16n8k16, bf16 in, float32 accumulate). One block of 4 warps per
//   (batch, head). Per chunk: the block scan of log a into cum, then exp(cum)
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
// * float32 -> ssd_scan_kernel, on the CUDA cores. Tensor cores in bf16 or
//   TF32 cannot meet the float32 check (2e-4), so float32 operands keep this
//   kernel: one block of 256 threads (16 x 16) per (batch, head); the state
//   stays in shared memory. A chunk of 256 steps would need a 256 x 256
//   float32 score matrix (256 KB, more than a block's 227 KB), so each chunk
//   is cut into tiles of 64 steps:
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

}  // namespace

// dtype (of x, B, C and y): 0 float32 (the CUDA-core kernel), 1 bfloat16 (the
// tensor-core kernel). Limits: P <= 64, N <= 128, 1 <= L <= 256. Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* B, const void* C,
                            void* y, void* state, int dtype, int Bb, int S, int H, int P,
                            int N, int L, void* stream) {
    if (P < 1 || P > MAXP || N < 1 || N > MAXN || L < 1 || L > MAXL) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_f32(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        case 1: return launch_mma(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        default: return cudaErrorInvalidValue;
    }
}
