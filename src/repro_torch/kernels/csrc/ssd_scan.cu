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
// y in x's dtype and the final state (Bb, H, P, N) in float32.
//
// What bounds it on the card: at mamba2-2.7b's shape (Bb 4, S 256, H 80,
// P 64, N 128, chunk 256, bf16) the function moves 32.3 MB and needs
// 6.7 GFLOP (the lower triangle of each chunk's L x L products, and the
// two L x P x N products), so its least time is the bytes (9.6 us at
// 3.35 TB/s). This first version computes in float32 on the CUDA cores,
// as the reference does, so it is bound by float32 issue and shared-memory
// traffic; tensor cores are later work.
//
// Design. One block of 256 threads (16 x 16) per (batch, head) walks the
// chunks in order; the state stays in shared memory the whole time, never
// in device memory. B and C rows are read at b = g / H for every head
// (the reference's bc_map), never copied. A chunk of 256 steps would need a
// 256 x 256 float32 score matrix (256 KB, more than a block's 227 KB), so
// each chunk is cut into tiles of 64 steps:
//   1. the chunk's log a and its full inclusive prefix (a block scan in
//      shared memory) before any tile reads it, and exp(cum), exp(cum_L -
//      cum) per step;
//   2. per tile of 64 query rows t: the inter-chunk term (C_t . h) exp(cum_t),
//      then for every key tile u <= t: the 64 x 64 scores C_t . B_u, decayed
//      and masked to u <= t, times x_u; each thread owns 4 x 4 of y's tile;
//   3. the state update over all key tiles, each thread owning 4 x 8 of h.
// All tiles are float32 in shared memory with padded row strides (129, 65)
// so that the rows a warp reads fall in distinct banks: 132 KB of dynamic
// shared memory for P <= 64, N <= 128, L <= 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TILE = 64;        // steps per query or key tile
constexpr int MAXP = 64;        // head dim
constexpr int MAXN = 128;       // state dim
constexpr int MAXL = 256;       // chunk length (== THREADS: one step a thread in the scan)
constexpr int THREADS = 256;    // 16 x 16
constexpr int NS = MAXN + 1;    // padded row stride of h, C and B tiles
constexpr int WS = TILE + 1;    // padded row stride of the score tile

constexpr size_t SMEM_FLOATS =
    MAXP * NS + 2 * TILE * NS + TILE * MAXP + TILE * WS + 3 * MAXL;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
        const T* __restrict__ x, const float* __restrict__ a, const T* __restrict__ Bm,
        const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ state,
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
    const T* xb = x + ((long long)b * S * H + h) * P;
    T* yb = y + ((long long)b * S * H + h) * P;
    const float* ab = a + (long long)b * S * H + h;
    const T* Bb = Bm + (long long)b * S * N;
    const T* Cb = Cm + (long long)b * S * N;
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
            bu[r * NS + n] = (u0 + r < L && s < S) ? to_f32(Bb[(long long)s * N + n]) : 0.f;
        }
        for (int e = tid; e < TILE * P; e += THREADS) {
            const int r = e / P, p = e % P;
            const int s = c0 + u0 + r;
            xu[r * MAXP + p] = (u0 + r < L && s < S) ? to_f32(xb[s * x_stride + p]) : 0.f;
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
                cq[r * NS + n] = (t0 + r < L && s < S) ? to_f32(Cb[(long long)s * N + n]) : 0.f;
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
                    if (p < P) from_f32(acc[i][j], &yb[s * x_stride + p]);
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

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* B, const void* C, void* y,
                   void* state, int Bb, int S, int H, int P, int N, int L,
                   cudaStream_t stream) {
    const size_t smem = SMEM_FLOATS * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<T><<<Bb * H, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(state),
        S, H, P, N, L);
    return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 float32, 1 bfloat16. Limits: P <= 64,
// N <= 128, 1 <= L <= 256. Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* B, const void* C,
                            void* y, void* state, int dtype, int Bb, int S, int H, int P,
                            int N, int L, void* stream) {
    if (P < 1 || P > MAXP || N < 1 || N > MAXN || L < 1 || L > MAXL) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float>(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        case 1: return launch<__nv_bfloat16>(x, a, B, C, y, state, Bb, S, H, P, N, L, st);
        default: return cudaErrorInvalidValue;
    }
}
