// The Mamba2 mixer's pointwise work around K3, as two one-pass kernels for
// Hopper, hand-written CUDA C++ built for sm_90a.
//
// Replaces no TPU kernel: the reference leaves this work to XLA, which fuses
// it. In eager PyTorch it was some thirty kernels a layer, each reading and
// writing a whole (Bb, S, ~d_inner) tensor, two thirds of mamba2-2.7b's
// device time in the one-shot path. Each kernel here reads its inputs once
// and writes its outputs once, with every intermediate in registers.
//
// * ssm_conv_prep_kernel<T, K, V> (the mixer's `pre`): from the xBC and dt
//   columns of the in-projection, read in place through their strides,
//     xBC'  = silu(conv_b + sum_{i<K} conv_w[i] * xBC[t - K + 1 + i])
//             (the depthwise causal convolution, zero history before t = 0,
//             summed in float32 and rounded once to T),
//     xh, B, C = the columns of xBC' (d_inner, N, N), each contiguous in T,
//     a     = exp(softplus(dt + dt_bias) * -exp(A_log))   (float32; softplus
//             with PyTorch's threshold of 20),
//   that is, K3's four operands. A thread owns V channels (4: 8 bytes of
//   bf16 or 16 of float32, where the operands allow; else one) of one batch
//   row and TILE_T time steps: it loads those rows and the K - 1 before them
//   into registers, every load issued before the first sum, then sums each
//   step's K taps from registers. Each input row is read once from memory,
//   plus K - 1 rows a tile (mostly from L2). Short tiles, small blocks and
//   four channels a thread keep many warps resident, which is what sets the
//   time here (at the cell's shape: 38.8 us with 4-step tiles in blocks of
//   128, 40.1 in blocks of 256; 8 steps 48.9, 16 steps 51.8; a thread that
//   walked 64 steps, loading the next 8 while summing the last, 86). The
//   SiLU takes the fast exponential and division: with exact ones the
//   kernel's instructions, not its bytes, set its time (70 us against 52
//   at 16-step tiles). The blocks of a (time tile, batch) share its decays,
//   at most one a thread at the cell's widths.
// * ssm_gated_norm_kernel<T, V, NV, GATE_FIRST> (the mixer's `post`): per
//   token row,
//     v   = y + D[h] * xh
//     out = v * rsqrt(mean(v^2) + eps) * (1 + norm_scale) * silu(z)
//   or, GATE_FIRST (the published Mamba-2 layer's order, granite's),
//     g   = v * silu(z)
//     out = g * rsqrt(mean(g^2) + eps) * (1 + norm_scale)
//   in float32, stored in T; y (K3's output) and xh contiguous, z read in
//   place from the in-projection. One block a row (up to 1024 threads); each
//   thread holds NV vectors of V channels (16 bytes where the operands
//   allow) of v (g) in registers across the sum of squares (warp shuffles,
//   then one shared-memory step), then reads z (before the sum when
//   GATE_FIRST) and the scale and stores. At mamba2's width a thread holds
//   one vector, 640 threads a row; at granite-4.0-h-small's (d_inner 8192)
//   one vector, 1024 threads.
//
// What bounds them on the card: bytes. At mamba2-2.7b's one-shot shape (Bb
// 16, S 256, d_inner 5120, N 128, H 80, bf16) `pre` reads 44.70 MB and
// writes 45.35 MB (90.05 MB, 26.9 us at 3.35 TB/s) and `post` reads 125.83
// MB and writes 41.94 MB (167.77 MB, 50.1 us); neither does more than a few
// operations a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int TILE_T = 4;          // time steps a thread of the conv sums
constexpr int MAX_K = 4;           // the widest causal convolution taken
constexpr int CONV_THREADS = 128;  // at most, a block of the conv
constexpr int NORM_THREADS = 1024; // at most, a block of the norm
constexpr int MAX_NORM_FLOATS = 16; // at most, floats of a row a thread of the norm holds
constexpr int MAX_NORM_NV = 8;      // and at most 8 accesses of them
constexpr float SOFTPLUS_THRESHOLD = 20.f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);                       // round to nearest even
}

// V elements of T moved as one access (16 bytes when V * sizeof(T) is 16)
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ void load(float (&dst)[V], const T* src) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(src);
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = to_f(p.v[e]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const float (&src)[V]) {
    Pack<T, V> p;
#pragma unroll
    for (int e = 0; e < V; ++e) p.v[e] = from_f<T>(src[e]);
    *reinterpret_cast<Pack<T, V>*>(dst) = p;
}

// x sigmoid(x) with the fast exponential and division (a few ulp of float32;
// 0 for x below -87, where the true value is under 1e-36)
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }

template <typename T, int K, int V>
__global__ void __launch_bounds__(CONV_THREADS) ssm_conv_prep_kernel(
        const T* __restrict__ xbc, long long xbc_sb, long long xbc_ss,
        const T* __restrict__ dt, long long dt_sb, long long dt_ss,
        const T* __restrict__ conv_w, const T* __restrict__ conv_b,
        const float* __restrict__ dt_bias, const float* __restrict__ A_log,
        T* __restrict__ xh, T* __restrict__ Bo, T* __restrict__ Co, float* __restrict__ a,
        int S, int d_inner, int N, int H) {
    const int b = blockIdx.z;
    const int t0 = blockIdx.y * TILE_T;
    const int gi = blockIdx.x * blockDim.x + threadIdx.x;
    // the decays of this tile, spread over the threads of its blocks
    for (int i = gi; i < TILE_T * H; i += gridDim.x * blockDim.x) {
        const int t = t0 + i / H, h = i % H;
        if (t >= S) break;
        const float x = to_f(dt[b * dt_sb + t * dt_ss + h]) + dt_bias[h];
        const float sp = x > SOFTPLUS_THRESHOLD ? x : log1pf(expf(x));
        a[((long long)b * S + t) * H + h] = expf(sp * -expf(A_log[h]));
    }
    const int C = d_inner + 2 * N;
    const int c = gi * V;
    if (c >= C) return;
    // every input row of the tile and the K - 1 before it (zeros before t = 0
    // and past S), all loads issued before any use
    const T* src = xbc + b * xbc_sb + c;
    Pack<T, V> rows[K - 1 + TILE_T];
#pragma unroll
    for (int j = 0; j < K - 1 + TILE_T; ++j) {
        const int t = t0 - (K - 1) + j;
        if (t >= 0 && t < S) {
            rows[j] = *reinterpret_cast<const Pack<T, V>*>(src + t * xbc_ss);
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) rows[j].v[e] = from_f<T>(0.f);
        }
    }
    float w[K][V], bias[V];
#pragma unroll
    for (int i = 0; i < K; ++i) load<T, V>(w[i], conv_w + (long long)i * C + c);
    load<T, V>(bias, conv_b + c);
    // where this thread's channels go: xh, B or C, each (Bb, S, width)
    T* dst;
    int width;
    if (c < d_inner) {
        dst = xh + (long long)b * S * d_inner + c, width = d_inner;
    } else if (c < d_inner + N) {
        dst = Bo + (long long)b * S * N + (c - d_inner), width = N;
    } else {
        dst = Co + (long long)b * S * N + (c - d_inner - N), width = N;
    }
#pragma unroll
    for (int j = 0; j < TILE_T; ++j) {
        const int t = t0 + j;
        if (t < S) {
            float out[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                float acc = w[0][e] * to_f(rows[j].v[e]);
#pragma unroll
                for (int i = 1; i < K; ++i) acc += w[i][e] * to_f(rows[j + i].v[e]);
                out[e] = silu(acc + bias[e]);
            }
            store<T, V>(dst + (long long)t * width, out);
        }
    }
}

// the sum of v over the block, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[32] = v;
    }
    __syncthreads();
    return red[32];
}

template <typename T, int V, int NV, bool GATE_FIRST>
__global__ void __launch_bounds__(NORM_THREADS) ssm_gated_norm_kernel(
        const T* __restrict__ y, const T* __restrict__ xh,
        const T* __restrict__ z, long long z_sb, long long z_ss,
        const float* __restrict__ D, const T* __restrict__ scale, T* __restrict__ out,
        int S, int d_inner, int P, float eps) {
    __shared__ float red[33];
    const long long row = blockIdx.x;                 // b * S + s
    const long long b = row / S, s = row % S;
    const T* yr = y + row * d_inner;
    const T* xr = xh + row * d_inner;
    const T* zr = z + b * z_sb + s * z_ss;
    const int nvec = d_inner / V;
    Pack<T, V> yp[NV], xp[NV], zf[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
            yp[k] = *reinterpret_cast<const Pack<T, V>*>(yr + i * V);
            xp[k] = *reinterpret_cast<const Pack<T, V>*>(xr + i * V);
            if constexpr (GATE_FIRST) zf[k] = *reinterpret_cast<const Pack<T, V>*>(zr + i * V);
        }
    }
    float v[NV][V];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
            const float d = D[i * V / P];             // V divides P: one head
#pragma unroll
            for (int e = 0; e < V; ++e) {
                v[k][e] = to_f(yp[k].v[e]) + d * to_f(xp[k].v[e]);
                if constexpr (GATE_FIRST) v[k][e] *= silu(to_f(zf[k].v[e]));
                ss += v[k][e] * v[k][e];
            }
        }
    }
    const float r = rsqrtf(block_sum(ss, red) / d_inner + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int i = threadIdx.x + k * blockDim.x;
        if (i < nvec) {
            const Pack<T, V> sp = *reinterpret_cast<const Pack<T, V>*>(scale + i * V);
            float o[V];
            if constexpr (GATE_FIRST) {
#pragma unroll
                for (int e = 0; e < V; ++e) o[e] = v[k][e] * r * (1.f + to_f(sp.v[e]));
            } else {
                const Pack<T, V> zp = *reinterpret_cast<const Pack<T, V>*>(zr + i * V);
#pragma unroll
                for (int e = 0; e < V; ++e)
                    o[e] = v[k][e] * r * (1.f + to_f(sp.v[e])) * silu(to_f(zp.v[e]));
            }
            store<T, V>(out + row * d_inner + i * V, o);
        }
    }
}

template <typename T, int V>
cudaError_t launch_conv(const void* xbc, long long xbc_sb, long long xbc_ss, const void* dt,
                        long long dt_sb, long long dt_ss, const void* w, const void* bias,
                        const void* dt_bias, const void* A_log, void* xh, void* Bo, void* Co,
                        void* a, int Bb, int S, int d_inner, int N, int H, int K,
                        cudaStream_t st) {
    const int nvec = (d_inner + 2 * N) / V;
    const int nblk = (nvec + CONV_THREADS - 1) / CONV_THREADS;
    const int threads = ((nvec + nblk - 1) / nblk + 31) / 32 * 32;
    const dim3 grid(nblk, (S + TILE_T - 1) / TILE_T, Bb);
#define SSM_CONV_ARGS                                                                        \
    static_cast<const T*>(xbc), xbc_sb, xbc_ss, static_cast<const T*>(dt), dt_sb, dt_ss,     \
        static_cast<const T*>(w), static_cast<const T*>(bias),                               \
        static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),                \
        static_cast<T*>(xh), static_cast<T*>(Bo), static_cast<T*>(Co),                       \
        static_cast<float*>(a), S, d_inner, N, H
    switch (K) {
        case 1: ssm_conv_prep_kernel<T, 1, V><<<grid, threads, 0, st>>>(SSM_CONV_ARGS); break;
        case 2: ssm_conv_prep_kernel<T, 2, V><<<grid, threads, 0, st>>>(SSM_CONV_ARGS); break;
        case 3: ssm_conv_prep_kernel<T, 3, V><<<grid, threads, 0, st>>>(SSM_CONV_ARGS); break;
        case 4: ssm_conv_prep_kernel<T, 4, V><<<grid, threads, 0, st>>>(SSM_CONV_ARGS); break;
        default: return cudaErrorInvalidValue;
    }
#undef SSM_CONV_ARGS
    return cudaGetLastError();
}

template <typename T, int V, int NV>
void launch_norm_nv(const void* y, const void* xh, const void* z, long long z_sb,
                    long long z_ss, const void* D, const void* scale, void* out,
                    unsigned rows, int threads, int S, int d_inner, int P, float eps,
                    bool gate_first, cudaStream_t st) {
#define SSM_NORM_KERNEL_ARGS                                                                 \
    static_cast<const T*>(y), static_cast<const T*>(xh), static_cast<const T*>(z), z_sb,     \
        z_ss, static_cast<const float*>(D), static_cast<const T*>(scale),                    \
        static_cast<T*>(out), S, d_inner, P, eps
    if (gate_first)
        ssm_gated_norm_kernel<T, V, NV, true><<<rows, threads, 0, st>>>(SSM_NORM_KERNEL_ARGS);
    else
        ssm_gated_norm_kernel<T, V, NV, false><<<rows, threads, 0, st>>>(SSM_NORM_KERNEL_ARGS);
#undef SSM_NORM_KERNEL_ARGS
}

// NV as asked where it fits MAX_NORM_FLOATS and MAX_NORM_NV (else 1: a case
// launch_norm refuses)
constexpr int fit(int nv, int v) {
    return nv * v <= MAX_NORM_FLOATS && nv <= MAX_NORM_NV ? nv : 1;
}

// NV, the vectors a thread holds: the fewest that keep a block within
// NORM_THREADS (so d_inner up to 16384 with 16-byte accesses, 8192 without)
template <typename T, int V>
cudaError_t launch_norm(const void* y, const void* xh, const void* z, long long z_sb,
                        long long z_ss, const void* D, const void* scale, void* out, int Bb,
                        int S, int d_inner, int P, float eps, bool gate_first,
                        cudaStream_t st) {
    const int nvec = d_inner / V;
    int nv = 1;
    while (nv * NORM_THREADS < nvec) nv *= 2;
    const long long rows = (long long)Bb * S;
    if (nv * V > MAX_NORM_FLOATS || nv > MAX_NORM_NV || rows > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
#define SSM_NORM_ARGS                                                                        \
    y, xh, z, z_sb, z_ss, D, scale, out, (unsigned)rows, threads, S, d_inner, P, eps,        \
        gate_first, st
    switch (nv) {
        case 1: launch_norm_nv<T, V, fit(1, V)>(SSM_NORM_ARGS); break;
        case 2: launch_norm_nv<T, V, fit(2, V)>(SSM_NORM_ARGS); break;
        case 4: launch_norm_nv<T, V, fit(4, V)>(SSM_NORM_ARGS); break;
        case 8: launch_norm_nv<T, V, fit(8, V)>(SSM_NORM_ARGS); break;
        default: return cudaErrorInvalidValue;
    }
#undef SSM_NORM_ARGS
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. vec: 1 where 16-byte accesses are possible
// (every base pointer 16-byte aligned, every row stride and d_inner and N
// multiples of the elements in 16 bytes; the kernel then reads 4 channels
// at a time), else 0 (one element an access). Strides are in elements; the
// channel stride of xbc and dt is 1.
extern "C" int ssm_conv_prep(const void* xbc, long long xbc_sb, long long xbc_ss,
                             const void* dt, long long dt_sb, long long dt_ss, const void* w,
                             const void* bias, const void* dt_bias, const void* A_log,
                             void* xh, void* Bo, void* Co, void* a, int Bb, int S,
                             int d_inner, int N, int H, int K, int dtype, int vec,
                             void* stream) {
    if (Bb < 1 || Bb > 65535 || S < 1 || d_inner < 1 || N < 1 || H < 1 || K < 1 || K > MAX_K)
        return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return vec ? launch_conv<float, 4>(xbc, xbc_sb, xbc_ss, dt, dt_sb, dt_ss, w, bias,
                                           dt_bias, A_log, xh, Bo, Co, a, Bb, S, d_inner, N,
                                           H, K, st)
                   : launch_conv<float, 1>(xbc, xbc_sb, xbc_ss, dt, dt_sb, dt_ss, w, bias,
                                           dt_bias, A_log, xh, Bo, Co, a, Bb, S, d_inner, N,
                                           H, K, st);
    }
    if (dtype == 1) {
        return vec ? launch_conv<__nv_bfloat16, 4>(xbc, xbc_sb, xbc_ss, dt, dt_sb, dt_ss, w,
                                                   bias, dt_bias, A_log, xh, Bo, Co, a, Bb,
                                                   S, d_inner, N, H, K, st)
                   : launch_conv<__nv_bfloat16, 1>(xbc, xbc_sb, xbc_ss, dt, dt_sb, dt_ss, w,
                                                   bias, dt_bias, A_log, xh, Bo, Co, a, Bb,
                                                   S, d_inner, N, H, K, st);
    }
    return cudaErrorInvalidValue;
}

// dtype and vec as for ssm_conv_prep (vec also needs head_dim P to be a
// multiple of the elements in 16 bytes). y, xh and out are contiguous (Bb,
// S, d_inner); z's channel stride is 1. gate_first: 1 for the gate before
// the norm, else 0.
extern "C" int ssm_gated_norm(const void* y, const void* xh, const void* z, long long z_sb,
                              long long z_ss, const void* D, const void* scale, void* out,
                              int Bb, int S, int d_inner, int P, float eps, int dtype,
                              int vec, int gate_first, void* stream) {
    if (Bb < 1 || S < 1 || d_inner < 1 || P < 1 || d_inner % P) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool gf = gate_first != 0;
    if (dtype == 0) {
        return vec ? launch_norm<float, 4>(y, xh, z, z_sb, z_ss, D, scale, out, Bb, S, d_inner,
                                           P, eps, gf, st)
                   : launch_norm<float, 1>(y, xh, z, z_sb, z_ss, D, scale, out, Bb, S, d_inner,
                                           P, eps, gf, st);
    }
    if (dtype == 1) {
        return vec ? launch_norm<__nv_bfloat16, 8>(y, xh, z, z_sb, z_ss, D, scale, out, Bb, S,
                                                   d_inner, P, eps, gf, st)
                   : launch_norm<__nv_bfloat16, 1>(y, xh, z, z_sb, z_ss, D, scale, out, Bb, S,
                                                   d_inner, P, eps, gf, st);
    }
    return cudaErrorInvalidValue;
}
