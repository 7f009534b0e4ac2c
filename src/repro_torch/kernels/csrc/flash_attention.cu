// K2: blocked online-softmax attention (GQA, causal, sliding window) for
// Hopper, hand-written CUDA C++ built for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::_kernel.
// Same function: q (B, Sq, H, D) and k, v (B, Sk, KV, D) in the JAX
// layouts, query positions offset by Sk - Sq, keys masked by padding,
// causality and the window with -1e30, running max / denominator /
// accumulator in float32, output acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the card: at the shapes the one-shot path gives it
// (gemma-2b: B 4, S 256, H 8, KV 1, D 256, bf16) the function moves 9.4 MB
// and does 2.1 GFLOP, so its least time is the bytes (2.8 us at 3.35 TB/s).
// This first version computes in float32 on the CUDA cores (no tensor
// cores): every product is the exact float32 product the reference forms,
// and the probabilities stay float32 into the PV product, as in the Pallas
// body. So it is bound by float32 issue and shared-memory traffic, far
// above the byte bound; wgmma and TMA are later work.
//
// Design. One block of 256 threads (a 16 x 16 grid) owns BQ = 32 query rows
// of one (batch, head). The KV head is h / (H / KV): K and V are read in
// place, never repeated. The block walks the key tiles of BK = 32 rows that
// its queries can see (tiles wholly outside the causal / window band are
// skipped; they would add nothing). Per tile:
//   S = Q K^T * scale      each thread 2 x 2 of the 32 x 32 tile, over D
//   mask, row max and row sum by half-warp shuffles (a row's 16 threads
//   are the lanes of one half-warp), online rescale of the accumulator
//   O = alpha O + P V      each thread 2 rows x D/16 columns of O
// Q, K and V tiles are held in shared memory as float32 with a padded row
// stride (D + 1) so that the 16 rows a warp reads fall in distinct banks;
// at D = 256 that is 100 KB of dynamic shared memory, so the kernel sets
// cudaFuncAttributeMaxDynamicSharedMemorySize. The accumulator lives in
// registers: 2 x D/16 floats a thread (32 at D = 256).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
        const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        T* __restrict__ out, int H, int KV, int sq, int sk, int causal, int window,
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
    const T* qb = q + ((long long)b * sq * H + h) * D;
    const T* kb = k + ((long long)b * sk * KV + kvh) * D;
    const T* vb = v + ((long long)b * sk * KV + kvh) * D;
    T* ob = out + ((long long)b * sq * H + h) * D;

    for (int e = tid; e < BQ * D; e += THREADS) {
        const int r = e / D, d = e % D;
        const int s = q0 + r;
        qs[r * (D + 1) + d] = s < sq ? to_f32(qb[s * q_stride + d]) : 0.f;
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
            ks[r * (D + 1) + d] = in ? to_f32(kb[s * kv_stride + d]) : 0.f;
            vs[r * D + d] = in ? to_f32(vb[s * kv_stride + d]) : 0.f;
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
            from_f32(o[i][j] / den, &ob[s * q_stride + tx + 16 * j]);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int sq, int sk, int H, int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((sq + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), H, KV, sq, sk, causal, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* out,
                       int B, int sq, int sk, int H, int KV, int causal, int window,
                       float scale, cudaStream_t stream) {
    switch (D) {
        case 32: return launch<T, 32>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, stream);
        case 64: return launch<T, 64>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, stream);
        case 128: return launch<T, 128>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, stream);
        case 256: return launch<T, 256>(q, k, v, out, B, sq, sk, H, KV, causal, window, scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); the caller raises on anything else.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int sq, int sk, int H, int KV, int D,
                                   int causal, int window, float scale, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_dim<float>(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        case 1: return launch_dim<__nv_bfloat16>(D, q, k, v, out, B, sq, sk, H, KV, causal, window, scale, st);
        default: return cudaErrorInvalidValue;
    }
}
