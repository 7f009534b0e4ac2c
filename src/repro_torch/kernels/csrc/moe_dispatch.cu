// The MoE layer's dispatch around the experts' products, as four one-pass
// kernels for Hopper, hand-written CUDA C++ built for sm_90a.
//
// Replaces no TPU kernel: the reference (repro.models.layers.moe) leaves the
// routing, the dispatch and the combine to XLA. Added because in eager
// PyTorch the GShard one-hot dispatch built float32 (B, S, k, E, C) products,
// multiplied by one-hot tensors to move rows, and copied the experts' slots
// between (B, E, C, d) and (E, B C, d) and back: three quarters of
// granite-4.0-h-small's device time on the one-shot path, only a third of it
// GEMM. Here each (token, choice) pair is routed once into an expert-major
// slot table laid out (E, B C), the experts' rows are gathered straight into
// the (E, B C, d) layout that the batched products take, and each token
// gathers its k outputs back by slot index. Nothing one-hot is built and
// nothing is transposed.
//
// * moe_route_kernel (one block of 1024 threads a batch row): from the
//   float32 router logits (B, S, E), per token the softmax (max, then the sum
//   of exp(l - max)), the top k taken on the logits in the order (larger
//   logit, then lower expert), each pick found as the best logit after the
//   previous pick in that order (no chosen set kept), the chosen gates
//   renormalised to sum 1, and the logsumexp. A tile of 128 tokens' logits
//   is staged in shared memory expert-major, each token on 8 lanes of a
//   warp, lane q over experts q, q + 8, ...: each lane's max, best pick and
//   sum of its experts, then the 8 lanes' by shuffles. The work is k E
//   comparisons a token, in a block per row, so it is spread over a block's
//   32 warps: with one thread a token (4 warps a block) the route took
//   0.118-0.125 ms at granite's shape on an H100 SXM (0.058 so), each
//   warp's dependent chain of comparisons alone on its scheduler. Each
//   choice sets its bit in a (E, S / 32) mask in shared memory; after the
//   row, a prefix of the mask's popcounts per expert gives each pair its
//   place in its expert's queue
//   (the earlier tokens of the row that chose that expert: the reference's
//   token-major-then-choice place, since one token's choices are distinct
//   experts). A place below the capacity C keeps the pair in slot e B C + b
//   C + place of the table, which holds its token's row b S + s; the other
//   slots hold -1. The per-expert gate sums of the row are summed by fixed
//   groups of threads in a fixed order, so every result is the same on
//   every run.
// * moe_gather_kernel: xin (E B C, d) = x's rows through the table, zero rows
//   for empty slots, a warp a slot, in 16-byte accesses where the rows allow.
//   Its stores stream out evict-first, so that x's rows (33.5 MB at
//   granite's shape, each read by about eight slots) stay in L2 while the
//   415 MB of slots go out: 0.214 ms against 0.225 with plain stores on an
//   H100 SXM, 0.62 of the bound that counts x once. A block a slot, or
//   eight loads held in flight a lane before their stores, read the same.
// * moe_glu_kernel: silu(g) h in float32 from the up and gate products,
//   stored in their dtype (the plain route's formula, with an exact
//   exponential and division).
// * moe_combine_kernel (one block a token): out = sum_k w_k out_e[slot_k]
//   over the kept pairs, the gates in float32, summed in float32 in choice
//   order, plus an optional addend (the shared expert's output), rounded
//   once to the output's dtype.
//
// What bounds them on the card: bytes, but for the route, whose bytes are
// few and whose k E comparisons a token run in one block a row. At
// granite-4.0-h-small's one-shot shape (B 16, S 256, E 72, k 10, C 44, d
// 4096, f 768, bf16) the route reads 1.18 MB of logits, the gather writes
// 415.24 MB and reads at most 33.55 MB (0.134 ms at 3.35 TB/s), the GLU
// moves 233.57 MB (0.070 ms) and the combine reads the kept slots' rows,
// about 335 MB, and writes 33.55 MB (0.110 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROUTE_TOKENS = 128;    // tokens of a route block's logits tile
constexpr int ROUTE_LANES = 8;       // threads of a token, each over every 8th expert
constexpr int ROUTE_THREADS = ROUTE_TOKENS * ROUTE_LANES;
// a tile row's floats: 4 (mod 32) so that the 4 tokens x 8 lanes of a warp
// read 32 distinct banks
constexpr int TILE_STRIDE = ROUTE_TOKENS + 4;
constexpr int FILL = 8;              // loads a route thread keeps in flight filling a tile
constexpr int GATHER_WARPS = 8;      // slots a gather block copies, one a warp
constexpr int ROW_THREADS = 128;     // at most, a block of the combine
constexpr int GLU_THREADS = 256;
constexpr int MAX_SMEM = 232448;     // the most dynamic shared memory a block can have

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);                       // round to nearest even
}

// V elements of T moved as one access (16 bytes when V * sizeof(T) is 16)
template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// whether logit a at expert ia comes before b at ib: the larger logit, then
// the lower expert
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
    return a > b || (a == b && ia < ib);
}

// whether (a, ia) is a candidate before (b, ib): an expert (ia >= 0), and b
// none (ib < 0) or after it in the order of before()
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
    return ia >= 0 && (ib < 0 || before(a, ia, b, ib));
}

// the dynamic shared memory of a route block: the logits tile (E rows of
// TILE_STRIDE), the choice mask (E x W words), the places' prefix (E x (W +
// 1)), the gate sums' partials (G x E) and the row's choices (S x K 16-bit
// experts)
long long route_smem(int E, int W, int G, int S, int K) {
    return 4LL * ((long long)E * TILE_STRIDE + (long long)E * W + (long long)E * (W + 1)
                  + (long long)G * E)
           + ((2LL * S * K + 3) / 4) * 4;
}

__global__ void __launch_bounds__(ROUTE_THREADS) moe_route_kernel(
        const float* __restrict__ logits, int S, int E, int K, int C, int B,
        long long* __restrict__ gate_idx, float* __restrict__ gate_vals,
        int* __restrict__ pos, int* __restrict__ slot, int* __restrict__ table,
        float* __restrict__ gate_sum, int* __restrict__ kept, float* __restrict__ lse) {
    extern __shared__ float smem[];
    constexpr int T = ROUTE_TOKENS, L = ROUTE_LANES, NT = ROUTE_THREADS, ST = TILE_STRIDE;
    constexpr unsigned FULL = 0xffffffffu;
    const int W = (S + 31) / 32;
    const int G = E >= NT ? 1 : NT / E;                // groups of threads summing the gates
    float* tile = smem;                                 // [E][ST]: logits, then gates
    unsigned* mask = reinterpret_cast<unsigned*>(tile + E * ST);         // [E][W]
    int* prefix = reinterpret_cast<int*>(mask + E * W);                  // [E][W + 1]
    float* partial = reinterpret_cast<float*>(prefix + E * (W + 1));     // [G][E]
    short* choice = reinterpret_cast<short*>(partial + G * E);           // [S][K]
    const int b = blockIdx.x, tid = threadIdx.x;
    const int t = tid / L, q = tid % L;                 // the thread's tile token, its lane
    const long long BC = (long long)B * C;
    for (int i = tid; i < E * W; i += NT) mask[i] = 0u;
    for (int i = tid; i < G * E; i += NT) partial[i] = 0.f;
    // thread (gg, ge) sums the gates of experts ge, ge + NT, ... (one group) or
    // of expert ge over the tile tokens gg, gg + G, ... (G groups of E)
    const int gg = E >= NT ? 0 : tid / E, ge = E >= NT ? tid : tid % E;
    for (int s0 = 0; s0 < S; s0 += T) {
        const int nt = min(T, S - s0);
        const float* src = logits + ((long long)b * S + s0) * E;
        __syncthreads();                                // the last tile's readers are done
        // the tile's nt E logits, FILL loads in flight a thread before their stores
        for (int i0 = tid; i0 < nt * E; i0 += FILL * NT) {
            float v[FILL];
#pragma unroll
            for (int u = 0; u < FILL; ++u) {
                const int i = i0 + u * NT;
                v[u] = i < nt * E ? src[i] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < FILL; ++u) {
                const int i = i0 + u * NT;
                if (i < nt * E) tile[(i % E) * ST + i / E] = v[u];
            }
        }
        __syncthreads();
        // token t of the tile on its L lanes, lane q over experts q, q + L, ...;
        // a part tile's idle tokens compute alongside (their lanes take part in
        // the shuffles) and write nothing
        const bool valid = t < nt;
        const int s = s0 + t;
        const long long row = (long long)b * S + s;
        float* l = tile + t;                            // expert e at l[e * ST]
        float m = -INFINITY;
        for (int e = q; e < E; e += L) m = fmaxf(m, l[e * ST]);
        for (int o = L / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        // the top K in the order of before(): each the first after the last,
        // each lane's best of its experts, then the best of the lanes'
        float pv = 0.f;
        int pi = -1;
        for (int j = 0; j < K; ++j) {
            float bv = 0.f;
            int bi = -1;
            for (int e = q; e < E; e += L) {
                const float v = l[e * ST];
                if ((pi < 0 || before(pv, pi, v, e)) && better(v, e, bv, bi)) bv = v, bi = e;
            }
            for (int o = L / 2; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(FULL, bv, o);
                const int oi = __shfl_xor_sync(FULL, bi, o);
                if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
            }
            if (valid && q == 0) {
                gate_idx[row * K + j] = bi;
                choice[s * K + j] = (short)bi;
                atomicOr(&mask[bi * W + (s >> 5)], 1u << (s & 31));
            }
            pv = bv, pi = bi;
        }
        // the softmax in place of the logits, and the logsumexp
        float z = 0.f;
        for (int e = q; e < E; e += L) {
            const float x = expf(l[e * ST] - m);
            l[e * ST] = x;
            z += x;
        }
        for (int o = L / 2; o > 0; o >>= 1) z += __shfl_xor_sync(FULL, z, o);
        for (int e = q; e < E; e += L) l[e * ST] /= z;
        if (valid && q == 0) lse[row] = m + logf(z);
        __syncwarp();                                   // the token's gates and choices are in
        // the chosen gates, renormalised to sum 1 (every lane sums them in order)
        if (valid) {
            float gs = 0.f;
            for (int j = 0; j < K; ++j) gs += l[choice[s * K + j] * ST];
            for (int j = q; j < K; j += L)
                gate_vals[row * K + j] = l[choice[s * K + j] * ST] / gs;
        }
        __syncthreads();
        if (gg < G) {
            for (int e = ge; e < E; e += E >= NT ? NT : E) {
                float a = partial[gg * E + e];
                for (int u = gg; u < nt; u += G) a += tile[e * ST + u];
                partial[gg * E + e] = a;
            }
        }
    }
    __syncthreads();
    // each expert's prefix of popcounts over the row's 32-token words, its
    // kept count and gate sum (the groups' partials in order)
    for (int e = tid; e < E; e += NT) {
        int run = 0;
        for (int w = 0; w < W; ++w) {
            prefix[e * (W + 1) + w] = run;
            run += __popc(mask[e * W + w]);
        }
        prefix[e * (W + 1) + W] = run;
        kept[b * E + e] = min(run, C);
        float a = 0.f;
        for (int g = 0; g < G; ++g) a += partial[g * E + e];
        gate_sum[b * E + e] = a;
    }
    __syncthreads();
    // each pair's place, slot and table entry
    for (int s = tid; s < S; s += NT) {
        const long long row = (long long)b * S + s;
        const int w = s >> 5;
        const unsigned below = (1u << (s & 31)) - 1u;
        for (int j = 0; j < K; ++j) {
            const int e = choice[s * K + j];
            const int p = prefix[e * (W + 1) + w] + __popc(mask[e * W + w] & below);
            pos[row * K + j] = p;
            if (p < C) {
                const long long at = e * BC + (long long)b * C + p;
                slot[row * K + j] = (int)at;
                table[at] = (int)row;
            } else {
                slot[row * K + j] = -1;
            }
        }
    }
    // the row's empty slots (a place at or past the expert's count)
    for (int i = tid; i < E * C; i += NT) {
        const int e = i / C, p = i % C;
        if (p >= prefix[e * (W + 1) + W]) table[e * BC + (long long)b * C + p] = -1;
    }
}

// rows of U units (16, 4 or 2 bytes), a warp a row: out[r] = src[idx[r]],
// zeros where idx[r] < 0
template <typename U>
__global__ void __launch_bounds__(GATHER_WARPS * 32) moe_gather_kernel(
        const U* __restrict__ x, const int* __restrict__ table, U* __restrict__ xin, int n,
        long long n_slots) {
    const long long r = (long long)blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
    if (r >= n_slots) return;
    const int lane = threadIdx.x % 32;
    const int src = table[r];
    U* dst = xin + r * n;
    // the slots stream out with evict-first stores, so that x's rows, read
    // about k times each, stay in L2
    if (src < 0) {
        const U zero{};
        for (int i = lane; i < n; i += 32) __stcs(dst + i, zero);
        return;
    }
    const U* row = x + (long long)src * n;
#pragma unroll 4   // four loads in flight before their stores
    for (int i = lane; i < n; i += 32) __stcs(dst + i, row[i]);
}

// silu(g) h in float32, the plain route's formula (exact exponential and
// division: the values agree with it bitwise or to one rounding)
template <typename T, int V>
__global__ void __launch_bounds__(GLU_THREADS) moe_glu_kernel(
        const T* __restrict__ h, const T* __restrict__ g, T* __restrict__ out, long long n) {
    for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V; i < n;
         i += (long long)gridDim.x * blockDim.x * V) {
        const Pack<T, V> hp = *reinterpret_cast<const Pack<T, V>*>(h + i);
        const Pack<T, V> gp = *reinterpret_cast<const Pack<T, V>*>(g + i);
        Pack<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const float gv = to_f(gp.v[e]);
            o.v[e] = from_f<T>(gv / (1.f + expf(-gv)) * to_f(hp.v[e]));
        }
        *reinterpret_cast<Pack<T, V>*>(out + i) = o;
    }
}

// out[t] = sum_j w[t, j] out_e[slot[t, j]] (+ add[t]) over the kept pairs, in
// float32, rounded once
template <typename T, int V>
__global__ void __launch_bounds__(ROW_THREADS) moe_combine_kernel(
        const T* __restrict__ out_e, const int* __restrict__ slot,
        const float* __restrict__ w, const T* __restrict__ add, T* __restrict__ out, int d,
        int K) {
    const long long t = blockIdx.x;
    const int* sl = slot + t * K;
    const float* wt = w + t * K;
    for (int i = threadIdx.x * V; i < d; i += blockDim.x * V) {
        float acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        for (int j = 0; j < K; ++j) {
            const int s = sl[j];
            if (s < 0) continue;
            const float wj = wt[j];
            const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(out_e + (long long)s * d + i);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += wj * to_f(p.v[e]);
        }
        if (add != nullptr) {
            const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(add + t * d + i);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += to_f(p.v[e]);
        }
        Pack<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e) o.v[e] = from_f<T>(acc[e]);
        *reinterpret_cast<Pack<T, V>*>(out + t * d + i) = o;
    }
}

int row_threads(long long units) {
    return (int)(units >= ROW_THREADS ? ROW_THREADS : (units + 31) / 32 * 32);
}

template <typename T, int V>
cudaError_t launch_glu(const void* h, const void* g, void* out, long long n, cudaStream_t st) {
    const long long units = n / V;
    const long long blocks = (units + GLU_THREADS - 1) / GLU_THREADS;
    const unsigned grid = (unsigned)(blocks < 132LL * 16 ? blocks : 132LL * 16);
    moe_glu_kernel<T, V><<<grid, GLU_THREADS, 0, st>>>(
        static_cast<const T*>(h), static_cast<const T*>(g), static_cast<T*>(out), n);
    return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_combine(const void* out_e, const void* slot, const void* w, const void* add,
                           void* out, long long rows, int d, int K, cudaStream_t st) {
    moe_combine_kernel<T, V><<<(unsigned)rows, row_threads(d / V), 0, st>>>(
        static_cast<const T*>(out_e), static_cast<const int*>(slot),
        static_cast<const float*>(w), static_cast<const T*>(add), static_cast<T*>(out), d, K);
    return cudaGetLastError();
}

}  // namespace

// logits (B, S, E) float32 contiguous. Writes gate_idx (B, S, K) int64,
// gate_vals (B, S, K) float32, pos and slot (B, S, K) int32 (slot -1 for a
// dropped pair), table (E, B C) int32 (-1 for an empty slot), gate_sum and
// kept (B, E) float32 and int32, lse (B, S) float32. K <= E, C <= S.
extern "C" int moe_route(const void* logits, int B, int S, int E, int K, int C, void* gate_idx,
                         void* gate_vals, void* pos, void* slot, void* table, void* gate_sum,
                         void* kept, void* lse, void* stream) {
    if (B < 1 || S < 1 || E < 1 || E > 32767 || K < 1 || K > E || C < 1 || C > S
        || (long long)B * S * K > 0x7fffffffLL || (long long)E * B * C > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    const int W = (S + 31) / 32, G = E >= ROUTE_THREADS ? 1 : ROUTE_THREADS / E;
    const long long smem = route_smem(E, W, G, S, K);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            moe_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    moe_route_kernel<<<B, ROUTE_THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), S, E, K, C, B, static_cast<long long*>(gate_idx),
        static_cast<float*>(gate_vals), static_cast<int*>(pos), static_cast<int*>(slot),
        static_cast<int*>(table), static_cast<float*>(gate_sum), static_cast<int*>(kept),
        static_cast<float*>(lse));
    return cudaGetLastError();
}

// x: rows of row_bytes (a multiple of 2); table: n_slots row indices of x or
// -1. vec: 16 where x, xin and row_bytes are 16-byte aligned, 4 where
// 4-byte, else 2: the bytes an access moves.
extern "C" int moe_gather(const void* x, const void* table, void* xin, long long n_slots,
                          long long row_bytes, int vec, void* stream) {
    if (n_slots < 1 || n_slots > 0x7fffffffLL || row_bytes < 2 || row_bytes % vec
        || row_bytes / vec > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n = (int)(row_bytes / vec);
    const unsigned grid = (unsigned)((n_slots + GATHER_WARPS - 1) / GATHER_WARPS);
    const int* tb = static_cast<const int*>(table);
    constexpr int threads = GATHER_WARPS * 32;
    switch (vec) {
        case 16: moe_gather_kernel<uint4><<<grid, threads, 0, st>>>(
                     static_cast<const uint4*>(x), tb, static_cast<uint4*>(xin), n, n_slots);
                 break;
        case 4: moe_gather_kernel<unsigned><<<grid, threads, 0, st>>>(
                    static_cast<const unsigned*>(x), tb, static_cast<unsigned*>(xin), n,
                    n_slots);
                break;
        case 2: moe_gather_kernel<unsigned short><<<grid, threads, 0, st>>>(
                    static_cast<const unsigned short*>(x), tb,
                    static_cast<unsigned short*>(xin), n, n_slots);
                break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// h, g, out: n contiguous elements. dtype: 0 float32, 1 bfloat16. vec: 1
// where the three are 16-byte aligned and n a multiple of the elements in
// 16 bytes, else 0.
extern "C" int moe_glu(const void* h, const void* g, void* out, long long n, int dtype, int vec,
                       void* stream) {
    if (n < 1) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return vec ? launch_glu<float, 4>(h, g, out, n, st)
                               : launch_glu<float, 1>(h, g, out, n, st);
    if (dtype == 1) return vec ? launch_glu<__nv_bfloat16, 8>(h, g, out, n, st)
                               : launch_glu<__nv_bfloat16, 1>(h, g, out, n, st);
    return cudaErrorInvalidValue;
}

// out_e: slot rows of d; slot (rows, K) int32 (-1: dropped); w (rows, K)
// float32; add: (rows, d) or null; out (rows, d). dtype and vec as for
// moe_glu (vec: out_e, add and out 16-byte aligned and d a multiple of the
// elements in 16 bytes).
extern "C" int moe_combine(const void* out_e, const void* slot, const void* w, const void* add,
                           void* out, long long rows, int d, int K, int dtype, int vec,
                           void* stream) {
    if (rows < 1 || rows > 0x7fffffffLL || d < 1 || K < 1) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return vec ? launch_combine<float, 4>(out_e, slot, w, add, out, rows, d, K, st)
                               : launch_combine<float, 1>(out_e, slot, w, add, out, rows, d, K, st);
    if (dtype == 1) return vec ? launch_combine<__nv_bfloat16, 8>(out_e, slot, w, add, out, rows,
                                                                  d, K, st)
                               : launch_combine<__nv_bfloat16, 1>(out_e, slot, w, add, out, rows,
                                                                  d, K, st);
    return cudaErrorInvalidValue;
}
