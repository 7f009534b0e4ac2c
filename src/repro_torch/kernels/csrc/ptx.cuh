// The tensor-core kernels' inline PTX, one instruction per function, for
// sm_90a: bf16 m16n8k16 products with float32 accumulation (mma.sync),
// 8 x 8 b16 matrix loads from shared memory (ldmatrix), and 16-byte
// asynchronous copies from device to shared memory (cp.async).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane = 4 g + t of a warp:
//   A (16 x 16, row-major)  a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//                           a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k x n)       b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, float)    c0, c1 = C[g][2t, 2t+1] c2, c3 = C[g+8][2t, 2t+1]
// each 32-bit register holding two bf16, the lower column (or k) in the
// lower half. So the accumulators of two neighbouring n8 tiles are, packed
// to bf16 pairs, the A fragment of the next product over those 16 columns.
// ldmatrix.x4 takes one 16-byte row address from each lane (lanes 8i..8i+7
// address the rows of matrix i) and returns matrix i in register i: lane
// 4g + t holds row g, columns 2t and 2t+1; with .trans, rows 2t and 2t+1 of
// column g.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices from shared memory, row i of matrix j at the
// address of lane 8j + i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

// 16 bytes from device memory to shared memory, asynchronously; zeros when
// !full (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two floats rounded to bf16 (to nearest even), lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// the two bf16 of a packed pair as floats (exact)
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (lo, hi) as a bf16 pair plus a bf16 pair of what that rounding left over:
// hi_part + lo_part carries about 16 bits of each float's significand
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& big, uint32_t& small) {
    big = pack_bf16x2(lo, hi);
    small = pack_bf16x2(lo - bf16_lo(big), hi - bf16_hi(big));
}
