// The tensor-core kernels' inline PTX, one instruction per function, for
// sm_90a: bf16 m16n8k16 products with float32 accumulation (mma.sync),
// 8 x 8 b16 matrix loads from shared memory (ldmatrix), and 16-byte
// asynchronous copies from device to shared memory (cp.async); float32
// products on the tensor cores as three TF32 products (mma.sync m16n8k8,
// second part); then Hopper's own (third part): warpgroup products
// (wgmma), tensor copies by the tensor memory accelerator (TMA) and
// shared-memory barriers (mbarrier); and the rings of stages that the wgmma
// kernels fill and take items from, with the contract of their barriers and
// a diagnostic build (RING_DIAG) that checks it on the card (fourth part).
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
#include <cuda.h>
#include <cuda_runtime.h>
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

// ---------------------------------------------------------------------------
// float32 on the tensor cores: 3xTF32
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (PTX ISA, "Matrix
// Fragments for mma.m16n8k8"), one 32-bit value a register, lane = 4 g + t:
//   A (16 x 8, row-major)  a0 = A[g][t]    a1 = A[g+8][t]   a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8, k x n)       b0 = B[t][g]    b1 = B[t+4][g]
//   C, D (16 x 8, float)   c0, c1 = C[g][2t, 2t+1]          c2, c3 = C[g+8][2t, 2t+1]
// So an accumulator is not an A fragment as it is: its columns 2t and 2t+1
// are what A wants at k = t and k = t + 4. Taking key 2t as k = t and key
// 2t + 1 as k = t + 4 (a0 = c0, a1 = c2, a2 = c1, a3 = c3) makes it one, if
// the B operand's rows are read in the same order (b0 from row 2t, b1 from
// row 2t + 1): a sum over k does not care about the order of its terms.
//
// A TF32 value keeps 10 bits of the significand, so one product misses a
// float32 check by orders of magnitude. The split x = hi + lo, hi = tf32(x)
// (rounded to nearest), lo = tf32(x - hi), gives a b = a_hi b_hi + a_hi b_lo
// + a_lo b_hi + (a_lo b_lo, dropped: about 2^-22 of a b), float32 sums.

// x rounded to TF32 (nearest, ties away from zero), as its 32-bit pattern:
// the value cvt.rna.tf32.f32 gives for every finite x, by an integer add and
// mask (half a TF32 ulp added to the magnitude, the 13 low bits cleared),
// which issue at the full rate where the conversion does not
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo, both TF32 (x - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32_1688(float d[4], const uint32_t a[4], uint32_t b0,
                                              uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += a b_j in 3xTF32 for NB n8 tiles j: each of the three products
// (the two small terms first, then hi hi) across all NB tiles before the
// next, so that a tile's three dependent products issue NB apart
template <int NB>
__device__ __forceinline__ void mma_3xtf32(float (*acc)[4], const uint32_t ah[4],
                                           const uint32_t al[4], const uint32_t (*bh)[2],
                                           const uint32_t (*bl)[2]) {
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32_1688(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32_1688(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NB; ++j) mma_tf32_1688(acc[j], ah, bh[j][0], bh[j][1]);
}

// ---------------------------------------------------------------------------
// Hopper: wgmma, TMA, mbarrier, setmaxnreg
//
// wgmma.mma_async m64n64k16 (PTX ISA, "Asynchronous Warpgroup Level Matrix
// Multiply-Accumulate"): the 4 warps of a warpgroup (128 threads; warp w of
// the group owns rows 16 w .. 16 w + 15) compute D (64 x 64, float32)
// (+)= A (64 x 16) B (16 x 64) in bf16. Within a warp the register layouts
// are mma.m16n8k16's above: A from registers is its A fragment (4 x 32
// bits), and D holds the C fragments of the 8 n8 tiles in order,
// d[4 j + e] = tile j's c_e. B, and A from shared memory, are read through a
// 64-bit matrix descriptor: start address >> 4 (bits 0-13), leading and
// stride byte offsets >> 4 (16-29, 32-45), swizzle mode (62-63; 1 = 128
// bytes). Every tile here is a TMA box of 64 rows of 128 bytes (64 bf16)
// written with CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r % 8)) * 16), 8 rows (1024 bytes) to a swizzle atom, each
// box at a 1024-byte boundary. So:
//   K-major operand (a row holds the k values: Q, K, C, B of C B^T, h):
//     start = box of k / 64 + (k % 64) * 2 bytes, for the k-slice at k;
//   MN-major operand (a row is one k: V, x, B of the state), transpose bit
//     set: start = box + k * 128 bytes.
// One product of N = 64 stays within one box, so its only stride is the one
// between 8-row groups (1024 bytes): both byte offsets are set to it,
// whichever of the two the mode reads.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
    return ((uint64_t)(smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// order this thread's register and shared-memory accesses before the
// warpgroup's next wgmma (needed before the first one and whenever its
// accumulators or A registers were written by other instructions)
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmma are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of these registers across the
// asynchronous wgmma that reads or writes them
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

#define WGMMA_D32                                                                      \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D32_OUT(d)                                                                  \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d = A B (accumulate 0) or d += A B (1): m64n64k16, bf16, A and B in shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D32_OUT(d)
        : "l"(da), "l"(db), "r"(accumulate));
}

// the same with A from registers (this warp's 16 rows as an m16n8k16 A
// fragment); TRANS_B: B is MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WGMMA_D32_OUT(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

#undef WGMMA_D32
#undef WGMMA_D32_OUT

// the byte offset of bf16 element (r, c) in a box of rows of 128 bytes
// written with the 128-byte swizzle
__device__ __forceinline__ int sw128(int r, int c) {
    return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// p advanced to the next 1024-byte boundary of shared memory (the 128-byte
// swizzle's atom)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
    return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// an mbarrier expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// make initialised mbarriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of TMA copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

#ifdef RING_DIAG
__device__ void ring_diag_note(int which, uint32_t parity, int site, int item, int work,
                               long long seen);
#endif

// wait until the phase of this parity has completed (phases count from 0;
// use k completes the phase of parity k & 1). A wait of more than about 2^33
// cycles (seconds) traps, so a lost arrival fails the launch rather than
// hanging the card. `site` (ring_site), `item` and `work` say what the wait
// is for; only the diagnostic build (RING_DIAG) reads them, to record a
// wait that timed out.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, int site = 0,
                                          int item = 0, int work = 0) {
    const uint32_t addr = smem_addr(bar);
    long long t0 = 0;
    for (int spin = 0;; ++spin) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (spin == 0) t0 = clock64();
        else if (clock64() - t0 > (1LL << 33)) {
#ifdef RING_DIAG
            ring_diag_note(1, parity, site, item, work, -1);
#endif
            __trap();
        }
    }
}

// a 3-d / 4-d TMA box at coordinates (c0 innermost, ...) into dst, its bytes
// reported to bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
           "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// a 4-d TMA box from src (in the same layout a load would give) to
// coordinates (c0 innermost, ...) of the map's tensor; elements outside it
// are not written. Completes in a bulk group of this thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's generic shared-memory writes before later accesses of
// the async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// warp specialisation: the producer warpgroup gives registers back to the
// CTA's pool (setmaxnreg.dec) and each consumer warpgroup takes more
// (setmaxnreg.inc, waiting until the pool has them). Every thread of the
// warpgroup executes it; the roles' paths never rejoin.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// named barrier `id` over `threads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// rings of stages (fourth part): one producer thread fills shared-memory
// stages by TMA, consumer warpgroups take the items
//
// Item k of a ring goes into stage k % STAGES and is for one set of
// consumers: one warpgroup, or every consumer warpgroup of the block. A
// stage has a `full` barrier for each set (one arrival a phase, the
// producer's arrive.expect_tx, plus the copies' bytes) and one `empty`
// barrier (the releases of the set that took its item: `releases` arrivals
// a phase).
//
// The contract. mbarrier.try_wait.parity names a phase by its parity alone
// and is true once the barrier's current phase has the other parity. So a
// wait may only name the barrier's current phase or the one just before it:
// a wait for the phase after the current one returns at once (its parity is
// the last completed phase's), and one for two phases back never returns.
// Why every wait on a Ring keeps it:
//   * full[c][s] is waited on only by set c, by each of its threads, for
//     each of the set's items in stage s in order (RingPhases keeps the
//     parity of the next one). When set c waits for its n-th item in s
//     (phase n), it has waited for its (n-1)-th, so phase n - 1 has
//     completed. Phase n + 1 has not: its arrive comes from the fill of set
//     c's next item in s, after the producer's wait on empty[s] for the item
//     before that one, which is set c's n-th or a later item, released only
//     after this wait. So the barrier stands at phase n or n + 1.
//   * empty[s] is waited on only by the producer, for every item in order:
//     phase m is the release of item k = s + m STAGES, awaited before item
//     k + STAGES is filled. Item k is released only by the set it was filled
//     for, after its fill, which followed the producer's wait for phase
//     m - 1. So phase m gets exactly the releases of item k, and the wait
//     finds the barrier at phase m or m + 1.
//   * The producer's arrive on full[c][s] for set c's n-th item in s falls
//     on phase n: phase n - 1 completed before set c released its (n-1)-th
//     item, and the producer has seen that release on empty[s] (a barrier's
//     phases complete in order).
// Why a full barrier per set: with one a stage, waited for by the item's
// parity (k / STAGES) & 1, and consecutive items of a stage taken by
// different warpgroups (K3's rings, K2's with the key tiles split over 3
// stages), one warpgroup can wait for phase n + 1 of a stage while the
// other's copy for phase n has not landed. Its wait returns at once, it
// reads the stage before the copy and releases it, the producer's next
// arrive falls on a phase with no arrival left, and later a phase never
// completes and its wait traps. RING_DIAG_SHARED_FULL builds that schedule
// (tools/kernel_stress.py --shared-full) as the diagnostic build's positive
// control: tests/test_torch_cuda.py requires it to fail under the held-back
// copies of RING_DIAG_DELAY_NS, where this schedule runs clean, so the
// delay is shown to catch a broken ring on every card run of the tests.
// tests/test_torch_ring_protocol.py models both schedules.

// a wait's barrier, for the diagnostic record: ring << 12 | kind << 8 |
// set << 4 | stage (kind 1 full, 2 empty)
__device__ __forceinline__ int ring_site(int ring, int kind, int set, int stage) {
    return ring << 12 | kind << 8 | set << 4 | stage;
}

// a consumer set's parities of its next wait on each stage (bit s); every
// thread of the set keeps its own copy
using RingPhases = uint32_t;

template <int STAGES, int SETS, int ID = 0>
struct Ring {
    uint64_t full[SETS][STAGES];
    uint64_t empty[STAGES];
#ifdef RING_DIAG
    volatile int tag[STAGES];   // the item last filled into each stage
#endif

    // by one thread, before mbar_init_fence and the block's __syncthreads
    __device__ void init(uint32_t releases) {
        for (int s = 0; s < STAGES; ++s) {
            for (int c = 0; c < SETS; ++c) mbar_init(&full[c][s], 1);
            mbar_init(&empty[s], releases);
        }
    }

    // the producer: wait until stage k % STAGES is free for item k (item
    // k - STAGES released), then arrive on set c's full barrier expecting
    // `bytes` of copies; returns that barrier, for the copies
    __device__ uint64_t* fill(int k, int c, uint32_t bytes, int work) {
        const int s = k % STAGES;
        if (k >= STAGES)
            mbar_wait(&empty[s], (k / STAGES - 1) & 1, ring_site(ID, 2, 0, s), k, work);
        uint64_t* bar = &full[set_of(c)][s];
#ifdef RING_DIAG
        tag[s] = k;   // before the arrive, whose release publishes it
#endif
        mbar_expect_tx(bar, bytes);
        return bar;
    }

    // a thread of set c: wait until item k has landed
    __device__ void wait(int k, int c, RingPhases& phases, int work) {
        const int s = k % STAGES;
#ifdef RING_DIAG_SHARED_FULL
        const uint32_t parity = (k / STAGES) & 1;   // the schedule that broke the contract
#else
        const uint32_t parity = (phases >> s) & 1;
#endif
        phases ^= 1u << s;
        uint64_t* bar = &full[set_of(c)][s];
        mbar_wait(bar, parity, ring_site(ID, 1, c, s), k, work);
#ifdef RING_DIAG
        // the wait's acquire sees the tag of the fill it waited for: another
        // tag means the wait returned before item k was filled
        const int seen = tag[s];
        if (threadIdx.x % 128 == 0 && seen != k)
            ring_diag_note(0, parity, ring_site(ID, 1, c, s), k, work, seen);
#endif
    }

    // a thread of the set that took item k: done with its stage
    __device__ void release(int k) { mbar_arrive(&empty[k % STAGES]); }

    __device__ static int set_of(int c) {
#ifdef RING_DIAG_SHARED_FULL
        return 0;
#else
        return c;
#endif
    }
};

// the producer's copies of one item: issued at once, or in the diagnostic
// build with RING_DIAG_DELAY_NS, every other item's held back (after its
// fill) and issued that many ns after the next item's, so that a stage's
// copy lands after the next stage's has landed and been consumed
__device__ __forceinline__ uint64_t globaltimer_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

template <class Copy>
struct HeldCopy {
#ifdef RING_DIAG_DELAY_NS
    Copy held;
    bool holding = false;
#endif
    template <class Issue>
    __device__ void push(const Copy& c, Issue&& issue) {
#ifdef RING_DIAG_DELAY_NS
        if (!holding) {
            held = c;
            holding = true;
            return;
        }
        issue(c);
        flush(issue);
#else
        issue(c);
#endif
    }

    // issue what is held: before the producer waits on anything but the
    // next item's stage, and at its end
    template <class Issue>
    __device__ void flush(Issue&& issue) {
#ifdef RING_DIAG_DELAY_NS
        if (!holding) return;
        const uint64_t t0 = globaltimer_ns();
        while (globaltimer_ns() - t0 < (uint64_t)(RING_DIAG_DELAY_NS)) {
        }
        issue(held);
        holding = false;
#endif
    }
};

#ifdef RING_DIAG
// The diagnostic build's record, in mapped host memory (readable after the
// launch trapped and the context is lost): record 0 is the first consumer
// wait that returned before its item was filled, record 1 the first wait
// that timed out. Fields: set (1), block, thread, site (ring_site), parity,
// ring item, work item, the item the stage held (record 0; -1 in record
// 1). g_ring_events counts each kind.
constexpr int RING_DIAG_FIELDS = 8;
__device__ volatile long long* g_ring_diag;
__device__ unsigned long long g_ring_events[2];

__device__ void ring_diag_note(int which, uint32_t parity, int site, int item, int work,
                               long long seen) {
    if (atomicAdd(&g_ring_events[which], 1ull) != 0 || g_ring_diag == nullptr) return;
    volatile long long* r = g_ring_diag + which * RING_DIAG_FIELDS;
    r[1] = blockIdx.x;
    r[2] = threadIdx.x;
    r[3] = site;
    r[4] = parity;
    r[5] = item;
    r[6] = work;
    r[7] = seen;
    __threadfence_system();
    r[0] = 1;
    __threadfence_system();
}
#endif

// ---------------------------------------------------------------------------
// host side: TMA tensor maps, encoded per launch

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                        cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..) read in boxes of `box`, rows of 128 bytes with the 128-byte
// swizzle; out-of-range elements read as zeros
inline bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
    const EncodeTiled fn = encode_tiled();
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
    return fn != nullptr
           && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                 strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
                  == CUDA_SUCCESS;
}

#ifdef RING_DIAG
// host: arm the diagnostic record (mapped host memory, allocated once,
// cleared) and clear the counts; returns the record's host address, or
// null on a CUDA error. Its 2 x RING_DIAG_FIELDS values stay readable after
// a launch traps.
extern "C" void* ring_diag_arm() {
    static long long* host = nullptr;
    const size_t bytes = 2 * RING_DIAG_FIELDS * sizeof(long long);
    if (host == nullptr
        && cudaHostAlloc(reinterpret_cast<void**>(&host), bytes, cudaHostAllocMapped) != cudaSuccess) {
        host = nullptr;
        return nullptr;
    }
    for (int i = 0; i < 2 * RING_DIAG_FIELDS; ++i) host[i] = 0;
    long long* dev = nullptr;
    const unsigned long long zero[2] = {0, 0};
    if (cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev), host, 0) != cudaSuccess
        || cudaMemcpyToSymbol(g_ring_diag, &dev, sizeof(dev)) != cudaSuccess
        || cudaMemcpyToSymbol(g_ring_events, zero, sizeof(zero)) != cudaSuccess)
        return nullptr;
    return host;
}

// host: the counts of both kinds of event since ring_diag_arm; returns the
// CUDA error of the copy
extern "C" int ring_diag_events(unsigned long long* out) {
    return cudaMemcpyFromSymbol(out, g_ring_events, sizeof(g_ring_events));
}
#endif
