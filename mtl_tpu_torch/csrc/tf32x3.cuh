// 3xTF32 on Hopper's tensor cores: f32 GEMMs on wgmma at close to f32
// accuracy. Shared by csrc/stft_dft_tc.cu (the direct STFT) and
// csrc/vgg_f32_tc.cu (the f32 VGG blocks 1 and 2).
//
// TF32 keeps 10 mantissa bits, about three decimal digits: one pass of an
// f32 product through it misses the f32 routes' 1e-4 (log1p amplifies the
// error of small STFT bins; a TF32 VGG recompute was off by 0.75 % of the
// largest gradient). So every f32 operand x is split into
//   hi = tf32(x),  lo = tf32(x - hi)
// (cvt.rna's rounding: to nearest, ties away from zero, low 13 bits
// cleared; x - hi is exact in f32; done in integer ops, see to_tf32), and a
// product takes three passes,
//   a.b ~= a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// dropping lo.lo (2^-22 relative), accumulated in f32. At the H100's 495
// TFLOP/s of dense TF32 that is an effective 165 TFLOP/s, 2.5x the 67 of
// f32 FMAs on the CUDA cores. The small products are issued first, into the
// same accumulator (mma3); an accumulator of their own, added at the end,
// is more accurate but needs twice the registers and was slower
// (PERF.md; cli/tf32_ablation.py's small_acc).
//
// Operands: A from registers (a warp's m16 x k8 slice of the m64 tile:
// a0 (row g, k q), a1 (row g + 8, k q), a2 (row g, k q + 4), a3 (row g + 8,
// k q + 4), g = lane / 4, q = lane % 4), split by the caller in registers;
// B from shared memory by descriptor, K-major (TF32 takes no transpose), no
// swizzle: 8 x 4 core matrices of 128 contiguous bytes (8 n rows of 4 k),
// 128 B apart along k and sbo apart along n. The wrappers pack B once in
// that layout, split (the STFT basis) or as f32 that the kernel splits on
// its way into shared memory (the VGG weights); ops/tf32.py:split_tf32 is
// the bit-exact mirror of split() below.
// The accumulator of an m64nN tile is N/2 floats a thread, 4 per n8 block
// j: (row g, cols 8j + 2q, +1), (row g + 8, the same cols).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (L2 only); src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes (st.shared, cp.async) before
// later reads of them by wgmma, which reads through the async proxy; the
// barrier that follows publishes them to the other threads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- split

// The rounding of cvt.rna.tf32.f32 (nearest, ties away from zero) with the
// low 13 bits cleared, as integer ops: adding 2^12 to the bits of a finite
// x carries into bit 13 exactly when the dropped bits are half or more of
// its last kept bit, sign apart. Integer adds and logic issue at the full
// rate; the conversion instruction does not. inf and nan pass through.
// (tf32_split_f32 below holds it against the instruction on the card.)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  const uint32_t b = __float_as_uint(x);
  return fabsf(x) < INFINITY ? (b + 0x1000u) & 0xffffe000u : b;
}

// x -> (hi, lo); where hi is not finite lo = 0, so inf stays inf
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  const float h = __uint_as_float(hi);
  const uint32_t r = __float_as_uint(x - h);
  lo = fabsf(h) < INFINITY ? (r + 0x1000u) & 0xffffe000u : 0u;
}

// cvt.rna.tf32.f32 itself, low 13 bits cleared (PTX leaves them to the
// implementation; the tensor cores ignore them)
__device__ __forceinline__ uint32_t cvt_rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// This lane's A fragment of one k8 step, split: r0 points at (row g, k q),
// r1 at (row g + 8, k q) of f32 rows in shared memory.
__device__ __forceinline__ void load_split(const float* r0, const float* r1,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(r0[0], hi[0], lo[0]);
  split(r1[0], hi[1], lo[1]);
  split(r0[4], hi[2], lo[2]);
  split(r1[4], hi[3], lo[3]);
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of acc across the wgmma fence /
// wait around it (the asm statements that issue the MMAs are the only ones
// that name the accumulators).
template <int N>
__device__ __forceinline__ void pin(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}
template <int MT, int N>
__device__ __forceinline__ void pin(float (&acc)[MT][N]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) pin(acc[m]);
}
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  pin(acc);
}
template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) zero(acc[m]);
}

// Shared-memory descriptor of a K-major, unswizzled B operand at addr: core
// matrices 128 B apart along k (the leading byte offset), sbo apart along n
// (the stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d[m64 x N] += a[m64 x k8] @ B[k8 x N], tf32 operands, f32 accumulators.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<112> {
  static __device__ __forceinline__ void mma(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// One 3xTF32 product step: the two small products first, then hi.hi, all
// into d.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2],
                                     const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint64_t b_hi,
                                     uint64_t b_lo) {
  WgmmaTf32<N>::mma(d, a_lo, b_hi);
  WgmmaTf32<N>::mma(d, a_hi, b_lo);
  WgmmaTf32<N>::mma(d, a_hi, b_hi);
}

}  // namespace tf32x3
