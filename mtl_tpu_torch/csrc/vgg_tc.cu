// Fused VGG blocks on bf16 tensor cores: SAME conv3x3 + bias + ReLU -> SAME
// conv3x3 + bias + ReLU -> 2x2 VALID floor max-pool, one kernel per block.
//
// Replaces the Pallas TPU kernels mtl_tpu/ops/vgg_pallas.py:vgg_block1_fused
// (body _b1_kernel, C_in = 1) and vgg_block2_fused (body _b2_kernel,
// C_in > 1), whose channel products ran on the MXU's bf16 path. Here every
// conv operand (x, w1, the conv-1 activation, w2) is a bf16 value, products
// accumulate in f32, bias and ReLU are applied in f32 and the output is
// rounded to bf16 once. The conv-1 activation never goes to device memory:
// it lives in shared memory as bf16. Conv-1 positions outside the image are
// ZERO (SAME padding of conv 2, the TPU kernel's _mask_e), not relu(b1).
// Any T and F: the grid covers the floored pooled extent and masks the
// ragged edge. (csrc/vgg_f32_tc.cu is the f32 route of the same blocks, on
// 3xTF32 tensor cores.)
//
// Layouts: x [B, T, F] f32 (block 1) or [B, T, F, C_in] bf16 (block 2);
// out [B, T/2, F/2, C] bf16. The wrapper (ops/vgg.py) packs the flax HWIO
// weights [3(f), 3(t), C_in, C] (H = freq) into bf16 B operands: per tap
// (tap = dt*3 + df) an [n][k] matrix stored as 8 x 8 core matrices
// [n/8][k/8][8][8], the K-major no-swizzle layout that wgmma reads.
//
// Convs as implicit GEMMs. For a tile of M output positions,
//   acc[M, C] += sum_tap X_tap[M, C_in] @ W_tap[C_in, C]
// with wgmma.m64nNk16 bf16 -> f32, A from registers, B from shared memory
// by descriptor. A comes from ldmatrix.x4 on the shifted window in shared
// memory: each lane gives its own row address, so the tap shift is an
// address offset (a shifted window is no core-matrix layout, so A cannot
// come by descriptor). Every shared activation tile keeps its channel rows
// at a pitch of an odd number of 16-byte chunks (C + 8 bf16), so the 8 rows
// of one ldmatrix phase, 8 consecutive positions, hit 8 different bank
// groups. Each k16 step of a warpgroup is one wgmma commit group; the step
// waits for the group before it, so its ldmatrix loads overlap the previous
// step's MMAs. An m16 row block (one warp's share of an m64 tile) is 2 time
// rows x 8 freq columns, row r = 8*(t&1) + f: in the accumulator a thread
// holds rows g and g+8 (t even, t odd) and lane ^ 4 holds f ^ 1, so the
// 2x2 pool is one max in registers and one __shfl_xor. Pool first, then
// bias and ReLU (both monotone: exact).
//
// Block 1 (C_in = 1, C = 64 or 32), the flagship's [8, 800, 161] input:
// 7.7e10 flop, bound 0.078 ms at 989 TFLOP/s (operations). Conv 1 (K = 9)
// is 1.2e9 of them and stays nine f32 FMAs per output on the CUDA cores
// (x and w1 bf16-rounded, held in f32), written to shared memory as bf16.
// Conv 2 (64 -> 64) is the implicit GEMM. w2 (9*64*64 bf16 = 74 KB) fits
// whole in shared memory, so the grid is persistent: one CTA per SM loads
// it once and walks over conv-2 tiles of 32 t x 16 f (pooled 16 x 8). The
// conv-1 tile is 34 x 18 (halo 20 % of conv 1's FMAs; conv 2 has no halo).
// 2 warpgroups, each 4 m64 tiles x all C channels (128 f32 accumulators a
// thread at C = 64). Shared memory 163 KB: 1 CTA (8 warps) per SM. Tiles at
// the flagship: 25 x 10 x 8 = 2000 over 132 CTAs.
//
// Block 2 (C_in = 64, C = 128, or 32 -> 64), the flagship's [8, 400, 80, 64]:
// 1.13e11 flop, bound 0.114 ms at 989 TFLOP/s. Conv-2 tile 16 x 16 (pooled
// 8 x 8), conv-1 tile 18 x 18 (+27 % conv-1 work on the halo; its 324
// positions are 6 m64 tiles, 384 rows), input tile 20 x 20. Both convs are
// implicit GEMMs. Conv 1 runs in two halves of C/2 output channels (all C
// would need 192 accumulators a thread), each warpgroup 3 m64 tiles; conv 2
// runs all C at once, each warpgroup 2 m64 tiles (128 accumulators). The
// weights (442 KB in bf16) cannot stay in shared memory beside the tiles,
// so they stream one slice at a time in the order they are used -- 18
// conv-1 slices (half, tap) of C/2 x C_in and 9 * C/64 conv-2 slices (tap,
// 64-wide k chunk) of C x 64 -- through a 4-stage cp.async ring, two slices
// ahead, one __syncthreads per slice: a stage is refilled two slices after
// its last MMAs were issued, and the wgmma wait of every step has retired
// those by then. Shared memory at 64 -> 128: input 56 KB + conv-1 tile
// 86 KB + 4 x 16 KB stages = 206 KB: 1 CTA (8 warps) per SM. L2 traffic:
// 25 x 5 x 8 = 1000 CTAs each read the 442 KB of weights, 0.44 GB a call,
// about 0.08 ms of the H100's L2 rate, under the MMA time, and overlapped
// with it; larger tiles would cut it but need more accumulators than a
// thread has. The input tile (51 KB, 1.56x the 33 MB input in all) comes
// through the same cp.async ring, with zero fill outside the image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 2 warpgroups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// (lo, hi) -> two bf16 in one word, lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Keeps the compiler from moving accesses of acc across the wgmma
// fence / wait around it (the asm statements that issue the MMAs are the
// only ones that name the accumulators).
template <int MT, int N>
__device__ __forceinline__ void pin(float (&acc)[MT][N]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[m][i])::"memory");
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[m][i] = 0.f;
  pin(acc);
}

// Shared-memory descriptor of a K-major, unswizzled B operand at addr:
// 8 x 8 core matrices of 128 contiguous bytes, 128 B apart along k (the
// leading byte offset) and sbo apart along n (the stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d[m64 x N] += a[m64 x k16] @ B[k16 x N]; per thread N/2 accumulators,
// 4 per n8 column block j: (row g, cols 8j+2q, +1), (row g+8, same cols).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
// One k16 step of a warpgroup over its MT m64 tiles: A rows of this warp by
// ldmatrix (a_addr[m] + a_off: row lane & 15, k offset 8 * (lane >> 4)),
// B by descriptor. Commits the step as one group and waits for the step
// before it, so the next step's ldmatrix overlaps this step's MMAs. The A
// registers of a step must not be written while its MMAs are in flight:
// callers unroll at least two steps in a row, so the step that reuses them
// comes after the wait that retired them.
template <int MT, int N>
__device__ __forceinline__ void wg_step(const uint32_t (&a_addr)[MT],
                                        uint32_t a_off, uint64_t desc,
                                        float (&acc)[MT][N / 2]) {
  uint32_t a[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) ldsm_x4(a_addr[m] + a_off, a[m]);
  wg_fence();
#pragma unroll
  for (int m = 0; m < MT; ++m) Wgmma<N>::mma(acc[m], a[m], desc);
  wg_commit();
  wg_wait<1>();
}

// ldmatrix row address of this lane in conv-2 m16 row block mi of a tile
// whose source rows are src_cols positions wide: t = 2*(mi/2) + (r >> 3),
// f = 8*(mi%2) + (r & 7), r = lane & 15.
__device__ __forceinline__ uint32_t pool_row_addr(uint32_t base, int mi,
                                                  int lane, int src_cols,
                                                  int pitch) {
  const int r = lane & 15;
  const int t = 2 * (mi >> 1) + (r >> 3), f = 8 * (mi & 1) + (r & 7);
  return base + ((t * src_cols + f) * pitch + (lane >> 4) * 8) * 2;
}

// After the last wgmma wait: 2x2 pool of the conv-2 accumulators (m64 tile
// m holds this warp's m16 row block mi0 + 4*m of the tile at pooled
// (pt0, pf0)), then bias + ReLU in f32 and one rounding to bf16.
template <int MT, int N>
__device__ __forceinline__ void pool_store(
    const float (&acc)[MT][N / 2], int mi0, int pt0, int pf0, int lane,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ outb, int TP,
    int FP) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mi = mi0 + 4 * m;
    const int pt = pt0 + (mi >> 1), pf = pf0 + 4 * (mi & 1) + (g >> 1);
    const bool store = !(g & 1) && pt < TP && pf < FP;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float m0 = fmaxf(acc[m][4 * j], acc[m][4 * j + 2]);  // t even, t odd
      float m1 = fmaxf(acc[m][4 * j + 1], acc[m][4 * j + 3]);
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));  // f ^ 1
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
      if (store) {
        const int c = 8 * j + 2 * q;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + c));
        *reinterpret_cast<__nv_bfloat162*>(
            outb + ((size_t)pt * FP + pf) * N + c) =
            __floats2bfloat162_rn(fmaxf(m0 + bias.x, 0.f),
                                  fmaxf(m1 + bias.y, 0.f));
      }
    }
  }
}

// ---------------------------------------------------------------- block 1

template <int C>
struct B1 {
  static constexpr int TT = 32, TF = 16;          // conv-2 tile
  static constexpr int R1 = TT + 2, C1 = TF + 2;  // conv-1 tile
  static constexpr int R0 = TT + 4, C0 = TF + 4;  // input tile
  static constexpr int P = C + 8;                 // act row pitch
  static constexpr int CG = C / 8;                // 8-channel groups
  static constexpr int MT = 4;                    // m64 tiles a warpgroup
  static constexpr size_t SMEM =
      2 * (size_t)(R1 * C1 * P + 9 * C * C) + 4 * (size_t)(R0 * C0 + 9 * C);
  static_assert(2 * MT * 64 == TT * TF, "2 warpgroups x 4 m64 tiles");
  static_assert(THREADS % CG == 0, "conv-1 thread map");
  static_assert(C / 16 >= 2, "two k16 steps a tap (see wg_step)");
};

// grid: min(tiles, SMs), persistent; w1 [9][C] bf16 (tap = dt*3 + df);
// w2 [9][C/8 (n)][C/8 (k)][8][8] bf16.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    vgg_block1_tc_kernel(const float* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int B, int T,
                         int F) {
  using K = B1<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act = w2s + 9 * C * C;
  float* xs = reinterpret_cast<float*>(act + K::R1 * K::C1 * K::P);
  float* w1s = xs + K::R0 * K::C0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const uint32_t w2_u = smem_u32(w2s), act_u = smem_u32(act);
  for (int e = tid; e < 9 * C * C / 8; e += THREADS)
    cp_async16(w2_u + e * 16, w2 + e * 8, 16);
  cp_async_commit();
  for (int e = tid; e < 9 * C; e += THREADS)
    w1s[e] = __bfloat162float(w1[e]);
  cp_async_wait<0>();

  const int TP = T / 2, FP = F / 2;
  const int n_t = (TP + K::TT / 2 - 1) / (K::TT / 2);
  const int n_f = (FP + K::TF / 2 - 1) / (K::TF / 2);
  const int tiles = n_t * n_f * B;

  // warpgroup wg owns m64 tiles 4*wg .. 4*wg + 3; this warp their m16 row
  // blocks 16*wg + wl + 4*m
  uint32_t a2[K::MT];
#pragma unroll
  for (int m = 0; m < K::MT; ++m)
    a2[m] = pool_row_addr(act_u, 16 * wg + wl + 4 * m, lane, K::C1, K::P);

  const int cg = tid % K::CG;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tf = tile % n_f, tt = (tile / n_f) % n_t, b = tile / (n_f * n_t);
    const int t0 = tt * K::TT, f0 = tf * K::TF;
    const float* xb = x + (size_t)b * T * F;
    __syncthreads();  // w2 landed / the previous tile is done with xs, act
    for (int e = tid; e < K::R0 * K::C0; e += THREADS) {
      const int t = t0 - 2 + e / K::C0, f = f0 - 2 + e % K::C0;
      xs[e] = (t >= 0 && t < T && f >= 0 && f < F)
                  ? bf16_round(__ldg(xb + (size_t)t * F + f))
                  : 0.f;
    }
    __syncthreads();

    // conv 1: nine FMAs per output, thread = (position, 8-channel group)
    {
      float w[9][8], bias[8];
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) w[k][j] = w1s[k * C + 8 * cg + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) bias[j] = __ldg(b1 + 8 * cg + j);
      for (int p = tid / K::CG; p < K::R1 * K::C1; p += THREADS / K::CG) {
        const int pr = p / K::C1, pc = p % K::C1;
        const int t = t0 - 1 + pr, f = f0 - 1 + pc;
        const bool in = t >= 0 && t < T && f >= 0 && f < F;
        float xv[9];
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df)
            xv[dt * 3 + df] = xs[(pr + dt) * K::C0 + pc + df];
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            s0 = fmaf(xv[k], w[k][j], s0);
            s1 = fmaf(xv[k], w[k][j + 1], s1);
          }
          v[j / 2] = in ? pack_bf16x2(fmaxf(s0 + bias[j], 0.f),
                                      fmaxf(s1 + bias[j + 1], 0.f))
                        : 0u;
        }
        *reinterpret_cast<uint4*>(act + p * K::P + 8 * cg) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // conv 2: implicit GEMM over the 9 taps, w2 resident
    float acc[K::MT][C / 2];
    zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, df = tap % 3;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
        wg_step<K::MT, C>(a2, (dt * K::C1 + df) * K::P * 2 + ks * 32,
                          b_desc(w2_u + tap * C * C * 2 + ks * 256, C * 16),
                          acc);
    }
    wg_wait<0>();
    pin(acc);
    pool_store<K::MT, C>(acc, 16 * wg + wl, t0 / 2, f0 / 2, lane, b2,
                         out + (size_t)b * TP * FP * C, TP, FP);
  }
}

// ---------------------------------------------------------------- block 2

template <int CIN, int C>
struct B2 {
  static constexpr int TT = 16, TF = 16;          // conv-2 tile
  static constexpr int R1 = TT + 2, C1 = TF + 2;  // conv-1 tile
  static constexpr int R0 = TT + 4, C0 = TF + 4;  // input tile
  static constexpr int IP = CIN + 8, AP = C + 8;  // input, act row pitch
  static constexpr int M1 = R1 * C1;
  static constexpr int MT1 = 3, MT2 = 2;          // m64 tiles a warpgroup
  static constexpr int NH = C / 2;                // conv-1 N per pass
  static constexpr int KC = 64, KCH = C / KC;     // conv-2 k chunks
  static constexpr int SL1 = NH * CIN, SL2 = C * KC;
  static constexpr int SL = SL1 > SL2 ? SL1 : SL2;  // slice stride
  static constexpr int NS1 = 2 * 9, NS = NS1 + 9 * KCH;
  static constexpr int STAGES = 4;
  static constexpr size_t SMEM =
      2 * (size_t)(R0 * C0 * IP + R1 * C1 * AP + STAGES * SL);
  static_assert(C % KC == 0 && CIN % 16 == 0, "channel tiling");
  static_assert(CIN / 16 >= 2, "two k16 steps a slice (see wg_step)");
  static_assert(2 * MT1 * 64 >= M1 && 2 * MT2 * 64 == TT * TF, "m64 tiles");
};

// Copy weight slice s into a stage: conv-1 slices are NH x CIN, conv-2
// slices C x 64, each in core-matrix order, contiguous.
template <int CIN, int C>
__device__ __forceinline__ void issue_slice(const __nv_bfloat16* __restrict__ wp,
                                            int s, uint32_t stage, int tid) {
  using K = B2<CIN, C>;
  const int n = s < K::NS1 ? K::SL1 : K::SL2;
  const __nv_bfloat16* src = wp + (size_t)s * K::SL;
  for (int e = tid; e < n / 8; e += THREADS)
    cp_async16(stage + e * 16, src + e * 8, 16);
}

// Wait for slice s, start slice s+2 in the stage of slice s-2 (whose MMAs
// every warp has retired: each step waits for the step before it); returns
// the stage holding slice s.
template <int CIN, int C>
__device__ __forceinline__ uint32_t next_slice(const __nv_bfloat16* wp, int s,
                                               uint32_t stages, int tid) {
  using K = B2<CIN, C>;
  cp_async_wait<1>();
  __syncthreads();
  if (s + 2 < K::NS)
    issue_slice<CIN, C>(wp, s + 2, stages + ((s + 2) % K::STAGES) * K::SL * 2,
                        tid);
  cp_async_commit();
  return stages + (s % K::STAGES) * K::SL * 2;
}

// grid: (ceil(FP/8), ceil(TP/8), B). wp: NS slices of SL bf16 each, in the
// order used: conv 1 (half h, tap) [C/2 (n)][C_in (k)], then conv 2 (tap,
// k chunk) [C (n)][64 (k)], each as [n/8][k/8][8][8] core matrices.
template <int CIN, int C>
__global__ void __launch_bounds__(THREADS, 1)
    vgg_block2_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ wp,
                         const float* __restrict__ b1,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ out, int T, int F) {
  using K = B2<CIN, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = stg + K::STAGES * K::SL;
  __nv_bfloat16* act = xs + K::R0 * K::C0 * K::IP;
  const uint32_t xs_u = smem_u32(xs), act_u = smem_u32(act),
                 stg_u = smem_u32(stg);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, t0 = blockIdx.y * K::TT, f0 = blockIdx.x * K::TF;
  const int TP = T / 2, FP = F / 2;

  // prologue: input tile (zeros outside the image) + slice 0, then slice 1
  {
    constexpr int CH = CIN / 8;
    const __nv_bfloat16* xb = x + (size_t)b * T * F * CIN;
    for (int e = tid; e < K::R0 * K::C0 * CH; e += THREADS) {
      const int ch = e % CH, p = e / CH;
      const int t = t0 - 2 + p / K::C0, f = f0 - 2 + p % K::C0;
      const bool in = t >= 0 && t < T && f >= 0 && f < F;
      cp_async16(xs_u + (p * K::IP + ch * 8) * 2,
                 in ? xb + ((size_t)t * F + f) * CIN + ch * 8 : xb,
                 in ? 16 : 0);
    }
    issue_slice<CIN, C>(wp, 0, stg_u, tid);
    cp_async_commit();
    issue_slice<CIN, C>(wp, 1, stg_u + K::SL * 2, tid);
    cp_async_commit();
  }

  int s = 0;
  // conv 1 over the R1 x C1 tile, positions in row-major order, in two
  // halves of C/2 channels; warpgroup wg owns m64 tiles MT1*wg ..
  // MT1*wg + MT1-1, this warp their m16 row blocks
  {
    uint32_t a1[K::MT1];
#pragma unroll
    for (int m = 0; m < K::MT1; ++m) {
      const int mi = 4 * (K::MT1 * wg + m) + wl;
      const int p = min(16 * mi + (lane & 15), K::M1 - 1);
      a1[m] = xs_u +
              (((p / K::C1) * K::C0 + p % K::C1) * K::IP + (lane >> 4) * 8) * 2;
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float acc[K::MT1][K::NH / 2];
      zero(acc);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++s) {
        const uint32_t stage = next_slice<CIN, C>(wp, s, stg_u, tid);
        const int dt = tap / 3, df = tap % 3;
#pragma unroll
        for (int ks = 0; ks < CIN / 16; ++ks)
          wg_step<K::MT1, K::NH>(a1, (dt * K::C0 + df) * K::IP * 2 + ks * 32,
                                 b_desc(stage + ks * 256, CIN * 16), acc);
      }
      wg_wait<0>();
      pin(acc);
      // bias + ReLU in f32, zero outside the image, bf16 into the act tile
#pragma unroll
      for (int m = 0; m < K::MT1; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 16 * (4 * (K::MT1 * wg + m) + wl) + g + 8 * hh;
          if (p >= K::M1) continue;
          const int t = t0 - 1 + p / K::C1, f = f0 - 1 + p % K::C1;
          const bool in = t >= 0 && t < T && f >= 0 && f < F;
#pragma unroll
          for (int j = 0; j < K::NH / 8; ++j) {
            const int c = h * K::NH + 8 * j + 2 * q;
            const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + c));
            *reinterpret_cast<uint32_t*>(act + p * K::AP + c) =
                in ? pack_bf16x2(fmaxf(acc[m][4 * j + 2 * hh] + bias.x, 0.f),
                                 fmaxf(acc[m][4 * j + 2 * hh + 1] + bias.y,
                                       0.f))
                   : 0u;
          }
        }
    }
  }

  // conv 2 over the TT x TF tile, all C channels; warpgroup wg owns m64
  // tiles MT2*wg .. MT2*wg + MT2-1. The first next_slice barrier orders
  // the act tile's writes before these reads.
  {
    uint32_t a2[K::MT2];
#pragma unroll
    for (int m = 0; m < K::MT2; ++m)
      a2[m] = pool_row_addr(act_u, 4 * (K::MT2 * wg + m) + wl, lane, K::C1,
                            K::AP);
    float acc[K::MT2][C / 2];
    zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, df = tap % 3;
#pragma unroll 1
      for (int kc = 0; kc < K::KCH; ++kc, ++s) {
        const uint32_t stage = next_slice<CIN, C>(wp, s, stg_u, tid);
#pragma unroll
        for (int ks = 0; ks < K::KC / 16; ++ks)
          wg_step<K::MT2, C>(
              a2, ((dt * K::C1 + df) * K::AP + kc * K::KC) * 2 + ks * 32,
              b_desc(stage + ks * 256, K::KC * 16), acc);
      }
    }
    wg_wait<0>();
    pin(acc);
    pool_store<K::MT2, C>(acc, 4 * K::MT2 * wg + wl, t0 / 2, f0 / 2, lane,
                          b2, out + (size_t)b * TP * FP * C, TP, FP);
  }
}

template <int C>
int launch1(const float* x, const __nv_bfloat16* w1, const float* b1,
            const __nv_bfloat16* w2, const float* b2, __nv_bfloat16* out,
            int B, int T, int F, cudaStream_t stream) {
  using K = B1<C>;
  auto kernel = vgg_block1_tc_kernel<C>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((T / 2 + K::TT / 2 - 1) / (K::TT / 2)) *
                    ((F / 2 + K::TF / 2 - 1) / (K::TF / 2)) * B;
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, K::SMEM, stream>>>(x, w1, b1, w2, b2, out, B, T, F);
  return (int)cudaGetLastError();
}

template <int CIN, int C>
int launch2(const __nv_bfloat16* x, const __nv_bfloat16* wp, const float* b1,
            const float* b2, __nv_bfloat16* out, int B, int T, int F,
            cudaStream_t stream) {
  using K = B2<CIN, C>;
  auto kernel = vgg_block2_tc_kernel<CIN, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F / 2 + K::TF / 2 - 1) / (K::TF / 2),
                  (T / 2 + K::TT / 2 - 1) / (K::TT / 2), B);
  kernel<<<grid, THREADS, K::SMEM, stream>>>(x, wp, b1, b2, out, T, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Block 1: x f32 [B, T, F]; w1 bf16 [9][C]; w2 bf16 [9][C/8][C/8][8][8];
// out bf16 [B, T/2, F/2, C]. C = 64 or 32.
extern "C" int vgg_block1_tc(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out, int B,
                             int T, int F, int c, void* stream) {
  auto xp = static_cast<const float*>(x);
  auto w1p = static_cast<const __nv_bfloat16*>(w1);
  auto w2p = static_cast<const __nv_bfloat16*>(w2);
  auto b1p = static_cast<const float*>(b1), b2p = static_cast<const float*>(b2);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto s = (cudaStream_t)stream;
  if (c == 64) return launch1<64>(xp, w1p, b1p, w2p, b2p, op, B, T, F, s);
  if (c == 32) return launch1<32>(xp, w1p, b1p, w2p, b2p, op, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}

// Block 2: x bf16 [B, T, F, C_in]; wp bf16 packed slices (see the kernel);
// out bf16 [B, T/2, F/2, C]. (C_in, C) = (64, 128) or (32, 64).
extern "C" int vgg_block2_tc(const void* x, const void* wp, const void* b1,
                             const void* b2, void* out, int B, int T, int F,
                             int cin, int c, void* stream) {
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wpp = static_cast<const __nv_bfloat16*>(wp);
  auto b1p = static_cast<const float*>(b1), b2p = static_cast<const float*>(b2);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto s = (cudaStream_t)stream;
  if (cin == 64 && c == 128)
    return launch2<64, 128>(xp, wpp, b1p, b2p, op, B, T, F, s);
  if (cin == 32 && c == 64)
    return launch2<32, 64>(xp, wpp, b1p, b2p, op, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}
