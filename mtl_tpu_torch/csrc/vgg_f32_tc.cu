// Fused VGG blocks 1 and 2 in f32 on TF32 tensor cores at f32 accuracy
// (3xTF32, csrc/tf32x3.cuh): SAME conv3x3 + bias + ReLU -> SAME conv3x3 +
// bias + ReLU -> 2x2 VALID floor max-pool, one kernel per block.
//
// Replaces the Pallas TPU kernels mtl_tpu/ops/vgg_pallas.py:vgg_block1_fused
// (body _b1_kernel, C_in = 1) and vgg_block2_fused (body _b2_kernel, C_in >
// 1) on the f32 route, the card's f32 parity path (counted as
// vgg_block1_f32 / vgg_block2_f32; the bf16 route of both is
// csrc/vgg_tc.cu). The structure is vgg_tc.cu's with f32 tiles: conv 2 (and
// block 2's conv 1) as implicit GEMMs, the conv-1 activation kept in shared
// memory (f32), conv-1 positions outside the image set to ZERO (SAME
// padding of conv 2), the t-parity row order (an m16 row block is 2 time
// rows x 8 freq columns, so the 2x2 pool is one max in registers and one
// __shfl_xor), pool first, then bias and ReLU (both monotone: exact). Every
// tensor-core product takes the three tf32 passes. Both blocks share the
// weight ring (Ring), conv 2 (conv2) and the epilogue (pool_store).
//
// Layouts: x f32 [B, T, F] (block 1) or [B, T, F, C_in] (block 2); out f32
// [B, T/2, F/2, C]. The wrapper (ops/vgg.py:pack_block{1,2}_f32tc) packs the
// flax HWIO weights into the stream of slices the kernel uses in order,
// each a (tap, 16-channel k chunk) of one conv as an [n = C][k = 16] f32
// matrix in core matrices [C/8][4][8][4]: block 2's conv 1 (9 * C_in/16
// slices), then conv 2's 9 * C/16 (block 1's conv 1, K = 9, takes w1 as it
// is). Block 1: C = 64 (vgg_cnn) or 32 (large_cnn); block 2: (C_in, C) =
// (64, 128) or (32, 64).
//
// The weight ring. Every CTA streams its weight slices in the order it uses
// them. Packed as hi and lo they would be twice the bytes (block 2 at 64 ->
// 128: 1.77 MB a CTA, 3.5 GB of L2 reads a call at the flagship), so the
// stream carries the f32 weights and the loading threads split their share
// in registers on the way into the stage: a slice is loaded one slice ahead
// (16-byte loads) and written, split, into a ring of hi and lo core-matrix
// stages, one __syncthreads a slice. The barrier comes first: once every
// thread has passed the one of slice s, every warpgroup has retired its
// MMAs of slice s - 2 (each k8 step waits for the one before it), so slice
// s + 1 may overwrite that stage with three stages. Multicasting a slice to
// a cluster would cut the bytes too, at a cluster-wide barrier a slice;
// PERF.md measures what the stream costs (cli/tf32_ablation.py).
//
// Block 1 at the flagship ([8, 800, 161] -> [8, 400, 80, 64]): 7.715e10
// flop, three tf32 passes of it 0.468 ms at 495 TFLOP/s (operations; f32
// FMAs on the CUDA cores could not go below 1.152 ms). Conv 1 (1.5 % of
// it) stays nine exact f32 FMAs per output on the CUDA cores, thread =
// (position, 8 channels: 4 c + (0..3) and C/2 + 4 c + (0..3), so a quarter
// warp's 16-byte stores cover 32 banks). Conv 2 (C -> C) is the implicit
// GEMM. w2 (147 KB at C 64) would be 295 KB as hi + lo, more than a block's
// shared memory, so it streams through a 3-stage ring of [C][16] slices
// (4 KB f32; 8 KB a stage). The one-channel input tile costs nothing, so
// the conv-2 tile is 16 t x 16 f (pooled 8 x 8; 4000 CTAs at the
// flagship): input 20 x 20, conv-1 tile 18 x 18 at a row pitch of C + 4
// floats (88 KB), ring 24 KB: 112 KB, two CTAs (16 warps) a SM, so one
// CTA's prologue, conv 1 and epilogue overlap the other's MMAs. Each
// warpgroup runs 2 m64 tiles of conv 2 over all C (64 accumulators a
// thread at C 64). The weight stream is 147 KB a CTA, 590 MB of L2 reads a
// call, overlapped with the MMAs. The other candidate, a 32 x 16 tile (the
// bf16 block 1's: 194 KB, one CTA a SM, 128 accumulators, half the stream
// and 6 % less conv-1 halo), took 218 registers and 19 % more time than
// this tile's 124 registers (both without spills; cli/tf32_ablation.py on
// an H100 SXM at 700 W, PERF.md). What bounds it there: the A fragments'
// shared loads and splits, which alone take over half of its time.
//
// Block 2 at the flagship ([8, 400, 80, 64] -> 128): 1.1325e11 flop, 0.686
// ms in three tf32 passes. f32 doubles bf16's bytes, so vgg_tc's 16 x 16
// conv-2 tile (input 20 x 20 x 64 and conv-1 18 x 18 x 128 in f32: 102 KB
// + 166 KB) does not fit. This kernel takes a conv-2 tile of 8 t x 16 f
// (pooled 4 x 8; 2000 CTAs): input 12 x 20 (61 KB at a row pitch of C_in +
// 4 floats), conv-1 tile 10 x 18 (93 KB at C + 4), weight stages 4 x 16 KB
// (hi, lo): 221 KB, 1 CTA (8 warps) a SM. The halo: conv 1 runs on 180
// positions (3 m64 tiles, 192 rows) for 128 conv-2 positions, 1.5x conv
// 1's useful work, 1.17x the block's. Conv 1 gives each warpgroup half of
// the C output channels over all 3 m64 tiles (96 accumulators a thread at
// C = 128); conv 2 gives each one m64 tile over all C (64).
//
// Every A row pitch is 4 mod 32 floats, so the 8 positions of an A load hit
// 8 different bank quads; A fragments come by 32-bit shared loads and are
// split into hi and lo in registers.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;  // 2 warpgroups
constexpr int KC = 16;        // k of a weight slice

// Weight slices of N output channels ([N][16] f32 in core matrices, HALF
// floats), streamed into a ring of STAGES hi + lo stages.
template <int N, int STAGES>
struct Ring {
  static constexpr int HALF = N * KC;           // floats of a slice
  static constexpr int SL = 2 * HALF;           // hi + lo: a stage
  static constexpr int F4 = HALF / 4;           // float4s of a slice
  static constexpr int LOADERS = F4 < THREADS ? F4 : THREADS;
  static constexpr int PER = F4 / LOADERS;      // float4s a loader
  static constexpr size_t BYTES = sizeof(float) * STAGES * SL;
  static_assert(PER * LOADERS == F4, "a slice over the loaders");
  static_assert(STAGES >= 3, "a stage is rewritten 3 slices after use");

  // This thread's float4s of slice s into registers.
  static __device__ __forceinline__ void load(const float* __restrict__ wp,
                                              int s, float4 (&w)[PER],
                                              int tid) {
    if (tid >= LOADERS) return;
    const float4* src =
        reinterpret_cast<const float4*>(wp + (size_t)s * HALF);
#pragma unroll
    for (int i = 0; i < PER; ++i) w[i] = __ldg(src + tid + LOADERS * i);
  }

  // The registers' slice, split, into a stage (hi at the float4's own
  // offset, lo at the same offset of the stage's second half), fenced for
  // wgmma's async proxy; a later barrier publishes it.
  static __device__ __forceinline__ void store(const float4 (&w)[PER],
                                               float* stage, int tid) {
    if (tid < LOADERS) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        uint4 hi, lo;
        split(w[i].x, hi.x, lo.x);
        split(w[i].y, hi.y, lo.y);
        split(w[i].z, hi.z, lo.z);
        split(w[i].w, hi.w, lo.w);
        const int e = tid + LOADERS * i;
        reinterpret_cast<uint4*>(stage)[e] = hi;
        reinterpret_cast<uint4*>(stage + HALF)[e] = lo;
      }
    }
    fence_async_smem();
  }

  // Wait until every thread has written slice s and retired slice s - 2's
  // MMAs; write slice s + 1 (in w) into its stage, then load slice s + 2
  // into w (after the fence, which would otherwise wait for those loads
  // too); returns the shared address of the stage holding slice s (of ns).
  static __device__ __forceinline__ uint32_t next(const float* wp, int s,
                                                  int ns, float4 (&w)[PER],
                                                  float* stg, int tid) {
    __syncthreads();
    if (s + 1 < ns) store(w, stg + ((s + 1) % STAGES) * SL, tid);
    if (s + 2 < ns) load(wp, s + 2, w, tid);
    return smem_u32(stg + (s % STAGES) * SL);
  }
};

// Conv 2 of a block, all C output channels, into acc: m64 tile m of this
// warpgroup holds this warp's m16 row block mi0 + 4 m, which is time rows
// 2 (mi / 2) + (0, 1) and freq columns 8 (mi % 2) + g of a conv-2 tile 16
// columns wide. act: the conv-1 tile, rows of C1 positions at a pitch of AP
// floats, one position before the conv-2 tile in t and f. The weights are
// slices s0 .. s0 + 9 C/16 - 1 of the ring (ns in all); the barrier of the
// first orders the act tile's writes before these reads.
template <int C, int MT, int C1, int AP, int STAGES>
__device__ __forceinline__ void conv2(const float* act, const float* wp,
                                      int s0, int ns,
                                      float4 (&w)[Ring<C, STAGES>::PER],
                                      float* stg, int mi0, int tid,
                                      float (&acc)[MT][C / 2]) {
  using R = Ring<C, STAGES>;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const float* a2e[MT];  // (row g, k q) of the t-even row; t odd: + C1 AP
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mi = mi0 + 4 * m;
    a2e[m] = act + (2 * (mi >> 1) * C1 + 8 * (mi & 1) + g) * AP + q;
  }
  zero(acc);
  int s = s0;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * C1 + tap % 3) * AP;
#pragma unroll 1
    for (int kc = 0; kc < C / KC; ++kc, ++s) {
      const uint32_t stage = R::next(wp, s, ns, w, stg, tid);
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int k = off + kc * KC + ks * 8;
        uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_split(a2e[m] + k, a2e[m] + C1 * AP + k, hi[m], lo[m]);
        wg_fence();
        const uint64_t b_hi = b_desc(stage + ks * 256, KC * 32);
        const uint64_t b_lo = b_desc(stage + R::HALF * 4 + ks * 256, KC * 32);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma3<C>(acc[m], hi[m], lo[m], b_hi, b_lo);
        wg_commit();
        wg_wait<1>();
      }
    }
  }
  wg_wait<0>();
  pin(acc);
}

// After conv 2: the 2x2 pool of acc (rows g, t even, and g + 8, t odd, in
// registers; f ^ 1 in lane ^ 4), then bias + ReLU, stored f32 at pooled
// (pt0 + mi / 2, pf0 + 4 (mi % 2) + g / 2) of outb [TP][FP][C] where that
// lies inside the floored output.
template <int C, int MT>
__device__ __forceinline__ void pool_store(const float (&acc)[MT][C / 2],
                                           int mi0, int pt0, int pf0,
                                           int lane,
                                           const float* __restrict__ b2,
                                           float* __restrict__ outb, int TP,
                                           int FP) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mi = mi0 + 4 * m;
    const int pt = pt0 + (mi >> 1), pf = pf0 + 4 * (mi & 1) + (g >> 1);
    const bool store = !(g & 1) && pt < TP && pf < FP;
    float* o = outb + ((size_t)pt * FP + pf) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      float m0 = fmaxf(acc[m][4 * j], acc[m][4 * j + 2]);  // t even, t odd
      float m1 = fmaxf(acc[m][4 * j + 1], acc[m][4 * j + 3]);
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));  // f ^ 1
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
      if (store) {
        const int c = 8 * j + 2 * q;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + c));
        *reinterpret_cast<float2*>(o + c) =
            make_float2(fmaxf(m0 + bias.x, 0.f), fmaxf(m1 + bias.y, 0.f));
      }
    }
  }
}

// ---------------------------------------------------------------- block 1

template <int C>
struct B1F {
  static constexpr int TT = 16, TF = 16;  // block 1's conv-2 tile
  static constexpr int CTAS = 2;          // block 1's CTAs a SM
  static constexpr int STAGES = 3;
  static constexpr int R1 = TT + 2, C1 = TF + 2;  // conv-1 tile
  static constexpr int R0 = TT + 4, C0 = TF + 4;  // input tile
  static constexpr int AP = C + 4;                // act row pitch (floats)
  static constexpr int M1 = R1 * C1;
  static constexpr int MT = TT * TF / 128;  // conv-2 m64 tiles a warpgroup
  static constexpr int CG = C / 8;          // conv 1: 8 channels a thread
  static constexpr int NS = 9 * C / KC;     // conv-2 slices
  using R = Ring<C, STAGES>;
  static constexpr size_t SMEM =
      R::BYTES + sizeof(float) * ((size_t)M1 * AP + R0 * C0);
  static_assert(AP % 32 == 4, "conflict-free A loads");
  static_assert(TF == 16 && MT * 128 == TT * TF, "m16 blocks: 2 t x 8 f");
  static_assert(THREADS % CG == 0 && C % KC == 0, "channel tiling");
  static_assert(CTAS * (SMEM + 1024) <= 233472, "CTAS blocks a SM");
};

// grid: (ceil(FP/8), ceil(TP/(TT/2)), B); w1 HWIO [3(f)][3(t)][1][C] f32;
// wp conv 2's slices (ops/vgg.py:pack_block1_f32tc).
template <int C>
__global__ void __launch_bounds__(THREADS, B1F<C>::CTAS)
    vgg_block1_f32tc_kernel(const float* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ wp,
                            const float* __restrict__ b2,
                            float* __restrict__ out, int T, int F) {
  using K = B1F<C>;
  using R = typename K::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stg = reinterpret_cast<float*>(smem);
  float* act = stg + K::STAGES * R::SL;
  float* xs = act + K::M1 * K::AP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int b = blockIdx.z, t0 = blockIdx.y * K::TT, f0 = blockIdx.x * K::TF;
  const int TP = T / 2, FP = F / 2;

  // prologue: slice 0 split into its stage, slice 1 into registers, the
  // input tile (zeros outside the image)
  float4 w[R::PER];
  R::load(wp, 0, w, tid);
  const float* xb = x + (size_t)b * T * F;
  for (int e = tid; e < K::R0 * K::C0; e += THREADS) {
    const int t = t0 - 2 + e / K::C0, f = f0 - 2 + e % K::C0;
    xs[e] = (t >= 0 && t < T && f >= 0 && f < F)
                ? __ldg(xb + (size_t)t * F + f)
                : 0.f;
  }
  R::store(w, stg, tid);
  R::load(wp, 1, w, tid);
  __syncthreads();

  // conv 1 + bias + ReLU over the R1 x C1 tile, nine f32 FMAs an output in
  // tap order; zero outside the image
  {
    const int cg = tid % K::CG;
    float wk[9][8], bias[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * (C / 2) + 4 * cg;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {  // tap = dt * 3 + df
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            w1 + ((tap % 3) * 3 + tap / 3) * C + c));
        wk[tap][4 * h] = v.x, wk[tap][4 * h + 1] = v.y;
        wk[tap][4 * h + 2] = v.z, wk[tap][4 * h + 3] = v.w;
      }
      const float4 v = __ldg(reinterpret_cast<const float4*>(b1 + c));
      bias[4 * h] = v.x, bias[4 * h + 1] = v.y;
      bias[4 * h + 2] = v.z, bias[4 * h + 3] = v.w;
    }
    for (int p = tid / K::CG; p < K::M1; p += THREADS / K::CG) {
      const int pr = p / K::C1, pc = p % K::C1;
      const int t = t0 - 1 + pr, f = f0 - 1 + pc;
      const bool in = t >= 0 && t < T && f >= 0 && f < F;
      float xv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        xv[tap] = xs[(pr + tap / 3) * K::C0 + pc + tap % 3];
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) s = fmaf(xv[tap], wk[tap][j], s);
        y[j] = in ? fmaxf(s + bias[j], 0.f) : 0.f;
      }
      float* a = act + p * K::AP + 4 * cg;
      *reinterpret_cast<float4*>(a) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(a + C / 2) =
          make_float4(y[4], y[5], y[6], y[7]);
    }
  }

  const int mi0 = 4 * K::MT * wg + wl;
  float acc[K::MT][C / 2];
  conv2<C, K::MT, K::C1, K::AP, K::STAGES>(act, wp, 0, K::NS, w, stg, mi0,
                                           tid, acc);
  pool_store<C, K::MT>(acc, mi0, t0 / 2, f0 / 2, lane, b2,
                       out + (size_t)b * TP * FP * C, TP, FP);
}

// ---------------------------------------------------------------- block 2

template <int CIN, int C>
struct B2F {
  static constexpr int TT = 8, TF = 16;           // conv-2 tile
  static constexpr int R1 = TT + 2, C1 = TF + 2;  // conv-1 tile
  static constexpr int R0 = TT + 4, C0 = TF + 4;  // input tile
  static constexpr int IP = CIN + 4, AP = C + 4;  // row pitches (floats)
  static constexpr int M1 = R1 * C1;
  static constexpr int MT1 = (M1 + 63) / 64;      // conv-1 m64 tiles
  static constexpr int N1 = C / 2;                // conv-1 N a warpgroup
  static constexpr int NS1 = 9 * CIN / KC, NS = NS1 + 9 * C / KC;
  static constexpr int STAGES = 4;
  using R = Ring<C, STAGES>;
  static constexpr size_t SMEM =
      R::BYTES + sizeof(float) * ((size_t)R0 * C0 * IP + R1 * C1 * AP);
  static_assert(CIN % KC == 0 && C % KC == 0, "channel tiling");
  static_assert(IP % 32 == 4 && AP % 32 == 4, "conflict-free A loads");
  static_assert(2 * 64 == TT * TF, "2 warpgroups x 1 conv-2 m64 tile");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// grid: (ceil(FP/8), ceil(TP/4), B)
template <int CIN, int C>
__global__ void __launch_bounds__(THREADS, 1)
    vgg_block2_f32tc_kernel(const float* __restrict__ x,
                            const float* __restrict__ wp,
                            const float* __restrict__ b1,
                            const float* __restrict__ b2,
                            float* __restrict__ out, int T, int F) {
  using K = B2F<CIN, C>;
  using R = typename K::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stg = reinterpret_cast<float*>(smem);
  float* xs = stg + K::STAGES * R::SL;
  float* act = xs + K::R0 * K::C0 * K::IP;
  const uint32_t xs_u = smem_u32(xs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, t0 = blockIdx.y * K::TT, f0 = blockIdx.x * K::TF;
  const int TP = T / 2, FP = F / 2;

  // prologue: input tile (zeros outside the image), slice 0 split into
  // its stage, slice 1 into registers
  float4 w[R::PER];
  {
    constexpr int CH = CIN / 4;
    const float* xb = x + (size_t)b * T * F * CIN;
    for (int e = tid; e < K::R0 * K::C0 * CH; e += THREADS) {
      const int ch = e % CH, p = e / CH;
      const int t = t0 - 2 + p / K::C0, f = f0 - 2 + p % K::C0;
      const bool in = t >= 0 && t < T && f >= 0 && f < F;
      cp_async16(xs_u + (p * K::IP + ch * 4) * 4,
                 in ? xb + ((size_t)t * F + f) * CIN + ch * 4 : xb,
                 in ? 16 : 0);
    }
    cp_async_commit();
    R::load(wp, 0, w, tid);
    R::store(w, stg, tid);
    R::load(wp, 1, w, tid);
    cp_async_wait<0>();  // the first R::next barrier publishes the tile
  }

  int s = 0;
  // conv 1 over the R1 x C1 tile, positions row-major; warpgroup wg owns
  // output channels [wg * N1, (wg + 1) * N1) of all MT1 m64 tiles, this
  // warp their m16 row blocks 4m + wl
  {
    const float* a1[K::MT1][2];
#pragma unroll
    for (int m = 0; m < K::MT1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = min(16 * (4 * m + wl) + g + 8 * hh, K::M1 - 1);
        a1[m][hh] = xs + ((p / K::C1) * K::C0 + p % K::C1) * K::IP + q;
      }
    float acc[K::MT1][K::N1 / 2];
    zero(acc);
    const uint32_t half = wg * (K::N1 / 8) * (KC / 4) * 128;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * K::C0 + tap % 3) * K::IP;
#pragma unroll 1
      for (int kc = 0; kc < CIN / KC; ++kc, ++s) {
        const uint32_t stage = R::next(wp, s, K::NS, w, stg, tid);
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          const int k = off + kc * KC + ks * 8;
          uint32_t hi[K::MT1][4], lo[K::MT1][4];
#pragma unroll
          for (int m = 0; m < K::MT1; ++m)
            load_split(a1[m][0] + k, a1[m][1] + k, hi[m], lo[m]);
          wg_fence();
          const uint64_t b_hi = b_desc(stage + half + ks * 256, KC * 32);
          const uint64_t b_lo =
              b_desc(stage + R::HALF * 4 + half + ks * 256, KC * 32);
#pragma unroll
          for (int m = 0; m < K::MT1; ++m)
            mma3<K::N1>(acc[m], hi[m], lo[m], b_hi, b_lo);
          wg_commit();
          wg_wait<1>();
        }
      }
    }
    wg_wait<0>();
    pin(acc);
    // bias + ReLU, zero outside the image, into the act tile
#pragma unroll
    for (int m = 0; m < K::MT1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * (4 * m + wl) + g + 8 * hh;
        if (p >= K::M1) continue;
        const int t = t0 - 1 + p / K::C1, f = f0 - 1 + p % K::C1;
        const bool in = t >= 0 && t < T && f >= 0 && f < F;
#pragma unroll
        for (int j = 0; j < K::N1 / 8; ++j) {
          const int c = wg * K::N1 + 8 * j + 2 * q;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + c));
          *reinterpret_cast<float2*>(act + p * K::AP + c) =
              in ? make_float2(fmaxf(acc[m][4 * j + 2 * hh] + bias.x, 0.f),
                               fmaxf(acc[m][4 * j + 2 * hh + 1] + bias.y, 0.f))
                 : make_float2(0.f, 0.f);
        }
      }
  }

  // conv 2 over the TT x TF tile, all C channels; warpgroup wg owns m64
  // tile wg, this warp m16 row block 4 wg + wl
  float acc[1][C / 2];
  conv2<C, 1, K::C1, K::AP, K::STAGES>(act, wp, K::NS1, K::NS, w, stg,
                                       4 * wg + wl, tid, acc);
  pool_store<C, 1>(acc, 4 * wg + wl, t0 / 2, f0 / 2, lane, b2,
                   out + (size_t)b * TP * FP * C, TP, FP);
}

// Sets the kernel's dynamic shared memory (and the carveout that lets
// several CTAs share a SM), then launches it; returns the CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int C>
int launch_block1(const float* x, const float* w1, const float* b1,
                  const float* wp, const float* b2, float* out, int B, int T,
                  int F, cudaStream_t stream) {
  using K = B1F<C>;
  const dim3 grid((F / 2 + K::TF / 2 - 1) / (K::TF / 2),
                  (T / 2 + K::TT / 2 - 1) / (K::TT / 2), B);
  return launch(vgg_block1_f32tc_kernel<C>, K::SMEM, grid, stream, x, w1, b1,
                wp, b2, out, T, F);
}

template <int CIN, int C>
int launch_block2(const float* x, const float* wp, const float* b1,
                  const float* b2, float* out, int B, int T, int F,
                  cudaStream_t stream) {
  using K = B2F<CIN, C>;
  const dim3 grid((F / 2 + K::TF / 2 - 1) / (K::TF / 2),
                  (T / 2 + K::TT / 2 - 1) / (K::TT / 2), B);
  return launch(vgg_block2_f32tc_kernel<CIN, C>, K::SMEM, grid, stream, x,
                wp, b1, b2, out, T, F);
}

}  // namespace

// Block 1: x f32 [B, T, F]; w1 f32 HWIO [3, 3, 1, C]; wp f32 conv-2 slices
// (see the kernel); out f32 [B, T/2, F/2, C]. C = 64 or 32.
extern "C" int vgg_block1_f32tc(const float* x, const float* w1,
                                const float* b1, const float* wp,
                                const float* b2, float* out, int B, int T,
                                int F, int c, void* stream) {
  auto s = (cudaStream_t)stream;
  if (c == 64) return launch_block1<64>(x, w1, b1, wp, b2, out, B, T, F, s);
  if (c == 32) return launch_block1<32>(x, w1, b1, wp, b2, out, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}

// Block 2: x f32 [B, T, F, C_in]; wp f32 packed slices (see the kernel);
// out f32 [B, T/2, F/2, C]. (C_in, C) = (64, 128) or (32, 64).
extern "C" int vgg_block2_f32tc(const float* x, const float* wp,
                                const float* b1, const float* b2, float* out,
                                int B, int T, int F, int cin, int c,
                                void* stream) {
  auto s = (cudaStream_t)stream;
  if (cin == 64 && c == 128)
    return launch_block2<64, 128>(x, wp, b1, b2, out, B, T, F, s);
  if (cin == 32 && c == 64)
    return launch_block2<32, 64>(x, wp, b1, b2, out, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}
