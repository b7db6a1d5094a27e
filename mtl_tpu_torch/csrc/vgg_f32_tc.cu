// Fused VGG block 2 in f32 on TF32 tensor cores at f32 accuracy (3xTF32,
// csrc/tf32x3.cuh): SAME conv3x3 + bias + ReLU -> SAME conv3x3 + bias + ReLU
// -> 2x2 VALID floor max-pool, one kernel.
//
// Replaces the Pallas TPU kernel mtl_tpu/ops/vgg_pallas.py:vgg_block2_fused
// (body _b2_kernel, C_in > 1) on the f32 route, the card's f32 parity path
// (counted as vgg_block2_f32; block 1's f32 route stays csrc/vgg.cu, the
// bf16 route of both is csrc/vgg_tc.cu). The structure is vgg_tc.cu's block
// 2 with f32 tiles: both convs as implicit GEMMs, the conv-1 activation kept
// in shared memory (f32), conv-1 positions outside the image set to ZERO
// (SAME padding of conv 2), the t-parity row order (an m16 row block is 2
// time rows x 8 freq columns, so the 2x2 pool is one max in registers and
// one __shfl_xor), pool first, then bias and ReLU (both monotone: exact).
// Every product takes the three tf32 passes.
//
// Layouts: x f32 [B, T, F, C_in]; out f32 [B, T/2, F/2, C]. The wrapper
// (ops/vgg.py:pack_block2_f32tc) packs the flax HWIO weights into the
// stream of slices the kernel uses in order, each a (tap, 16-channel k
// chunk) of one conv as an [n = C][k = 16] f32 matrix in core matrices
// [C/8][4][8][4]: conv 1's 9 * C_in/16 slices, then conv 2's 9 * C/16.
// (C_in, C) = (64, 128) (vgg_cnn) or (32, 64) (large_cnn).
//
// Bound at the flagship's block 2 ([8, 400, 80, 64] -> 128): 1.1325e11
// flop, three tf32 passes of it 0.686 ms at 495 TFLOP/s (operations).
//
// Tiles. f32 doubles bf16's bytes, so vgg_tc's 16 x 16 conv-2 tile (input
// 20 x 20 x 64 and conv-1 18 x 18 x 128 in f32: 102 KB + 166 KB) does not
// fit the 227 KB of a block. This kernel takes a conv-2 tile of 8 t x 16 f
// (pooled 4 x 8; 2000 CTAs at the flagship): input 12 x 20 (61 KB at a row
// pitch of C_in + 4 floats), conv-1 tile 10 x 18 (93 KB at C + 4), weight
// stages 4 x 16 KB (hi, lo): 221 KB, 1 CTA (8 warps) a SM. The halo: conv
// 1 runs on 180 positions (3 m64 tiles, 192 rows) for 128 conv-2
// positions, 1.5x conv 1's useful work, 1.17x the block's. Every A row
// pitch is 4 mod 32 floats, so the 8 positions of an A load hit 8
// different bank quads.
//
// Work split, 2 warpgroups: conv 1 gives each warpgroup half of the C
// output channels over all 3 m64 tiles (96 accumulators a thread at C =
// 128); conv 2 gives each one m64 tile over all C (64). A fragments come
// by 32-bit shared loads and are split into hi and lo in registers.
//
// Weights: every CTA streams all of them, one slice at a time in the order
// they are used. Packed as hi and lo they would be 1.77 MB a CTA (64 ->
// 128), 3.5 GB of L2 reads a call at the flagship, ~0.64 ms at the ~5.5
// TB/s of L2, as long as the MMAs' bound. So the stream carries the f32
// weights (885 KB a CTA, half the bytes) and each thread splits its share
// in registers on the way into the stage: a slice is loaded (two 16-byte
// loads a thread) one slice ahead and written, split, into a 4-stage ring
// of hi and lo core matrices (a stage is rewritten three slices after its
// MMAs were issued: by then every warp has retired them, since each k8
// step waits for the one before it and every warp has passed the next
// slice's barrier), one __syncthreads a slice. Multicasting a slice to a
// cluster would cut the bytes too, at a cluster-wide barrier a slice (108
// a tile); PERF.md measures what the stream costs (cli/tf32_ablation.py).

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 256;  // 2 warpgroups

template <int CIN, int C>
struct B2F {
  static constexpr int TT = 8, TF = 16;           // conv-2 tile
  static constexpr int R1 = TT + 2, C1 = TF + 2;  // conv-1 tile
  static constexpr int R0 = TT + 4, C0 = TF + 4;  // input tile
  static constexpr int IP = CIN + 4, AP = C + 4;  // row pitches (floats)
  static constexpr int M1 = R1 * C1;
  static constexpr int MT1 = (M1 + 63) / 64;      // conv-1 m64 tiles
  static constexpr int N1 = C / 2;                // conv-1 N a warpgroup
  static constexpr int KC = 16;                   // k of a slice
  static constexpr int NS1 = 9 * CIN / KC, NS = NS1 + 9 * C / KC;
  static constexpr int HALF = C / 8 * (KC / 4) * 32;  // floats of a slice
  static constexpr int SL = 2 * HALF;                  // hi + lo: a stage
  static constexpr int PER = HALF / 4 / THREADS;       // float4s a thread
  static constexpr int STAGES = 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)R0 * C0 * IP + R1 * C1 * AP + STAGES * SL);
  static_assert(CIN % KC == 0 && C % KC == 0, "channel tiling");
  static_assert(IP % 32 == 4 && AP % 32 == 4, "conflict-free A loads");
  static_assert(2 * 64 == TT * TF, "2 warpgroups x 1 conv-2 m64 tile");
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(PER * 4 * THREADS == HALF, "a slice over the threads");
};

// This thread's float4s of f32 slice s into registers.
template <int CIN, int C>
__device__ __forceinline__ void load_slice(const float* __restrict__ wp,
                                           int s, float4 (&w)[B2F<CIN, C>::PER],
                                           int tid) {
  using K = B2F<CIN, C>;
  const float4* src = reinterpret_cast<const float4*>(wp + (size_t)s * K::HALF);
#pragma unroll
  for (int i = 0; i < K::PER; ++i) w[i] = __ldg(src + tid + THREADS * i);
}

// The registers' slice, split, into a stage: hi at the float4's own offset,
// lo at the same offset of the stage's second half.
template <int CIN, int C>
__device__ __forceinline__ void store_split(const float4 (&w)[B2F<CIN, C>::PER],
                                            float* stage, int tid) {
  using K = B2F<CIN, C>;
#pragma unroll
  for (int i = 0; i < K::PER; ++i) {
    uint4 hi, lo;
    split(w[i].x, hi.x, lo.x);
    split(w[i].y, hi.y, lo.y);
    split(w[i].z, hi.z, lo.z);
    split(w[i].w, hi.w, lo.w);
    const int e = tid + THREADS * i;
    reinterpret_cast<uint4*>(stage)[e] = hi;
    reinterpret_cast<uint4*>(stage + K::HALF)[e] = lo;
  }
}

// Write slice s + 1 (in w) into its stage, wait until every thread has
// written its stages, then load slice s + 2 into w (after the fence, which
// would otherwise wait for those loads too); returns the stage holding
// slice s.
template <int CIN, int C>
__device__ __forceinline__ uint32_t next_slice(const float* wp, int s,
                                               float4 (&w)[B2F<CIN, C>::PER],
                                               float* stg, int tid) {
  using K = B2F<CIN, C>;
  if (s + 1 < K::NS)
    store_split<CIN, C>(w, stg + ((s + 1) % K::STAGES) * K::SL, tid);
  fence_async_smem();
  __syncthreads();
  if (s + 2 < K::NS) load_slice<CIN, C>(wp, s + 2, w, tid);
  return smem_u32(stg + (s % K::STAGES) * K::SL);
}

// grid: (ceil(FP/8), ceil(TP/4), B)
template <int CIN, int C>
__global__ void __launch_bounds__(THREADS, 1)
    vgg_block2_f32tc_kernel(const float* __restrict__ x,
                            const float* __restrict__ wp,
                            const float* __restrict__ b1,
                            const float* __restrict__ b2,
                            float* __restrict__ out, int T, int F) {
  using K = B2F<CIN, C>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stg = reinterpret_cast<float*>(smem);
  float* xs = stg + K::STAGES * K::SL;
  float* act = xs + K::R0 * K::C0 * K::IP;
  const uint32_t xs_u = smem_u32(xs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, t0 = blockIdx.y * K::TT, f0 = blockIdx.x * K::TF;
  const int TP = T / 2, FP = F / 2;

  // prologue: input tile (zeros outside the image), slice 0 split into
  // its stage, slice 1 into registers
  float4 w[K::PER];
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
    load_slice<CIN, C>(wp, 0, w, tid);
    store_split<CIN, C>(w, stg, tid);
    load_slice<CIN, C>(wp, 1, w, tid);
    cp_async_wait<0>();  // the next_slice barrier publishes the tile
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
    const uint32_t half = wg * (K::N1 / 8) * (K::KC / 4) * 128;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * K::C0 + tap % 3) * K::IP;
#pragma unroll 1
      for (int kc = 0; kc < CIN / K::KC; ++kc, ++s) {
        const uint32_t stage = next_slice<CIN, C>(wp, s, w, stg, tid);
#pragma unroll
        for (int ks = 0; ks < K::KC / 8; ++ks) {
          const int k = off + kc * K::KC + ks * 8;
          uint32_t hi[K::MT1][4], lo[K::MT1][4];
#pragma unroll
          for (int m = 0; m < K::MT1; ++m)
            load_split(a1[m][0] + k, a1[m][1] + k, hi[m], lo[m]);
          wg_fence();
          const uint64_t b_hi = b_desc(stage + half + ks * 256, K::KC * 32);
          const uint64_t b_lo =
              b_desc(stage + K::HALF * 4 + half + ks * 256, K::KC * 32);
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
  // tile wg, this warp m16 row block mi = 4 wg + wl: time rows
  // 2 (mi / 2) + (0, 1), freq columns 8 (mi % 2) + g. The first next_slice
  // barrier orders the act tile's writes before these reads.
  {
    const int mi = 4 * wg + wl;
    const int tr = 2 * (mi >> 1), fc = 8 * (mi & 1) + g;
    const float* a2e = act + (tr * K::C1 + fc) * K::AP + q;  // t even
    const float* a2o = a2e + K::C1 * K::AP;                   // t odd
    float acc[C / 2];
    zero(acc);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3) * K::C1 + tap % 3) * K::AP;
#pragma unroll 1
      for (int kc = 0; kc < C / K::KC; ++kc, ++s) {
        const uint32_t stage = next_slice<CIN, C>(wp, s, w, stg, tid);
#pragma unroll
        for (int ks = 0; ks < K::KC / 8; ++ks) {
          const int k = off + kc * K::KC + ks * 8;
          uint32_t hi[4], lo[4];
          load_split(a2e + k, a2o + k, hi, lo);
          wg_fence();
          const uint64_t b_hi = b_desc(stage + ks * 256, K::KC * 32);
          const uint64_t b_lo =
              b_desc(stage + K::HALF * 4 + ks * 256, K::KC * 32);
          mma3<C>(acc, hi, lo, b_hi, b_lo);
          wg_commit();
          wg_wait<1>();
        }
      }
    }
    wg_wait<0>();
    pin(acc);
    // 2x2 pool: rows g (t even) and g + 8 (t odd) in registers, f ^ 1 in
    // lane ^ 4; then bias + ReLU
    const int pt = t0 / 2 + (mi >> 1), pf = f0 / 2 + 4 * (mi & 1) + (g >> 1);
    const bool store = !(g & 1) && pt < TP && pf < FP;
    float* o = out + (((size_t)b * TP + pt) * FP + pf) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      float m0 = fmaxf(acc[4 * j], acc[4 * j + 2]);
      float m1 = fmaxf(acc[4 * j + 1], acc[4 * j + 3]);
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
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

template <int CIN, int C>
int launch(const float* x, const float* wp, const float* b1, const float* b2,
           float* out, int B, int T, int F, cudaStream_t stream) {
  using K = B2F<CIN, C>;
  auto kernel = vgg_block2_f32tc_kernel<CIN, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F / 2 + K::TF / 2 - 1) / (K::TF / 2),
                  (T / 2 + K::TT / 2 - 1) / (K::TT / 2), B);
  kernel<<<grid, THREADS, K::SMEM, stream>>>(x, wp, b1, b2, out, T, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x f32 [B, T, F, C_in]; wp f32 packed slices (see the kernel); out f32
// [B, T/2, F/2, C]. (C_in, C) = (64, 128) or (32, 64).
extern "C" int vgg_block2_f32tc(const float* x, const float* wp,
                                const float* b1, const float* b2, float* out,
                                int B, int T, int F, int cin, int c,
                                void* stream) {
  auto s = (cudaStream_t)stream;
  if (cin == 64 && c == 128)
    return launch<64, 128>(x, wp, b1, b2, out, B, T, F, s);
  if (cin == 32 && c == 64)
    return launch<32, 64>(x, wp, b1, b2, out, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}
