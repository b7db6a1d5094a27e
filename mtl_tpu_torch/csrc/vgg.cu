// Fused VGG block 1 in f32: SAME conv3x3 + bias + ReLU -> SAME conv3x3 +
// bias + ReLU -> 2x2 VALID floor max-pool, one kernel.
//
// Replaces the Pallas TPU kernel mtl_tpu/ops/vgg_pallas.py:vgg_block1_fused
// (body _b1_kernel, C_in = 1) on the f32 route: the card's f32 parity path.
// (Block 2's f32 route is csrc/vgg_f32_tc.cu on 3xTF32 tensor cores; the
// bf16 route of both blocks, the model's compute dtype, is csrc/vgg_tc.cu.)
// As on the TPU, the conv-1 activation never goes to device memory: it
// lives in shared memory, in f32.
//
// Layouts: x f32 [B, T, F]; weights flax HWIO [3(f), 3(t), 1, C] with H =
// freq and W = time; out f32 [B, T/2, F/2, C].
//
// Work at the flagship serving shapes (B=8, T=800, F=161): 7.7e10 flop
// against ~70 MB of input and output, so it is compute-bound. This design runs
// f32 FMAs on the CUDA cores (bound 67 TFLOP/s).
//
// Design (what does not carry over from the TPU): a block has at most 227 KB
// of shared memory, so the grid tiles BOTH time and freq. A block owns PT x PF
// pooled outputs for all C channels: it stages the input tile with a 2-pixel
// halo (zeros outside the image), computes conv 1 on the tile with a 1-pixel
// halo into shared memory (positions outside the image are set to ZERO, not
// relu(b1): SAME padding of conv 2), then computes conv 2 in registers and
// pools there. The TPU's roll/selection-einsum tricks become direct indexing.
// Lane l of a warp owns channels JC*l .. JC*l+JC-1 (vector weight loads);
// a warp owns NP output positions, whose inputs are broadcast from shared
// memory. Conv 2's weights (9*64*64 f32) stream from L2/L1.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// JC consecutive f32 weights at p (16-, 8- or 4-byte aligned by construction)
template <int JC>
__device__ __forceinline__ void load_w(const float* __restrict__ p,
                                       float (&w)[JC]) {
  if constexpr (JC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (JC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < JC; ++j) w[j] = __ldg(p + j);
  }
}

// acc[j][p] += sum_{dt, df, ci} src[off[p] + dt*src_cols + df][ci]
//                               * w[df][dt][ci][JC*lane + j]
// src: shared [positions][CIN] f32, row-major (time rows, freq cols).
template <int CIN, int C, int NP>
__device__ __forceinline__ void conv_acc(const float* __restrict__ src,
                                         int src_cols, const int (&off)[NP],
                                         const float* __restrict__ w, int lane,
                                         float (&acc)[C / 32][NP]) {
  constexpr int JC = C / 32;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dt = tap / 3, df = tap % 3;
    const float* wt = w + (size_t)(df * 3 + dt) * CIN * C + JC * lane;
    const float* s = src + (dt * src_cols + df) * CIN;
    if constexpr (CIN % 4 == 0) {
#pragma unroll 2
      for (int ci = 0; ci < CIN; ci += 4) {
        float wv[4][JC];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_w<JC>(wt + (ci + u) * C, wv[u]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 xv =
              *reinterpret_cast<const float4*>(s + off[p] * CIN + ci);
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            acc[j][p] = fmaf(xv.x, wv[0][j], acc[j][p]);
            acc[j][p] = fmaf(xv.y, wv[1][j], acc[j][p]);
            acc[j][p] = fmaf(xv.z, wv[2][j], acc[j][p]);
            acc[j][p] = fmaf(xv.w, wv[3][j], acc[j][p]);
          }
        }
      }
    } else {
      for (int ci = 0; ci < CIN; ++ci) {
        float wv[JC];
        load_w<JC>(wt + ci * C, wv);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float xv = s[off[p] * CIN + ci];
#pragma unroll
          for (int j = 0; j < JC; ++j) acc[j][p] = fmaf(xv, wv[j], acc[j][p]);
        }
      }
    }
  }
}

template <int CIN, int C, int PT, int PF>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((2 * PT + 4) * (2 * PF + 4) * CIN + (2 * PT + 2) * (2 * PF + 2) * C);
}

// grid: (ceil((T/2)/PT), ceil((F/2)/PF), B); block: THREADS
template <int CIN, int C, int PT, int PF, int NP>
__global__ void __launch_bounds__(THREADS) vgg_block_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int T, int F) {
  constexpr int JC = C / 32;
  constexpr int R2 = 2 * PT, C2 = 2 * PF;  // conv-2 region
  constexpr int R1 = R2 + 2, C1 = C2 + 2;  // conv-1 region (1-pixel halo)
  constexpr int R0 = R2 + 4, C0 = C2 + 4;  // input region (2-pixel halo)
  constexpr int N1 = R1 * C1;
  constexpr int HALF = NP / 2;             // conv-2 chunk: 2 rows x HALF cols
  constexpr int NCG = C2 / HALF;
  static_assert(C % 32 == 0 && NP % 4 == 0 && C2 % HALF == 0, "tiling");

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [R0*C0][CIN]
  float* ys = xs + R0 * C0 * CIN;               // [R1*C1][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * R2, f0 = blockIdx.y * C2;
  const int TP = T / 2, FP = F / 2;

  const float* xb = x + (size_t)b * T * F * CIN;
  for (int e = tid; e < R0 * C0 * CIN; e += THREADS) {
    const int ci = e % CIN, q = e / CIN;
    const int t = t0 - 2 + q / C0, f = f0 - 2 + q % C0;
    float v = 0.f;
    if (t >= 0 && t < T && f >= 0 && f < F)
      v = xb[((size_t)t * F + f) * CIN + ci];
    xs[e] = v;
  }
  __syncthreads();

  // conv 1 + bias + ReLU over the R1 x C1 region; zero outside the image
  for (int base = warp * NP; base < N1; base += WARPS * NP) {
    int off[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = min(base + p, N1 - 1);
      off[p] = (q / C1) * C0 + q % C1;
    }
    float acc[JC][NP];
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[j][p] = 0.f;
    conv_acc<CIN, C, NP>(xs, C0, off, w1, lane, acc);
    float bias[JC];
    load_w<JC>(b1 + JC * lane, bias);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = base + p;
      if (q >= N1) break;
      const int t = t0 - 1 + q / C1, f = f0 - 1 + q % C1;
      const bool in = t >= 0 && t < T && f >= 0 && f < F;
#pragma unroll
      for (int j = 0; j < JC; ++j)
        ys[q * C + JC * lane + j] = in ? fmaxf(acc[j][p] + bias[j], 0.f) : 0.f;
    }
  }
  __syncthreads();

  // conv 2 over chunks of 2 rows x HALF cols, then pool in registers:
  // max first, then bias and ReLU (both monotone, so the order is exact)
  float bias[JC];
  load_w<JC>(b2 + JC * lane, bias);
  for (int chunk = warp; chunk < PT * NCG; chunk += WARPS) {
    const int rp = chunk / NCG, cg = chunk % NCG;
    int off[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      off[p] = (2 * rp + p / HALF) * C1 + cg * HALF + p % HALF;
    float acc[JC][NP];
#pragma unroll
    for (int j = 0; j < JC; ++j)
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[j][p] = 0.f;
    conv_acc<C, C, NP>(ys, C1, off, w2, lane, acc);
    const int pt = blockIdx.x * PT + rp;
    if (pt >= TP) continue;
#pragma unroll
    for (int k = 0; k < HALF / 2; ++k) {
      const int pf = blockIdx.y * PF + cg * (HALF / 2) + k;
      if (pf >= FP) break;
      float* o = out + (((size_t)b * TP + pt) * FP + pf) * C + JC * lane;
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const float m = fmaxf(fmaxf(acc[j][2 * k], acc[j][2 * k + 1]),
                              fmaxf(acc[j][HALF + 2 * k],
                                    acc[j][HALF + 2 * k + 1]));
        o[j] = fmaxf(m + bias[j], 0.f);
      }
    }
  }
}

template <int CIN, int C, int PT, int PF, int NP>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int B, int T, int F,
           cudaStream_t stream) {
  auto kernel = vgg_block_kernel<CIN, C, PT, PF, NP>;
  constexpr size_t smem = smem_bytes<CIN, C, PT, PF>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T / 2 + PT - 1) / PT, (F / 2 + PF - 1) / PF, B);
  kernel<<<grid, THREADS, smem, stream>>>(x, w1, b1, w2, b2, out, T, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Block 1 (C_in = 1): x f32 [B, T, F]; out f32 [B, T/2, F/2, C].
extern "C" int vgg_block1_fwd(const float* x, const float* w1, const float* b1,
                              const float* w2, const float* b2, float* out,
                              int B, int T, int F, int c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 64)
    return launch<1, 64, 8, 8, 16>(x, w1, b1, w2, b2, out, B, T, F, s);
  if (c == 32)
    return launch<1, 32, 8, 8, 16>(x, w1, b1, w2, b2, out, B, T, F, s);
  return (int)cudaErrorInvalidValue;
}
