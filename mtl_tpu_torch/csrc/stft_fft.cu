// Windowed real FFT -> log1p magnitude, straight from the prepadded waveform.
//
// Replaces the Pallas TPU kernel mtl_tpu/ops/stft_pallas.py:stft_logmag_pallas
// (body _stft_kernel), for every n_fft whose half has no prime factor above 5
// (ops/stft.py:fft_plan picks the radices; csrc/stft.cu, the direct DFT,
// takes the other sizes). It computes
//   out[b, t, k] = log1p(|sum_n w[n] audio[b, t*hop + n] e^{-2 pi i nk/N}|)
// for k <= N/2, N = n_fft, with samples past the end of a row read as zeros
// (what frame_signal(prepadded=True) yields). f32 in, f32 out, f32 arithmetic
// on the CUDA cores.
//
// Bound: bytes. At the flagship serving shapes (B 8, T 800, N 320, hop 160)
// the kernel must read 4.10 MB of waveform and write 4.12 MB of output:
// ~2.5 us at 3.35 TB/s. The TPU kernel's form, the DFT as a GEMM against
// windowed cos/sin bases, needs 4*B*T*N*F = 1.32 GFLOP at f32 (>= 19.7 us at
// 67 TFLOP/s); as 3xTF32 on tensor cores still ~4 GFLOP (>= 8 us), and
// log1p amplifies the error of small bins, so plain TF32 is out. The FFT
// needs ~0.05 GFLOP (a packed N/2-point complex FFT plus the real split;
// 0.085 GFLOP as a full complex FFT of the real frame), < 1 us at the f32
// rate, and keeps f32 accuracy: the GEMM form is dropped.
//
// Design:
// * One warp per frame, 4 frames (consecutive t of one utterance) a CTA.
//   The warps never wait for each other: the only barrier is after the
//   CTA copies the twiddle table W_N^p (p < N; f32, computed in float64 by
//   the wrapper) and the window into shared memory. A warp reads its frame
//   from device memory as the first stage needs it; the half of each
//   frame that its neighbour also reads (hop = N/2) comes from L1 or L2,
//   so device memory is read about once. (A CTA-wide staging of the whole
//   span of its frames in shared memory, with barriers around it, measured
//   slower: PERF.md.)
// * Each warp packs its frame as z[m] = x[2m] + i x[2m+1] (window applied as
//   it loads) and runs an M = N/2 point Stockham FFT, one radix (2, 3, 4, 5
//   or 8) per stage, butterflies in registers, ping-pong between two shared
//   buffers of its own; stages need only __syncwarp. The radix-5 stage goes
//   first, where its stride-5 writes are bank-conflict-free. The common
//   (n_fft, plan) pairs are compiled as their own instances, so the stages
//   unroll and the index arithmetic folds to constants.
// * Epilogue: the real split X[k] = Xe + W_N^k Xo, X[M-k] = conj(Xe - W_N^k
//   Xo) gives both bins of a pair from Z[k] and Z[M-k]; log1pf(sqrtf(.)) is
//   stored straight to the frame's output row (coalesced: lanes take
//   consecutive k, and M - k). Frames past T return before any work.
//
// Shared memory (bytes), mirrored by ops/stft.py:fft_smem_bytes:
//   twiddles 8N | 2 buffers a frame 16 * frames * Mp, Mp = M rounded up to
//   even | window 4N.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_FRAMES = 4;     // frames (warps) per CTA
constexpr int MAX_STAGES = 7;     // radices packed 4 bits each
constexpr int MAX_SMEM = 232448;  // 227 KB a block can opt into

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_negi(float2 a) {  // -i * a
  return make_float2(a.y, -a.x);
}

// Forward DFTs of length R in registers (sign -1).
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = a + v[1];
  v[1] = a - v[1];
}

template <>
__device__ __forceinline__ void dft<3>(float2 (&v)[3]) {
  const float s = 0.866025403784438647f;  // sin(2 pi / 3)
  const float2 sum = v[1] + v[2];
  const float2 t = v[0] - scale(sum, 0.5f);
  const float2 u = mul_negi(scale(v[1] - v[2], s));
  v[0] = v[0] + sum;
  v[1] = t + u;
  v[2] = t - u;
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 a = v[0] + v[2], b = v[0] - v[2];
  const float2 c = v[1] + v[3], d = mul_negi(v[1] - v[3]);
  v[0] = a + c;
  v[1] = b + d;
  v[2] = a - c;
  v[3] = b - d;
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&v)[5]) {
  const float c1 = 0.309016994374947424f;   // cos(2 pi / 5)
  const float c2 = -0.809016994374947424f;  // cos(4 pi / 5)
  const float s1 = 0.951056516295153572f;   // sin(2 pi / 5)
  const float s2 = 0.587785252292473129f;   // sin(4 pi / 5)
  const float2 b1 = v[1] + v[4], b2 = v[2] + v[3];
  const float2 d1 = v[1] - v[4], d2 = v[2] - v[3];
  const float2 t1 = v[0] + scale(b1, c1) + scale(b2, c2);
  const float2 t2 = v[0] + scale(b1, c2) + scale(b2, c1);
  const float2 u1 = mul_negi(scale(d1, s1) + scale(d2, s2));
  const float2 u2 = mul_negi(scale(d1, s2) - scale(d2, s1));
  v[0] = v[0] + b1 + b2;
  v[1] = t1 + u1;
  v[4] = t1 - u1;
  v[2] = t2 + u2;
  v[3] = t2 - u2;
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  const float h = 0.707106781186547524f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));  // W8^1
  o[2] = mul_negi(o[2]);                                             // W8^2
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = e[k] + o[k];
    v[k + 4] = e[k] - o[k];
  }
}

// One Stockham stage of radix R over the warp's M-point sequence: butterfly
// j reads src[j + r*M/R], multiplies by W^{k r} (k = j mod Ns, the product of
// the earlier radices), transforms, and writes dst[(j/Ns)*Ns*R + k + r*Ns].
// The first stage reads the packed, windowed frame from device memory
// instead, with zeros from sample ``valid`` on.
template <int R, bool FIRST>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      const float* __restrict__ frame,
                                      const float2* __restrict__ win2,
                                      const float2* __restrict__ tw,
                                      float2* __restrict__ dst, int M, int N,
                                      int Ns, int lane, int valid) {
  const int nb = M / R;
  const int step = N / (Ns * R);  // W_{Ns R} = W_N^step
  for (int j = lane; j < nb; j += WARP) {
    float2 v[R];
    const int k = FIRST ? 0 : j % Ns;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * nb;
      if (FIRST) {
        const float2 w = win2[m];
        const float x0 = 2 * m < valid ? __ldg(frame + 2 * m) : 0.f;
        const float x1 = 2 * m + 1 < valid ? __ldg(frame + 2 * m + 1) : 0.f;
        v[r] = make_float2(w.x * x0, w.y * x1);
      } else {
        v[r] = src[m];
      }
    }
    if (!FIRST) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[k * r * step]);
    }
    dft<R>(v);
    const int base = FIRST ? j * R : (j / Ns) * Ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[base + r * Ns] = v[r];
  }
  __syncwarp();
}

template <bool FIRST>
__device__ void run_stage(int R, const float2* src, const float* frame,
                          const float2* win2, const float2* tw, float2* dst,
                          int M, int N, int Ns, int lane, int valid) {
  switch (R) {
#define STFT_STAGE(R) \
  stage<R, FIRST>(src, frame, win2, tw, dst, M, N, Ns, lane, valid)
    case 2: STFT_STAGE(2); break;
    case 3: STFT_STAGE(3); break;
    case 4: STFT_STAGE(4); break;
    case 5: STFT_STAGE(5); break;
    default: STFT_STAGE(8);
#undef STFT_STAGE
  }
}

// NC, PC: n_fft and the packed plan fixed at compile time (the common sizes,
// so that the stage loop unrolls and every index folds to constants), or
// 0, 0 for any n_fft and plan at run time.
template <int NC, unsigned PC>
__global__ void __launch_bounds__(WARP * MAX_FRAMES) stft_fft_kernel(
    const float* __restrict__ audio,   // [B, S] prepadded waveforms
    const float* __restrict__ window,  // [N]
    const float2* __restrict__ tw,     // [N] W_N^p
    float* __restrict__ out,           // [B, T, F]
    int S, int T, int n_fft, int hop, unsigned plan_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = NC ? NC : n_fft;
  const unsigned plan = NC ? PC : plan_rt;
  const int frames = blockDim.x / WARP;
  const int M = N / 2, F = M + 1, Mp = M + (M & 1);
  float2* tw_s = reinterpret_cast<float2*>(smem);
  float2* bufs = tw_s + N;
  float* win_s = reinterpret_cast<float*>(bufs + 2 * frames * Mp);
  const int tid = threadIdx.x, lane = tid % WARP, w = tid / WARP;
  for (int i = tid; i < N; i += blockDim.x) {
    tw_s[i] = tw[i];
    win_s[i] = window[i];
  }
  __syncthreads();
  const int b = blockIdx.y, t = blockIdx.x * frames + w;
  if (t >= T) return;
  const long long off = (long long)t * hop;
  const float* frame = audio + (long long)b * S + off;
  const int valid = (int)max(0LL, min((long long)N, (long long)S - off));

  int n_stages = 0;
  while (n_stages < MAX_STAGES && ((plan >> (4 * n_stages)) & 15u)) ++n_stages;
  const float2* win2 = reinterpret_cast<const float2*>(win_s);
  float2* dst = bufs + 2 * w * Mp;
  float2* src = dst + Mp;
  int Ns = 1;
  auto step = [&](int s) {
    const int R = (plan >> (4 * s)) & 15u;
    if (s == 0)
      run_stage<true>(R, nullptr, frame, win2, tw_s, dst, M, N, 1, lane,
                      valid);
    else
      run_stage<false>(R, src, frame, win2, tw_s, dst, M, N, Ns, lane,
                       valid);
    Ns *= R;
    float2* tmp = src;  // this stage's output is the next one's input
    src = dst;
    dst = tmp;
  };
  if constexpr (NC != 0) {
#pragma unroll
    for (int s = 0; s < MAX_STAGES; ++s)
      if (s < n_stages) step(s);
  } else {
    for (int s = 0; s < n_stages; ++s) step(s);
  }

  const float2* Z = src;
  float* o = out + ((long long)b * T + t) * F;
  for (int k = lane; k <= M / 2; k += WARP) {
    const float2 a = Z[k], c = Z[k == 0 ? 0 : M - k];
    // Xe = (Z[k] + conj Z[M-k]) / 2, Xo = -i (Z[k] - conj Z[M-k]) / 2
    const float2 xe = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
    const float2 xo = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
    const float2 p = cmul(tw_s[k], xo);
    const float2 lo = xe + p, hi = xe - p;  // X[k], conj X[M-k]
    o[k] = log1pf(sqrtf(lo.x * lo.x + lo.y * lo.y));
    if (k != M - k) o[M - k] = log1pf(sqrtf(hi.x * hi.x + hi.y * hi.y));
  }
}

template <int NC, unsigned PC>
int launch(const float* audio, const float* window, const float* tw,
           float* out, int B, int S, int T, int n_fft, int hop, int plan,
           int frames, long smem, cudaStream_t stream) {
  static long smem_opted = 48 * 1024;
  if (smem > smem_opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        stft_fft_kernel<NC, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted = smem;
  }
  const dim3 grid((T + frames - 1) / frames, B);
  stft_fft_kernel<NC, PC><<<grid, WARP * frames, smem, stream>>>(
      audio, window, reinterpret_cast<const float2*>(tw), out, S, T, n_fft,
      hop, (unsigned)plan);
  return (int)cudaGetLastError();
}

}  // namespace

// plan: the radices of the N/2-point FFT, 4 bits each from the lowest, 0
// after the last; frames_per_cta: 1..4 (ops/stft.py:fft_launch_shape).
extern "C" int stft_fft_f32(const float* audio, const float* window,
                            const float* tw, float* out, int B, int S, int T,
                            int n_fft, int hop, int plan, int frames_per_cta,
                            void* stream) {
  const int m = n_fft / 2;
  int prod = 1, s = 0;
  for (; s < MAX_STAGES; ++s) {
    const int r = (plan >> (4 * s)) & 15;
    if (r == 0) break;
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8)
      return (int)cudaErrorInvalidValue;
    prod *= r;
  }
  if (n_fft < 8 || n_fft % 2 || prod != m || s == 0 || (plan >> (4 * s)) ||
      hop < 1 || frames_per_cta < 1 || frames_per_cta > MAX_FRAMES)
    return (int)cudaErrorInvalidValue;
  const long smem =
      8L * n_fft + 16L * frames_per_cta * (m + (m & 1)) + 4L * n_fft;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define STFT_FFT_FIXED(NC, PC)                                             \
  if (n_fft == NC && plan == PC)                                           \
    return launch<NC, PC>(audio, window, tw, out, B, S, T, n_fft, hop,     \
                          plan, frames_per_cta, smem, st);
  // the plans ops/stft.py:fft_plan gives 320, 400, 160, 512 and 480
  STFT_FFT_FIXED(320, 0x845)
  STFT_FFT_FIXED(400, 0x855)
  STFT_FFT_FIXED(160, 0x445)
  STFT_FFT_FIXED(512, 0x884)
  STFT_FFT_FIXED(480, 0x4435)
#undef STFT_FFT_FIXED
  return launch<0, 0>(audio, window, tw, out, B, S, T, n_fft, hop, plan,
                      frames_per_cta, smem, st);
}
