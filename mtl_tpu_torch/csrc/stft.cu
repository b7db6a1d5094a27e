// Windowed DFT -> log1p magnitude, straight from the prepadded waveform.
//
// Replaces the Pallas TPU kernel mtl_tpu/ops/stft_pallas.py:stft_logmag_pallas
// (body _stft_kernel). That kernel takes materialised frames [B*T, n_fft]; this
// one reads frame t of row b as audio[b, t*hop : t*hop + n_fft] (what
// frame_signal(prepadded=True) yields), so the [B, T, n_fft] frame tensor is
// never written to device memory.
//
// Work: out[r, k] = log1p(sqrt(re^2 + im^2)), re = frames[r] . cos[:, k],
// im = frames[r] . nsin[:, k]; 4*B*T*n_fft*F flop (1.3 GFLOP at B=8, T=800,
// n_fft=320, F=161) against ~8.6 MB of waveform, bases and output, so the
// kernel is bound by the f32 FMA rate, not by bytes. Accumulation is full f32
// on the CUDA cores (log1p amplifies the error of small bins; TF32 would keep
// about three digits).
//
// Route: csrc/stft_fft.cu, a shared-memory FFT bound by bytes, takes every
// n_fft whose half has no prime factor above 5; this kernel takes the rest
// (441, 448, ...), chosen by ops/stft.py:stft_route, and is counted as
// stft_logmag_direct.
//
// Design: a block owns TM frame rows x TN bins; per TK-sample step it stages
// the frame chunk and both basis chunks in shared memory, and each thread
// keeps a 4x4 register tile of re and im (32 FMAs per 12 shared loads).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // frame rows per block
constexpr int TN = 64;        // bins per block
constexpr int TK = 32;        // samples per step
constexpr int THREADS = 256;  // 16 (bins) x 16 (rows), 4x4 outputs each

__global__ void __launch_bounds__(THREADS) stft_logmag_kernel(
    const float* __restrict__ audio,  // [B, S] prepadded waveforms
    const float* __restrict__ cosb,   // [n_fft, F] windowed cos basis
    const float* __restrict__ nsinb,  // [n_fft, F] windowed -sin basis
    float* __restrict__ out,          // [B, T, F]
    int B, int S, int T, int n_fft, int hop, int F) {
  __shared__ float xs[TK][TM + 1];  // frame chunk, [sample][row]
  __shared__ float cs[TK][TN];
  __shared__ float ss[TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bins tx + 16*j
  const int ty = tid / 16;  // rows 4*ty + i
  const int rows = B * T;
  const int row0 = blockIdx.x * TM;
  const int bin0 = blockIdx.y * TN;

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < n_fft; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int r = e / TK, k = e % TK;
      const int row = row0 + r, n = k0 + k;
      float v = 0.f;
      if (row < rows && n < n_fft) {
        const long idx = (long)(row % T) * hop + n;
        if (idx < S) v = audio[(long)(row / T) * S + idx];
      }
      xs[k][r] = v;
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int k = e / TN, c = e % TN;
      const int n = k0 + k, bin = bin0 + c;
      const bool ok = n < n_fft && bin < F;
      cs[k][c] = ok ? cosb[(long)n * F + bin] : 0.f;
      ss[k][c] = ok ? nsinb[(long)n * F + bin] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[4], c[4], s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = cs[k][tx + 16 * j];
        s[j] = ss[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = bin0 + tx + 16 * j;
      if (bin < F)
        out[(long)row * F + bin] =
            log1pf(sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]));
    }
  }
}

}  // namespace

extern "C" int stft_logmag_f32(const float* audio, const float* cosb,
                               const float* nsinb, float* out, int B, int S,
                               int T, int n_fft, int hop, int F,
                               void* stream) {
  const dim3 grid((B * T + TM - 1) / TM, (F + TN - 1) / TN);
  stft_logmag_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      audio, cosb, nsinb, out, B, S, T, n_fft, hop, F);
  return (int)cudaGetLastError();
}
