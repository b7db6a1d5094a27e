// Windowed DFT -> log1p magnitude on TF32 tensor cores at f32 accuracy
// (3xTF32, csrc/tf32x3.cuh), straight from the prepadded waveform.
//
// Replaces the Pallas TPU kernel mtl_tpu/ops/stft_pallas.py:stft_logmag_pallas
// (body _stft_kernel) for every n_fft that ops/stft.py:stft_route does not
// send to the FFT kernel (csrc/stft_fft.cu): n_fft whose half has a prime
// factor above 5, such as 441 (22.05 kHz at the 20 ms window), 882 (44.1
// kHz) and 220 (11.025 kHz). Counted as stft_logmag_direct.
//
// out[b, t, k] = log1p(|sum_n w[n] audio[b, t*hop + n] e^{-2 pi i nk/n_fft}|)
// as one GEMM, [B*T, K] x [K, N]: row r = b*T + t is frame t of row b,
// read as audio[b, t*hop : t*hop + n_fft] (zeros past the row's end) and
// never written to device memory; K is n_fft padded to a multiple of 8 with
// zero basis rows; column 2k of the windowed basis is cos_k, 2k + 1 is
// -sin_k, N = 2F padded to a multiple of 16. A thread's accumulator then
// holds re and im of one bin in adjacent registers, and the epilogue
// log1p(sqrt(re^2 + im^2)) stays in registers, one store a bin. The wrapper
// packs the basis once per (n_fft, window, device), split into hi and lo
// core matrices in the order the CTAs read them, [N/TN][K/KC][2][TN/8]
// [KC/4][8][4] (ops/stft.py:device_dft_tc_operands), with N padded to a
// multiple of TN = 112 and K to one of KC = 16 (for the 20 ms windows of
// 11.025-44.1 kHz that is the padding to 16 and 8 of the GEMM itself), so
// a stage's basis is one contiguous 14 KB copy.
//
// Bound at B 8, T 800, n_fft 441 (F 221): 4*B*T*n_fft*F = 2.495e9 flop of
// which 3xTF32 issues three passes, 0.0151 ms at 495 TFLOP/s (operations);
// the bytes (11.3 MB of waveform, 5.7 MB out) take ~0.005 ms at 3.35 TB/s.
//
// Design: a CTA owns TM = 128 frame rows (two warpgroups, one m64 tile
// each) x TN = 112 columns (56 bins: 56 accumulators a thread), so the
// 6400 rows of B 8 x T 800 make 50 x 4 = 200 CTAs at n_fft 441 (50 x 3 at
// 320), two resident a SM: one wave on 132 SMs. Its K loop walks 16-sample
// chunks through a 4-stage cp.async ring, two chunks ahead, one
// __syncthreads a chunk (a stage is refilled two chunks after its last
// MMAs were issued; each k8 step waits for the step before it, so those
// are retired). A stage holds the chunk of the 128 frames at a row pitch of
// 20 floats (the 8 rows of an A load hit 8 different bank quads: no
// conflict) and the chunk's 112 basis columns as hi and lo core matrices.
// The CTA's frame rows are looked up once in a shared table (offset in the
// waveform, samples that exist); consecutive lanes copy consecutive samples
// of a row, by 16-byte copies where the waveform's start, hop and the row
// length keep them 16-byte aligned, else by 4-byte ones (hop 441, 110, an
// odd S), so a warp's copy touches 2 to 8 rows' lines, not 16; the zero
// fill past a row's end or past n_fft is the copy's own. A fragments come
// by 32-bit shared loads (ldmatrix is b16-only) and are split into hi and
// lo in registers. The two warpgroups share the B stage, which halves the
// basis's L2 traffic (80 MB a call at n_fft 441) against one warpgroup a
// CTA. Streaming the basis as f32 and splitting it in the kernel, as the
// f32 block 2 does with its weights, halves those bytes but measured
// slower here (the split of a chunk's basis costs more than its copy):
// PERF.md takes the kernel's time apart (cli/tf32_ablation.py).

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int WGS = 2;                // warpgroups, one m64 row tile each
constexpr int THREADS = 128 * WGS;
constexpr int TM = 64 * WGS;          // frame rows a CTA
constexpr int TN = 112;               // GEMM columns a CTA (56 bins)
constexpr int NG = TN / 8;            // n8 groups a CTA
constexpr int KC = 16;                // samples a chunk
constexpr int KCORE = KC / 4;         // core matrices along k a chunk
constexpr int AP = KC + 4;            // frame row pitch in a stage (floats)
constexpr int STAGES = 4;
constexpr int A_FLOATS = TM * AP;
constexpr int B_FLOATS = NG * KCORE * 32;  // hi (or lo) of a chunk
constexpr int STAGE = A_FLOATS + 2 * B_FLOATS;
constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
static_assert(THREADS * 8 == TM * KC, "8 samples a thread a chunk");

// Chunk c of the frames and of the basis into the stage at st (bytes).
// rows: the CTA's (offset of the frame in audio, samples of it that exist);
// bsrc: this CTA's basis, [K/KC][2][NG][KCORE][8][4].
__device__ __forceinline__ void load_chunk(int c, uint32_t st,
                                           const float* __restrict__ audio,
                                           const int2* rows, bool vec,
                                           const float* bsrc, int tid) {
  if (vec) {  // 4 samples a lane, 4 lanes a row, 2 rows a thread
    const int n = c * KC + 4 * (tid & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (tid >> 2) + (THREADS / 4) * j;
      const int2 row = rows[r];
      const int have = min(max(row.y - n, 0), 4);
      cp_async16(st + (r * AP + 4 * (tid & 3)) * 4,
                 have ? audio + row.x + n : audio, 4 * have);
    }
  } else {  // a sample a lane, 16 lanes a row, 8 rows a thread
    const int n = c * KC + (tid & 15);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (tid >> 4) + (THREADS / 16) * j;
      const int2 row = rows[r];
      const bool in = n < row.y;
      cp_async4(st + (r * AP + (tid & 15)) * 4, in ? audio + row.x + n : audio,
                in ? 4 : 0);
    }
  }
  const float* src = bsrc + (size_t)c * 2 * B_FLOATS;
  const uint32_t dst = st + A_FLOATS * 4;
#pragma unroll
  for (int e = tid; e < 2 * B_FLOATS / 4; e += THREADS)
    cp_async16(dst + e * 16, src + e * 4, 16);
}

// grid: (N / TN, ceil(B*T / TM)). bp: [N/TN][chunks][2][NG][KCORE][8][4].
__global__ void __launch_bounds__(THREADS, 2) stft_dft_tc_kernel(
    const float* __restrict__ audio, const float* __restrict__ bp,
    float* __restrict__ out, int B, int S, int T, int n_fft, int hop, int F,
    int chunks, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int2 rows[TM];
  const float* sm = reinterpret_cast<const float*>(smem);
  const uint32_t sm_u = smem_u32(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int M = B * T;
  const int m0 = blockIdx.y * TM;
  const float* bsrc = bp + (size_t)blockIdx.x * chunks * 2 * B_FLOATS;

  if (tid < TM) {  // frame row m0 + tid: audio[b, t*hop : t*hop + n_fft]
    const int row = m0 + tid;
    int2 e = make_int2(0, 0);
    if (row < M) {
      const int b = row / T, t = row - b * T;
      const long start = (long)t * hop, left = (long)S - start;
      e = make_int2((int)((long)b * S + start),
                    left <= 0 ? 0 : (int)(left < n_fft ? left : n_fft));
    }
    rows[tid] = e;
  }
  __syncthreads();

  load_chunk(0, sm_u, audio, rows, vec, bsrc, tid);
  cp_async_commit();
  if (chunks > 1) load_chunk(1, sm_u + STAGE * 4, audio, rows, vec, bsrc, tid);
  cp_async_commit();

  float acc[TN / 2];
  zero(acc);
  const int ar = 64 * wg + 16 * wl + g;  // A rows ar and ar + 8
#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (c + 2 < chunks)
      load_chunk(c + 2, sm_u + ((c + 2) % STAGES) * STAGE * 4, audio, rows,
                 vec, bsrc, tid);
    cp_async_commit();
    const float* as = sm + (c % STAGES) * STAGE;
    const uint32_t bs = sm_u + ((c % STAGES) * STAGE + A_FLOATS) * 4;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      uint32_t hi[4], lo[4];
      load_split(as + ar * AP + 8 * ks + q, as + (ar + 8) * AP + 8 * ks + q,
                 hi, lo);
      wg_fence();
      const uint64_t b_hi = b_desc(bs + ks * 256, KCORE * 128);
      const uint64_t b_lo = b_desc(bs + B_FLOATS * 4 + ks * 256, KCORE * 128);
      mma3<TN>(acc, hi, lo, b_hi, b_lo);
      wg_commit();
      wg_wait<1>();
    }
  }
  wg_wait<0>();
  pin(acc);

  // columns 8j + 2q, +1 of the CTA's group j are re, im of its bin 4j + q
  const int row0 = m0 + ar, bin0 = blockIdx.x * (TN / 2);
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int bin = bin0 + 4 * j + q;
    if (bin >= F) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const float re = acc[4 * j + 2 * hh], im = acc[4 * j + 2 * hh + 1];
      if (row < M)
        out[(size_t)row * F + bin] = log1pf(sqrtf(re * re + im * im));
    }
  }
}

// x -> the device split and cvt.rna.tf32.f32, for the card test that holds
// to_tf32 against the instruction and ops/tf32.py:split_tf32 against both
__global__ void tf32_split_kernel(const float* __restrict__ x,
                                  uint32_t* __restrict__ hi,
                                  uint32_t* __restrict__ lo,
                                  uint32_t* __restrict__ cvt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  split(x[i], hi[i], lo[i]);
  cvt[i] = cvt_rna_tf32(x[i]);
}

}  // namespace

// audio f32 [B, S] prepadded (B*S < 2^31); bp f32 [tiles][chunks][2][14]
// [4][8][4], 16-byte aligned (hi, lo of the interleaved windowed basis,
// tiles * 112 >= 2F, chunks * 16 >= n_fft); out f32 [B, T, F]. 16-byte
// frame copies when audio is 16-byte aligned and S and hop are multiples
// of 4, else 4-byte ones.
extern "C" int stft_dft_tc_f32(const float* audio, const float* bp,
                               float* out, int B, int S, int T, int n_fft,
                               int hop, int F, int tiles, int chunks,
                               void* stream) {
  if (2 * F > TN * tiles || n_fft > KC * chunks || (long)B * S > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stft_dft_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, (B * T + TM - 1) / TM);
  stft_dft_tc_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      audio, bp, out, B, S, T, n_fft, hop, F, chunks,
      S % 4 == 0 && hop % 4 == 0 && ((uintptr_t)audio & 15) == 0);
  return (int)cudaGetLastError();
}

extern "C" int tf32_split_f32(const float* x, uint32_t* hi, uint32_t* lo,
                              uint32_t* cvt, int n, void* stream) {
  tf32_split_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, hi, lo, cvt, n);
  return (int)cudaGetLastError();
}
