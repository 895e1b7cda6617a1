// mel -> log -> DCT tail of the MFCC frontend, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel var_tpu/ops/audio_pallas.py::_mel_log_dct.
// For every row of a (B, T, F) float32 power spectrogram, flattened to
// N = B*T rows:
//
//     mel  = power_row @ mel_fb          mel_fb (F, 40)
//     lmel = logf(mel + 1e-6f)
//     out  = lmel @ dct                  dct (40, 40), DCT-II ortho
//
// F = n_fft/2 + 1 is 257 (n_fft 512) or 513 (n_fft 1024); the row count is
// free. Output (N, 40) float32.
//
// Bound at the main path's shape (B, T, F) = (128, 101, 257), N = 12928:
//   bytes  4*N*(F+40) = 15.4 MB (power read once, output written once;
//          the 47 KB of constants add 0.3%)
//   flops  2*N*40*(F+40) = 307 MFLOP of FP32 FMA work
// On an H100 SXM (3.35 TB/s, about 67 TFLOP/s FP32 without tensor cores)
// both come to about 4.6 us: the kernel sits on the ridge, so it must
// stream the power spectrogram once at full bandwidth AND keep the FMA
// pipes busy. A PCIe H100 has lower figures for both; take the ones for
// the card nvidia-smi names.
//
// Design (simple and right first):
//   - one block of 128 threads per 32 rows; each thread owns one row and
//     10 of its 40 mel columns (q, q+4, ..., q+36 with q = tid % 4), so the
//     32x40 mel sums live in registers, FP32 FMA only: no TF32, no tensor
//     cores, because the contract is IEEE float32 at 1e-4;
//   - F is streamed in chunks of 32 bins: the 32x32 power tile and the
//     32x40 mel_fb tile are staged in shared memory with coalesced loads,
//     and the ragged last chunk (257 and 513 are not multiples of 32) is
//     masked to zero;
//   - the log goes to shared memory and the 40x40 DCT, held in shared
//     memory for the whole block, finishes the row; no intermediate
//     touches device memory, so the bytes moved are the bound's bytes.
// What it does not do yet: overlap the next tile's loads with the FMAs
// (cp.async / TMA double buffering), which is where the time above the
// bound goes. That is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // rows per block
constexpr int kChunk = 32;     // frequency bins per shared-memory tile
constexpr int kMel = 40;
constexpr int kMfcc = 40;
constexpr int kThreads = 128;
constexpr int kColsPerThread = kMel * kRows / kThreads;  // 10
constexpr int kColStride = kThreads / kRows;             // 4
constexpr float kLogEps = 1e-6f;

__global__ void __launch_bounds__(kThreads)
mel_log_dct_kernel(const float* __restrict__ power,
                   const float* __restrict__ mel,
                   const float* __restrict__ dct,
                   float* __restrict__ out,
                   int n_rows, int n_freq) {
  __shared__ float s_pow[kRows][kChunk + 1];  // +1: no bank conflicts
  __shared__ float s_mel[kChunk][kMel];
  __shared__ float s_log[kRows][kMel + 1];
  __shared__ float s_dct[kMel][kMfcc];

  const int tid = threadIdx.x;
  const int r = tid / kColStride;  // this thread's row within the block
  const int q = tid % kColStride;  // first of its mel columns
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  for (int e = tid; e < kMel * kMfcc; e += kThreads) {
    s_dct[e / kMfcc][e % kMfcc] = dct[e];
  }

  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.0f;

  for (int f0 = 0; f0 < n_freq; f0 += kChunk) {
    // power tile: 32 rows x 32 bins, consecutive threads on consecutive bins
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int rr = e / kChunk;
      const int c = e % kChunk;
      const long long row = row0 + rr;
      const int f = f0 + c;
      s_pow[rr][c] = (row < n_rows && f < n_freq)
                         ? power[row * n_freq + f] : 0.0f;
    }
    // mel_fb tile: 32 bins x 40 mels
    for (int e = tid; e < kChunk * kMel; e += kThreads) {
      const int c = e / kMel;
      const int m = e % kMel;
      const int f = f0 + c;
      s_mel[c][m] = (f < n_freq) ? mel[f * kMel + m] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      const float p = s_pow[r][c];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        acc[j] = fmaf(p, s_mel[c][q + kColStride * j], acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    s_log[r][q + kColStride * j] = logf(acc[j] + kLogEps);
  }
  __syncthreads();

  const long long row = row0 + r;
  if (row >= n_rows) return;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int k = q + kColStride * j;
    float o = 0.0f;
#pragma unroll 8
    for (int m = 0; m < kMel; ++m) o = fmaf(s_log[r][m], s_dct[m][k], o);
    out[row * kMfcc + k] = o;
  }
}

}  // namespace

// Plain C entry point for ctypes. power (n_rows, n_freq), mel (n_freq, 40),
// dct (40, 40), out (n_rows, 40): contiguous float32 on the current device.
// Launches on `stream` and returns cudaGetLastError() after the launch
// (0 = cudaSuccess); it does not synchronise.
extern "C" int mel_log_dct_launch(const float* power, const float* mel,
                                  const float* dct, float* out, int n_rows,
                                  int n_freq, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kRows - 1) / kRows;
  mel_log_dct_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      power, mel, dct, out, n_rows, n_freq);
  return static_cast<int>(cudaGetLastError());
}
