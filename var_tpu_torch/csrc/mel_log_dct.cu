// mel -> log -> DCT tail of the MFCC frontend, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel var_tpu/ops/audio_pallas.py::_mel_log_dct.
// For every row of a (B, T, F) float32 power spectrogram, N = B*T rows:
//
//     mel  = power_row @ mel_fb          mel_fb (F, 40), triangular bands
//     lmel = logf(mel + 1e-6f)
//     out  = lmel @ dct                  dct (40, 40), DCT-II ortho
//
// F = n_fft/2 + 1 is 257 (n_fft 512) or 513 (n_fft 1024). Output (B, T, 40)
// float32, contiguous. The input is either contiguous (B, T, F) or the view
// the gemm STFT returns, a contiguous (B, F, T) tensor seen as (B, T, F)
// ("frequency-major"); each layout has its own template instance.
//
// What bounds it. At the main path's shape (128, 101, 257) the power
// spectrogram is 13.3 MB and the output 2.1 MB: 15.4 MB over 3.35 TB/s is
// 4.6 us on an H100 SXM. The mel filters are zero outside their bands
// (494 of the 10,280 entries of mel_fb are non-zero at F = 257, 988 of
// 20,520 at F = 513; at most 2 filters cover a bin), so the work needed is
// 494 + 1,600 FMAs a row, 54 MFLOP: under 1 us of FP32. Bytes bound it.
// On the card it runs at about a third of that bound (PERF.md): loads and
// sums barely overlap, since the whole grid's first loads land at about the
// same time and the last units' sums follow them. The frequency-major view
// takes about 10% longer than contiguous input, nearly all of it from its
// 4-byte copies: contiguous input moved in 4-byte copies takes within 2% of
// the view's time.
//
// Design:
//   - banded sums: filter m is summed over its span of bins only, from the
//     first to the last non-zero weight, padded with zero weights to a
//     multiple of 4 bins (ops/mel_log_dct.py::kernel_table), so the sums
//     hold exactly the dense products that can be non-zero, plus zeros.
//     Lanes are rows and warps are filters: the host deals the 40 filters
//     to 10 warps, 4 each, longest first to the least loaded warp, so the
//     span bounds are warp-uniform, the 4 weights of a step are one
//     broadcast 16-byte load, and the power reads across rows hit distinct
//     banks (odd row pitch F in the contiguous layout, unit stride in the
//     other). Four partial sums per filter keep four FMA chains in flight;
//   - the DCT-II basis is even or odd in the mel index (dct[39-n][k] =
//     (-1)^k dct[n][k]), so each output sums 20 terms x[n] +- x[39-n]
//     instead of 40; warp w computes outputs w + 10j, all of w's parity;
//   - a persistent grid (as many blocks as fit on the SMs, worked out once
//     per device and layout by mel_log_dct_plan) walks over units of 32
//     consecutive rows of the flattened (B*T) row index, in both layouts,
//     so only the last unit can be short. The table, the weights and the
//     half DCT (about 6 KB) are loaded into shared memory once per block.
//     (A draft that read the DCT from constant memory as FMA operands was
//     twice as slow: ten warps sweeping 6.4 KB of constants miss the SM's
//     constant cache.);
//   - a ring of two shared-memory stages holds whole units (32 x F
//     floats); cp.async loads one unit ahead, so the next unit's loads
//     overlap the current unit's sums. (Three and four stages were slower
//     on the card: larger blocks, fewer of them on an SM.) Contiguous units
//     are one span of 32*F floats and move in 16-byte copies when the
//     input is 16-byte aligned; in the frequency-major layout each lane
//     copies its own row, 4 bytes a bin at the frame pitch T, so a warp's
//     copies of one bin are one run of 128 B (two where the unit crosses a
//     batch element). Neither layout fits a TMA tensor map: its strides
//     must be multiples of 16 B, and the row pitch (1,028 B) and the frame
//     pitch at T = 101 (404 B) are not;
//   - the log-mels go to shared memory at pitch 44 (16-byte rows read
//     without bank conflicts), and the (32 x 40) result is staged at pitch
//     41 and written as one contiguous run of 16-byte stores: the rows of a
//     unit are consecutive rows of the output in both layouts;
//   - non-finite input: in the dense form one NaN or inf bin makes every
//     mel NaN (inf*0 and NaN*0 are NaN), so the whole output row is NaN.
//     Every bin lies in some span (a zero weight included) or is one of the
//     few "holes" the table lists, so a non-finite bin leaves a non-finite
//     span sum or hole; the kernel then flags the row and its 40 mels are
//     NaN, as in the dense form. (A finite row whose weighted sum overflows
//     float32 is flagged too; audio power spectra are far from that.)
// IEEE float32 throughout: FP32 FMAs, logf, no TF32, no tensor cores, no
// fast math; the contract is 1e-4 against the dense plain version.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMel = 40;
constexpr int kMfcc = 40;
constexpr int kRows = 32;                  // rows per unit, one per lane
constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerWarp = kMel / kWarps;    // filters and outputs per warp
constexpr int kHalf = kMel / 2;            // DCT terms after the symmetry
constexpr int kLogPitch = kMel + 4;        // 16-byte rows, no bank conflict
constexpr int kOutPitch = kMfcc + 1;       // output staging row pitch
constexpr int kTableInts = 4 * kMel;       // (m, lo, length, offset) rows
constexpr int kStages = 2;                 // spectrogram ring depth
constexpr float kLogEps = 1e-6f;
static_assert(kMel % kWarps == 0 && kMfcc == kMel && kPerWarp == 4 &&
                  kWarps % 2 == 0 && kMel % 8 == 0,
              "each warp takes 4 filters and 4 outputs of one parity");

struct Geometry {
  int T, F;
  int n_rows;  // B * T
  int n_units;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Unit u holds rows [u * 32, u * 32 + nr) of the flattened (B*T) index.
__device__ __forceinline__ int unit_rows(const Geometry& g, int u) {
  return min(kRows, g.n_rows - u * kRows);
}

// Stage layout: [row][bin] at pitch F (contiguous), [bin][row] at pitch 32
// (frequency-major).
template <bool kFreqMajor>
__device__ __forceinline__ float at(const float* st, int r, int f, int F) {
  return kFreqMajor ? st[f * kRows + r] : st[r * F + f];
}

template <bool kFreqMajor>
__device__ __forceinline__ void load_unit(float* st, const float* power,
                                          const Geometry& g, int u,
                                          bool aligned16) {
  const int row0 = u * kRows;
  const int nr = unit_rows(g, u);
  if (kFreqMajor) {
    const int lane = threadIdx.x & 31;
    if (lane < nr) {  // row (b, t): element b*F*T + f*T + t for bin f
      const int b = (row0 + lane) / g.T;
      const int t = row0 + lane - b * g.T;
      const float* src = power + static_cast<long long>(b) * g.F * g.T + t;
      for (int f = threadIdx.x >> 5; f < g.F; f += kWarps) {
        cp_async4(st + f * kRows + lane,
                  src + static_cast<long long>(f) * g.T);
      }
    }
  } else {
    const float* src = power + static_cast<long long>(row0) * g.F;
    const int n = nr * g.F;
    int done = 0;
    if (aligned16) {  // the unit starts at a multiple of 32*F floats
      const int n4 = n >> 2;
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        cp_async16(st + 4 * i, src + 4 * i);
      }
      done = n4 << 2;
    }
    for (int e = done + threadIdx.x; e < n; e += kThreads) {
      cp_async4(st + e, src + e);
    }
  }
}

// The unit's nr x 40 outputs are one contiguous, 16-byte aligned run.
__device__ __forceinline__ void store_unit(float* out, const float* s_out,
                                           long long row0, int nr) {
  constexpr int kQuads = kMfcc / 4;
  float4* dst = reinterpret_cast<float4*>(out + row0 * kMfcc);
  for (int e = threadIdx.x; e < nr * kQuads; e += kThreads) {
    const int r = e / kQuads;
    const float* src = s_out + r * kOutPitch + 4 * (e - r * kQuads);
    dst[e] = make_float4(src[0], src[1], src[2], src[3]);
  }
}

// Banded sums of the warp's filters for row `lane` of the stage `st`;
// `tab` holds their (m, lo, length, offset), each length a multiple of 4.
template <bool kFreqMajor>
__device__ __forceinline__ void band_sums(const float* st, int F, int lane,
                                          const int4 tab[kPerWarp],
                                          const float* s_w,
                                          float acc[kPerWarp]) {
  constexpr int kStep = kFreqMajor ? kRows : 1;  // between adjacent bins
  const float* row = st + (kFreqMajor ? lane : lane * F);
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const float* p = row + tab[j].y * kStep;
    const float4* w = reinterpret_cast<const float4*>(s_w + tab[j].w);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;  // 4 FMA chains
#pragma unroll 2
    for (int k = 0; k < tab[j].z; k += 4) {
      const float4 wk = w[k >> 2];
      const float p0 = p[k * kStep];
      const float p1 = p[(k + 1) * kStep];
      const float p2 = p[(k + 2) * kStep];
      const float p3 = p[(k + 3) * kStep];
      a0 = fmaf(p0, wk.x, a0);
      a1 = fmaf(p1, wk.y, a1);
      a2 = fmaf(p2, wk.z, a2);
      a3 = fmaf(p3, wk.w, a3);
    }
    acc[j] = (a0 + a1) + (a2 + a3);
  }
}

// Warp `warp`'s outputs k = warp + 10*j of row `x` (its log-mels). Its k
// share a parity, so out[k] = sum over n < 20 of dct[n, k] *
// (x[n] +- x[39 - n]); `cw` holds dct[n, k] as one float4 per n.
__device__ __forceinline__ void dct_row(const float4* cw, const float* x,
                                        float* orow, int warp) {
  const float sign = (warp & 1) ? -1.0f : 1.0f;
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int n = 0; n < kHalf; n += 4) {
    const float4 lo = *reinterpret_cast<const float4*>(x + n);
    const float4 hi = *reinterpret_cast<const float4*>(x + kMel - 4 - n);
    const float v[4] = {fmaf(sign, hi.w, lo.x), fmaf(sign, hi.z, lo.y),
                        fmaf(sign, hi.y, lo.z), fmaf(sign, hi.x, lo.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 c = cw[n + i];
      o.x = fmaf(v[i], c.x, o.x);
      o.y = fmaf(v[i], c.y, o.y);
      o.z = fmaf(v[i], c.z, o.z);
      o.w = fmaf(v[i], c.w, o.w);
    }
  }
  orow[warp] = o.x;
  orow[warp + kWarps] = o.y;
  orow[warp + 2 * kWarps] = o.z;
  orow[warp + 3 * kWarps] = o.w;
}

template <bool kFreqMajor>
__global__ void __launch_bounds__(kThreads, 2)
mel_log_dct_kernel(const float* __restrict__ power,
                   const int* __restrict__ table, int n_holes,
                   const float* __restrict__ weights, int n_weights,
                   const float* __restrict__ dct_half,
                   float* __restrict__ out, Geometry g, int stage_floats,
                   int weight_floats, int aligned16) {
  extern __shared__ __align__(16) float smem[];
  float* s_stage = smem;                              // kStages units
  float* s_dct = s_stage + kStages * stage_floats;    // kWarps x kHalf x 4
  float* s_w = s_dct + kMel * kHalf;                  // band weights
  float* s_log = s_w + weight_floats;                 // kRows x kLogPitch
  float* s_out = s_log + kRows * kLogPitch;           // kRows x kOutPitch
  int* s_bad = reinterpret_cast<int*>(s_out + kRows * kOutPitch);  // kRows
  int* s_tab = s_bad + kRows;                         // table, then holes

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bid = blockIdx.x;
  const int n_blocks = gridDim.x;
  // the grid never exceeds n_units, so every block has at least one unit
  const int n_mine = (g.n_units - bid + n_blocks - 1) / n_blocks;

  // unit j of this block is cp.async group j (groups past n_mine are
  // empty): kStages - 1 units are in flight ahead of the one being summed,
  // so group i is complete once at most kStages - 2 are pending
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) {
      load_unit<kFreqMajor>(s_stage + s * stage_floats, power, g,
                            bid + s * n_blocks, aligned16);
    }
    cp_async_commit();
  }
  for (int e = tid; e < n_weights; e += kThreads) s_w[e] = weights[e];
  for (int e = tid; e < kTableInts + n_holes; e += kThreads) {
    s_tab[e] = table[e];
  }
  for (int e = tid; e < kMel * kHalf; e += kThreads) s_dct[e] = dct_half[e];
  if (tid < kRows) s_bad[tid] = 0;  // row r is bad in unit i if s_bad[r] == i + 1
  __syncthreads();
  int4 tab[kPerWarp];  // this warp's filters, the same for every unit
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    tab[j] = reinterpret_cast<const int4*>(s_tab)[warp * kPerWarp + j];
  }

  long long prev_row0 = 0;
  int prev_nr = 0;
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of unit i landed
    // every thread's copies of unit i are visible, and every thread is done
    // with unit i - 1: its stage is refilled and its outputs stored
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n_mine) {
      load_unit<kFreqMajor>(s_stage + (next % kStages) * stage_floats, power,
                            g, bid + next * n_blocks, aligned16);
    }
    cp_async_commit();
    store_unit(out, s_out, prev_row0, prev_nr);

    const int u = bid + i * n_blocks;
    const long long row0 = static_cast<long long>(u) * kRows;
    const int nr = unit_rows(g, u);
    const float* st = s_stage + (i % kStages) * stage_floats;

    // lanes past nr work on stale data and are never stored
    float acc[kPerWarp];
    band_sums<kFreqMajor>(st, g.F, lane, tab, s_w, acc);
    // Every bin lies in a span or is a hole. A NaN or -inf bin makes its
    // spans' sums NaN or -inf, +inf makes them +inf (or NaN where a weight
    // is 0); x*0 is 0 for finite x and NaN otherwise.
    float chk = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) chk += acc[j] * 0.0f;
    for (int h = warp; h < n_holes; h += kWarps) {
      chk = fmaf(at<kFreqMajor>(st, lane, s_tab[kTableInts + h], g.F), 0.0f,
                 chk);
    }
    if (chk != 0.0f) s_bad[lane] = i + 1;  // NaN: a non-finite bin
    __syncthreads();

    // a row with a non-finite bin gets NaN mels, as in the dense product
    const float bad = s_bad[lane] == i + 1 ? __int_as_float(0x7fc00000) : 0.0f;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      s_log[lane * kLogPitch + tab[j].x] = logf(acc[j] + bad + kLogEps);
    }
    __syncthreads();

    dct_row(reinterpret_cast<const float4*>(s_dct) + warp * kHalf,
            s_log + lane * kLogPitch, s_out + lane * kOutPitch, warp);
    prev_row0 = row0;
    prev_nr = nr;
  }
  __syncthreads();
  store_unit(out, s_out, prev_row0, prev_nr);
}

int round4(int n) { return (n + 3) & ~3; }

size_t smem_bytes(int F, int n_weights, int n_holes) {
  return sizeof(float) * (static_cast<size_t>(kStages) * round4(kRows * F) +
                          kMel * kHalf + round4(n_weights) +
                          kRows * (kLogPitch + kOutPitch)) +
         sizeof(int) * (kRows + kTableInts + n_holes);
}

template <bool kFreqMajor>
int plan(size_t smem, int* max_blocks) {
  auto kernel = mel_log_dct_kernel<kFreqMajor>;
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the device's whole opt-in size, so that every F's launch fits
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *max_blocks = sms * per_sm;
  return 0;
}

}  // namespace

// Plain C entry points for ctypes. The arguments: F bins; table: the 40
// int32 rows (m, lo, length, offset) of ops/mel_log_dct.py::kernel_table,
// dealt to `warps` warps, then n_holes bins; weights: n_weights floats;
// freq_major: 0 for a contiguous (B, T, F) power, 1 for a contiguous
// (B, F, T) one.
//
// mel_log_dct_plan, once per device, layout and table (on the current
// device): raises the kernel's shared-memory limit to the device's and
// writes to *max_blocks how many blocks fit on the device at once, the
// persistent grid's size. Returns a cudaError_t (0 = cudaSuccess).
extern "C" int mel_log_dct_plan(int F, int n_weights, int n_holes,
                                int freq_major, int warps, int* max_blocks) {
  if (warps != kWarps || F < 4 || n_weights <= 0 || n_holes < 0 ||
      n_holes > F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(F, n_weights, n_holes);
  return freq_major ? plan<true>(smem, max_blocks)
                    : plan<false>(smem, max_blocks);
}

// mel_log_dct_launch: power, B*T*F floats; dct_half: (10, 20, 4) floats of
// ops/mel_log_dct.py::dct_half; out: contiguous (B, T, 40), 16-byte
// aligned; max_blocks from mel_log_dct_plan. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = cudaSuccess); it does
// not synchronise.
extern "C" int mel_log_dct_launch(const float* power, const int* table,
                                  int n_holes, const float* weights,
                                  int n_weights, const float* dct_half,
                                  float* out, int B, int T, int F,
                                  int freq_major, int max_blocks,
                                  void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.T = T;
  g.F = F;
  g.n_rows = B * T;
  g.n_units = (g.n_rows + kRows - 1) / kRows;
  const int grid = std::min(g.n_units, max_blocks);
  const size_t smem = smem_bytes(F, n_weights, n_holes);
  const int aligned16 = (reinterpret_cast<uintptr_t>(power) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = freq_major ? mel_log_dct_kernel<true>
                           : mel_log_dct_kernel<false>;
  kernel<<<grid, kThreads, smem, st>>>(
      power, table, n_holes, weights, n_weights, dct_half, out, g,
      round4(kRows * F), round4(n_weights), aligned16);
  return static_cast<int>(cudaGetLastError());
}
