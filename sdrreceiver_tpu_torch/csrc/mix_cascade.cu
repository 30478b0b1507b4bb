// Fused exact-phase NCO mix + composite half-band cascade for Hopper (sm_90a).
//
// Replaces the TPU kernels of sdrreceiver_tpu/pallas/frontend.py
// (MixCascadeKernel._build_chanloop, frontend.py:488, and
// MixCascadeKernel._build_grid, frontend.py:672): one kernel computes the
// function both compute.  Plain version: cuda/frontend.mix_cascade_plain.
//
// What it computes, for each channel c of a batch, with d = depth[c]:
//     z[n]  = f32(x[n] * exp(j theta[n])),
//     theta = f32((phase0 + (f*n mod fs)) mod fs) * f32(2 pi / fs)
//     y[n]  = sum_q hc[q] * z[n * 2^d - q],   n = 0 .. (T >> d) - 1,
// with z = 0 before the first sample and hc the d-stage /2 half-band
// cascade collapsed into one FIR of 10 * (2^d - 1) + 1 taps
// (frontend.composite_taps).  x is one stream shared by every channel
// (x_stride = 0: sub-VFO fan-out, the merged group front) or one row per
// channel (x_stride = T).  Output is channel-major and unpadded: channel c's
// T >> d outputs follow those of channels 0 .. c-1.
//
// Bound.  Per channel-sample it must read 8 bytes of input and write 8 >> d
// bytes: ~32 MB per flagship step at block 1,536,000 (four sites), ~9.4 us
// at 3.35 TB/s.  Its float64 work is the FIR, ~10 complex taps per
// channel-sample (2^-d of the 10 * 2^d taps), and the complex mix: ~0.43
// GFLOP per step, ~6.4 us at the H100's FP64 tensor-core peak (67 TFLOP/s),
// ~12.7 us at its FP64 vector rate.  So the bytes set the bound of the
// flagship's four calls (cuda/devtime.py computes both per call), and
// every FP64 instruction beyond the FIR's, every conversion and every
// shared-memory wavefront counts: measured on the card, the kernel is
// bound by those, not by device memory.
//
// Why FP64 at all.  The mix is computed in double from the float32 theta
// and rounded to float once, and the FIR sums the exact double products of
// float taps and float samples and rounds once, so kernel and plain version
// are both correctly rounded and agree bit for bit whatever their summation
// order.  With float32 sums in two orders, ~1% of the int16 audio at rms
// ~10^4 would land 1 LSB apart.
//
// The phasor without a transcendental.  m < fs < 2^22 and F = f32(2 pi/fs)
// has a 24-bit significand, so theta_d = m * F is exact in double, theta_f
// = f32(theta_d) is the float32 theta above and r = theta_f - theta_d is
// exact, |r| <= 2^-22.  A warp mixes 32 consecutive samples; with M the
// phase numerator of its first sample and d = (f * lane) mod fs, m = M + d
// (less fs when that wraps), and
//     exp(j theta_f) = (Thi[M >> K] * Tlo[M & (2^K - 1)]) * L[lane, wrap]
//                      * ((1 - r*r/2) + j r)
// with Thi[i] = exp(j F i 2^K), Tlo[i] = exp(j F i) (K = 11) and L[lane] =
// exp(j F d), exp(j F (d - fs)), all tabulated in double by the wrapper
// (frontend.phasor_tables, frontend.lane_table).  The first product is the
// same for a whole warp: a block makes it once per warp and round into
// shared memory, and no lane gathers from a table.  ~26 FP64 multiplies and
// adds a sample, where a double sincos costs ~30-40 FP64 instructions plus
// its range reduction.  theta_d is kept by exact additions of multiples of
// F, never converted from m, and f32(theta_d) is taken by adding and taking
// away 1.5 * 2^(E + 29) (E its exponent), not by two conversions.  Every
// multiply and add is an explicit __dmul_rn / __dadd_rn / __dsub_rn, so
// nvcc contracts none of them into an FMA: the plain version
// (frontend.mix_cascade_plain) evaluates the same expressions in torch
// float64, one rounding per operation, and gets the same double.
//
// Parallel work.  One block per (input tile, channel): no channel loop, the
// grid is n_tiles x C, and the tile (2048 input samples, halved while that
// gives fewer than two blocks per SM) fills the 132 SMs at C = 1 on a
// 96,000-sample block as at C = 15.  A block stages its input tile and the
// halo of 10 * (2^dmax - 1) samples in shared memory by cp.async, every
// load in flight at once (a shared input is re-read per channel from L2,
// where the whole input of a site fits), mixes it and keeps the mixed tile
// as float32 in polyphase rows (row p holds the samples at offsets = p mod
// 2^d, row pitch 1 mod 16 in 8-byte units).  A thread computes 4
// consecutive outputs for one phase p (and, past 16 phases, every 16th
// phase): for each of the phase's ~10 taps it loads ONE sample, widens it
// to double and puts it in a 4-slot register ring (unrolled by 4, so the
// window slides without a move), and does 8 FMAs; the phase lanes (at most
// 16 of a warp) are then summed with shuffles.  Neighbouring lanes read
// neighbouring polyphase rows.  Measured on the card, staging the tile
// (not waiting on each load), float32 rows (half the shared-memory
// wavefronts of double rows) and the ring each took time off; what is
// left is bound by issue and latency, not by one unit.
//
// Phase math is integer and exact: each thread computes (f * n) mod fs
// once for its warp's first sample (mulmod: no 64-bit division) and then
// steps it by (f * blockDim) mod fs with one conditional subtraction, the
// same integer the direct formula gives (kernels/nco.py).  No fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 7;
constexpr int kOut = 4;          // consecutive outputs per thread item
constexpr int kLanes = 16;       // phase lanes of an item group, at most
constexpr int kWarps = kThreads / 32;
constexpr int kFsLimit = 1 << 22;
constexpr int kMaxDevices = 64;

__host__ __device__ inline int tap_len(int d) { return 10 * ((1 << d) - 1) + 1; }

// Row pitch (in float2) of the polyphase buffer for depth d over `span`
// samples: ceil(span / 2^d) rounded up to 1 mod 16, so rows r .. r+15
// start in distinct 8-byte bank pairs.
__host__ __device__ inline int poly_pitch(int span, int d) {
  const int need = (span + (1 << d) - 1) >> d;
  return need + ((1 - need % 16) + 16) % 16;
}

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }

// (a * n) mod fs for 0 <= a < fs < 2^22 and |n| < 2^31, exactly: a * |n|
// < 2^53 is exact in double, so the quotient through 1 / fs is off by at
// most one (a 64-bit % is a long software division on the card).
__device__ __forceinline__ int mulmod(long long a, long long n, int fs, double inv_fs) {
  const long long p = a * (n < 0 ? -n : n);
  long long r = p - static_cast<long long>(static_cast<double>(p) * inv_fs) * fs;
  if (r < 0) r += fs;
  if (r >= fs) r -= fs;
  return static_cast<int>(n < 0 && r ? fs - r : r);
}

__device__ __forceinline__ double2 widen(float2 z) {
  return make_double2(z.x, z.y);
}

// One float from global to shared memory by cp.async; 0 where !ok.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(dsub(dmul(a.x, b.x), dmul(a.y, b.y)),
                      dadd(dmul(a.x, b.y), dmul(a.y, b.x)));
}

// x >= 0 rounded to float32 precision, to nearest even, as f32(x) is:
// adding and taking away 1.5 * 2^(E + 29), E the exponent of x, rounds x
// at its float32 ulp (two FP64 adds, no conversion).
__device__ __forceinline__ double round_f32(double x) {
  const int e = (__double2hiint(x) >> 20) & 0x7ff;
  const double c = __hiloint2double(((e + 29) << 20) | 0x80000, 0);
  return dsub(dadd(x, c), c);
}

__global__ void __launch_bounds__(kThreads)
mix_cascade_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long x_stride, long long t_len,
                   const long long* __restrict__ phase0,
                   const long long* __restrict__ f_mod,
                   const int* __restrict__ depth, int fs, float two_pi_over_fs,
                   const double2* __restrict__ thi,
                   const double2* __restrict__ tlo, int k_bits,
                   const double2* __restrict__ lane_tab,
                   const double* __restrict__ taps, int tap_stride,
                   float* __restrict__ yr, float* __restrict__ yi, int tile,
                   int halo, int zp_cap, int tap_cap) {
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int d = depth[c];
  const int dec = 1 << d;
  const int n_taps = tap_len(d);
  const int span = tile + halo;
  const int n_rounds = (span + kThreads - 1) / kThreads;
  const int pitch = poly_pitch(span, d);

  extern __shared__ double2 smem[];
  double* hs = reinterpret_cast<double*>(smem);            // [tap_cap] taps
  double2* ub = reinterpret_cast<double2*>(hs + tap_cap);  // [n_rounds, 8] warp phasors
  float* xs = reinterpret_cast<float*>(ub + kWarps * n_rounds);  // [2, span] input
  float2* zp = reinterpret_cast<float2*>(xs + 2 * span);   // [zp_cap] mixed, polyphase
  const long long tile0 = static_cast<long long>(blockIdx.x) * tile;
  const long long base = tile0 - halo;  // input index of tile sample 0
  const float* pr = xr + c * x_stride;
  const float* pim = xi + c * x_stride;

  // stage the input tile: every load in flight at once (cp.async, zero
  // fill outside the stream), overlapped with the set-up below
  for (int s = tid; s < span; s += kThreads) {
    const long long g = base + s;
    const bool ok = g >= 0 && g < t_len;
    stage4(xs + s, ok ? pr + g : pr, ok);
    stage4(xs + span + s, ok ? pim + g : pim, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int q = tid; q < n_taps; q += kThreads) hs[q] = taps[c * tap_stride + q];

  // ---- mix into the polyphase buffer ----
  // mw: phase numerator of this warp's first sample, stepped by kThreads
  // samples per round; d: this lane's offset from it
  const int lane = tid & 31;
  const long long f = f_mod[c];
  const double inv_fs = 1.0 / fs;
  const int step = mulmod(f, kThreads, fs, inv_fs);
  const int d_lane = mulmod(f, lane, fs, inv_fs);
  int mw = mulmod(f, base + tid - lane, fs, inv_fs) + static_cast<int>(phase0[c]);
  if (mw >= fs) mw -= fs;
  const double F = two_pi_over_fs;
  // exact multiples of F: m F, (m + step) F and (m + step - fs) F all are
  double th_w = static_cast<double>(mw) * F;
  const double th_d = static_cast<double>(d_lane) * F;
  const double th_step = static_cast<double>(step) * F;
  const double th_fs = static_cast<double>(fs) * F;
  const double2 l_plain = lane_tab[(c * 32 + lane) * 2];
  const double2 l_wrap = lane_tab[(c * 32 + lane) * 2 + 1];
  const int k_mask = (1 << k_bits) - 1;
  // Thi[M >> K] * Tlo[M mod 2^K] of each warp's first sample in each round
  // of the loop below: the same for the whole warp, made once
  for (int i = tid; i < kWarps * n_rounds; i += kThreads) {
    int m = mulmod(f, base + 32 * i, fs, inv_fs) + static_cast<int>(phase0[c]);
    if (m >= fs) m -= fs;
    ub[i] = cmul(thi[m >> k_bits], tlo[m & k_mask]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int s = tid; s < span; s += kThreads) {
    const long long g = base + s;
    float2 z = make_float2(0.f, 0.f);
    if (g >= 0 && g < t_len) {
      const bool wrap = mw + d_lane >= fs;
      const double th = wrap ? dsub(dadd(th_w, th_d), th_fs) : dadd(th_w, th_d);
      const double r = dsub(round_f32(th), th);
      const double2 pm = cmul(ub[s >> 5], wrap ? l_wrap : l_plain);
      const double2 p = cmul(pm, make_double2(dsub(1.0, dmul(dmul(r, r), 0.5)), r));
      const double2 xz = cmul(make_double2(xs[s], xs[span + s]), p);
      z = make_float2(__double2float_rn(xz.x), __double2float_rn(xz.y));
    }
    zp[(s & (dec - 1)) * pitch + (s >> d)] = z;
    mw += step;
    th_w = dadd(th_w, th_step);
    if (mw >= fs) {
      mw -= fs;
      th_w = dsub(th_w, th_fs);
    }
  }
  __syncthreads();

  // ---- composite FIR at stride 2^d: items (strip of kOut outputs, phase) ----
  const int n_tile = tile >> d;
  const long long n0 = tile0 >> d;
  const long long n_out = t_len >> d;
  long long off = 0;  // this channel's first output: the channels before it
  for (int k0 = 0; k0 < c; k0 += 32) {
    long long v = k0 + lane < c ? t_len >> depth[k0 + lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    off += v;
  }
  const int lanes = dec < kLanes ? dec : kLanes;  // an aligned group of a warp
  const int rounds = dec / lanes;                 // phases per lane
  const int items = (n_tile / kOut) * lanes;      // a multiple of 32
  for (int w = tid; w < items; w += kThreads) {
    const int g = w % lanes;
    const int strip = w / lanes;
    double2 acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = make_double2(0.0, 0.0);
    for (int rd = 0; rd < rounds; ++rd) {
      // taps q = p + j 2^d reach sample (n - j) 2^d + u of the tile,
      // u = halo - p: row u mod 2^d, column n - j + (u >> d)
      const int p = g + rd * lanes;
      const int u = halo - p;
      const float2* row = zp + (u & (dec - 1)) * pitch + strip * kOut + (u >> d);
      const int nj = (n_taps - p + dec - 1) >> d;
      // ring[v mod kOut] holds column v - strip*kOut - (u >> d): at tap j,
      // output i reads column i - j; after it, column -j - 1 replaces the
      // one output kOut - 1 no longer needs.  Unrolled by kOut, every slot
      // index is a constant: the window slides without a move.
      double2 ring[kOut];
#pragma unroll
      for (int i = 0; i < kOut; ++i) ring[i] = widen(row[i]);
      for (int j0 = 0; j0 < nj; j0 += kOut) {
#pragma unroll
        for (int jj = 0; jj < kOut; ++jj) {
          const int j = j0 + jj;
          if (j < nj) {
            const double h = hs[p + (j << d)];
#pragma unroll
            for (int i = 0; i < kOut; ++i) {
              const double2 z = ring[(i - jj + kOut) % kOut];
              acc[i].x = fma(h, z.x, acc[i].x);  // h * z is exact in double
              acc[i].y = fma(h, z.y, acc[i].y);
            }
            if (j + 1 < nj) ring[(kOut - 1 - jj) % kOut] = widen(row[-(j + 1)]);
          }
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        acc[i].x += __shfl_xor_sync(0xffffffffu, acc[i].x, o);
        acc[i].y += __shfl_xor_sync(0xffffffffu, acc[i].y, o);
      }
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const long long n = n0 + strip * kOut + i;
      if (i % lanes == g && n < n_out) {
        yr[off + n] = static_cast<float>(acc[i].x);
        yi[off + n] = static_cast<float>(acc[i].y);
      }
    }
  }
}

}  // namespace

// xr, xi: float32 [n_in, t_len] (x_stride = 0 for one shared row, t_len for
// one row per channel); phase0, f_mod: int64 [channels]; depth: int32
// [channels], each in 0..7, at most dmax; fs < 2^22; thi, tlo: float64
// (re, im) pairs, [ceil(fs / 2^k_bits)] and [2^k_bits] (frontend
// .phasor_tables); lane_tab: float64 [channels, 32, 2, 2] (frontend
// .lane_table); taps: float64 [channels, tap_stride], row c = composite
// taps of depth[c], zero padded, tap_stride >= tap_len(dmax); yr, yi: float32
// [sum_c t_len >> depth[c]].  t_len must be a multiple of 2^dmax.  Returns
// cudaGetLastError() after the launch.
extern "C" int mix_cascade_launch(const float* xr, const float* xi,
                                  long long x_stride, long long t_len,
                                  const long long* phase0,
                                  const long long* f_mod, const int* depth,
                                  long long fs, float two_pi_over_fs,
                                  const double* thi, const double* tlo,
                                  int k_bits, const double* lane_tab,
                                  const double* taps,
                                  int tap_stride, float* yr, float* yi,
                                  int channels, int dmax, void* stream) {
  if (channels <= 0 || channels > 65535 || dmax < 0 || dmax > kMaxDepth ||
      t_len <= 0 || (t_len & ((1LL << dmax) - 1)) ||
      tap_stride < tap_len(dmax) || fs <= 0 || fs >= kFsLimit || k_bits < 0 ||
      k_bits > 22)
    return static_cast<int>(cudaErrorInvalidValue);
  // 2048 input samples a tile, halved while the grid gives fewer than two
  // blocks per SM; at least 8 << dmax, so that a tile's items fill whole
  // warps
  const int min_tile = 512 > (8 << dmax) ? 512 : (8 << dmax);
  int tile = 2048;
  while (tile > min_tile && ((t_len + tile - 1) / tile) * channels < 264) tile >>= 1;
  const int halo = tap_len(dmax) - 1;
  const int span = tile + halo;
  int zp_cap = 0;
  for (int d = 0; d <= dmax; ++d) {
    const int need = (1 << d) * poly_pitch(span, d);
    if (need > zp_cap) zp_cap = need;
  }
  const int tap_cap = tap_len(dmax) + (tap_len(dmax) & 1);  // keeps ub 16-byte aligned
  const int n_rounds = (span + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(tap_cap) * sizeof(double) +
                      static_cast<size_t>(kWarps * n_rounds) * sizeof(double2) +
                      static_cast<size_t>(2 * span) * sizeof(float) +
                      static_cast<size_t>(zp_cap) * sizeof(float2);
  if (smem > 48 * 1024) {
    // the opt-in belongs to the function on a device, not to a stream: set
    // it once per device and size (a CUDA graph's warm-up calls set it
    // before the capture, which then makes no such call)
    static int opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || static_cast<int>(smem) > opted_in[dev]) {
      e = cudaFuncSetAttribute(mix_cascade_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opted_in[dev] = static_cast<int>(smem);
    }
  }
  const long long n_tiles = (t_len + tile - 1) / tile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(channels));
  mix_cascade_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, x_stride, t_len, phase0, f_mod, depth, static_cast<int>(fs),
      two_pi_over_fs, reinterpret_cast<const double2*>(thi),
      reinterpret_cast<const double2*>(tlo), k_bits,
      reinterpret_cast<const double2*>(lane_tab), taps, tap_stride, yr, yi,
      tile, halo, zp_cap, tap_cap);
  return static_cast<int>(cudaGetLastError());
}

// The message for a code the launch entries returned.
extern "C" const char* sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
