// Fused exact-phase NCO mix + composite half-band cascade for Hopper (sm_90a).
//
// Replaces the TPU kernels of sdrreceiver_tpu/pallas/frontend.py
// (MixCascadeKernel._build_chanloop, kernel :363-443, and
// MixCascadeKernel._build_grid, kernel :538-618): one kernel computes the
// function both compute.  Plain version: cuda/frontend.mix_cascade_plain.
//
// What it computes, for each channel c of a batch, with d = depth[c]:
//     z[n]  = x[n] * exp(j theta[n]),
//     theta = f32((phase0 + (f*n mod fs)) mod fs) * f32(2 pi / fs)
//     y[n]  = sum_q hc[q] * z[n * 2^d - q],   n = 0 .. (T >> d) - 1,
// with z = 0 before the first sample and hc the d-stage /2 half-band
// cascade collapsed into one FIR of 10 * (2^d - 1) + 1 taps
// (frontend.composite_taps).  x is one stream shared by every channel
// (x_stride = 0: sub-VFO fan-out, the merged group front) or one row per
// channel (x_stride = T).  Output is channel-major and unpadded: channel c's
// T >> d outputs follow those of channels 0 .. c-1.
//
// Bound: arithmetic, in FP64.  Per input sample it reads 8 bytes and
// writes 8 >> d bytes per channel, ~32 MB per flagship step (~10 us at
// 3.35 TB/s); the work per channel-sample is one double sincos plus
// ~2 * 10 FP64 FMAs of FIR (2^-d of L taps, complex).  Float64 is the price of agreement: the mix is computed
// from the float32 theta in double and rounded to float once, and the FIR
// sums the exact double products of float taps and samples and rounds once,
// so the kernel and its plain version (which rounds at the same points) are
// both correctly rounded and agree bit for bit whatever their summation
// order.  With float32 sums in two orders, ~1% of the int16 audio at rms
// ~10^4 would land 1 LSB apart.  Memory traffic is kept to one read of the
// input: each block stages its input tile and the (L-1)-sample halo it needs
// in shared memory ONCE for all channels it serves (the point of the TPU
// channel-loop form) and keeps the mixed signal on chip.  There is no
// cross-tile scratch: the halo is re-read from device memory, where the
// whole input already is.
//
// Layout of the mixed tile in shared memory: polyphase, row p holding the
// samples at offsets = p mod 2^d, so the 32 outputs a warp computes read
// 32 consecutive words for every tap (no bank conflicts at any depth).
// Where a channel has fewer outputs per tile than threads (d >= 4), each
// output's taps are split across 2^(d-3) threads and summed in shared
// memory.
//
// Phase math is 64-bit integer and exact: each thread computes
// (f * n) mod fs once for its first sample and then steps it by
// (f * blockDim) mod fs with one conditional subtraction, the same integer
// the direct formula gives (kernels/nco.py).  No fast math: __sinf/__cosf
// would break phase accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileIn = 2048;  // input samples per block tile
constexpr int kMaxDepth = 7;

__host__ __device__ inline int tap_len(int d) { return 10 * ((1 << d) - 1) + 1; }

// Row pitch (in float2) of the polyphase buffer for depth d over `span`
// samples: ceil(span / 2^d), padded to 16 >> d (mod 16) for d < 4 and to
// 1 (mod 16) otherwise, so the 16 threads of a half-warp writing
// consecutive samples land in distinct 8-byte banks.
__host__ __device__ inline int poly_pitch(int span, int d) {
  const int need = (span + (1 << d) - 1) >> d;
  const int want = d >= 4 ? 1 : (16 >> d);
  return need + ((want - need % 16) + 16) % 16;
}

__global__ void __launch_bounds__(kThreads)
mix_cascade_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   long long x_stride, long long t_len,
                   const long long* __restrict__ phase0,
                   const long long* __restrict__ f_mod,
                   const int* __restrict__ depth, long long fs,
                   float two_pi_over_fs, const float* __restrict__ taps,
                   int tap_stride, float* __restrict__ yr,
                   float* __restrict__ yi, int channels, int chan_per_block,
                   int halo, int zp_cap) {
  extern __shared__ float4 smem[];
  const int span = kTileIn + halo;
  float2* xs = reinterpret_cast<float2*>(smem);  // [span] staged input
  float2* zp = xs + span;                        // [zp_cap] mixed, polyphase
  double2* red = reinterpret_cast<double2*>(zp + zp_cap);  // [kThreads]
  float* hs = reinterpret_cast<float*>(red + kThreads);     // [tap_stride]

  const int tid = threadIdx.x;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTileIn;
  const long long base = tile0 - halo;  // input index of xs[0]
  const int c0 = blockIdx.y * chan_per_block;
  const int c1 = min(channels, c0 + chan_per_block);

  for (int c = c0; c < c1; ++c) {
    if (c == c0 || x_stride != 0) {
      const float* pr = xr + c * x_stride;
      const float* pim = xi + c * x_stride;
      for (int s = tid; s < span; s += kThreads) {
        const long long g = base + s;
        xs[s] = (g >= 0 && g < t_len) ? make_float2(pr[g], pim[g])
                                      : make_float2(0.f, 0.f);
      }
    }
    const int d = depth[c];
    const int dec = 1 << d;
    const int n_taps = tap_len(d);
    const int pitch = poly_pitch(span, d);
    for (int q = tid; q < n_taps; q += kThreads) hs[q] = taps[c * tap_stride + q];
    __syncthreads();

    // ---- mix into the polyphase buffer ----
    const long long f = f_mod[c];
    const long long step = (f * kThreads) % fs;
    long long m = (f * (base + tid)) % fs;
    if (m < 0) m += fs;
    m += phase0[c];
    if (m >= fs) m -= fs;
    for (int s = tid; s < span; s += kThreads) {
      const float theta = static_cast<float>(m) * two_pi_over_fs;
      double sn, cs;
      sincos(static_cast<double>(theta), &sn, &cs);
      const float2 x = xs[s];
      zp[(s & (dec - 1)) * pitch + (s >> d)] =
          make_float2(static_cast<float>(x.x * cs - x.y * sn),
                      static_cast<float>(x.x * sn + x.y * cs));
      m += step;
      if (m >= fs) m -= fs;
    }
    __syncthreads();

    // ---- composite FIR at stride 2^d ----
    const int n_tile = kTileIn >> d;  // this channel's outputs per tile
    const long long n0 = tile0 >> d;
    const long long n_out = t_len >> d;
    long long off = 0;
    for (int k = 0; k < c; ++k) off += t_len >> depth[k];
    const int parts = n_tile >= kThreads ? 1 : kThreads / n_tile;
    const int per = (n_taps + parts - 1) / parts;
    for (int w = tid; w < n_tile * parts; w += kThreads) {
      const int o = w % n_tile;
      const int q0 = (w / n_tile) * per;
      const int q1 = min(n_taps, q0 + per);
      double ar = 0.0, ai = 0.0;
      for (int q = q0; q < q1; ++q) {
        const int s = (o << d) + halo - q;
        const float2 z = zp[(s & (dec - 1)) * pitch + (s >> d)];
        const double h = hs[q];
        ar = fma(h, static_cast<double>(z.x), ar);
        ai = fma(h, static_cast<double>(z.y), ai);
      }
      if (parts == 1) {
        if (n0 + o < n_out) {
          yr[off + n0 + o] = static_cast<float>(ar);
          yi[off + n0 + o] = static_cast<float>(ai);
        }
      } else {
        red[w] = make_double2(ar, ai);
      }
    }
    if (parts > 1) {
      __syncthreads();
      for (int o = tid; o < n_tile; o += kThreads) {
        double ar = 0.0, ai = 0.0;
        for (int p = 0; p < parts; ++p) {
          const double2 v = red[p * n_tile + o];
          ar += v.x;
          ai += v.y;
        }
        if (n0 + o < n_out) {
          yr[off + n0 + o] = static_cast<float>(ar);
          yi[off + n0 + o] = static_cast<float>(ai);
        }
      }
    }
    __syncthreads();  // xs, zp, hs and red are reused by the next channel
  }
}

}  // namespace

// xr, xi: float32 [n_in, t_len] (x_stride = 0 for one shared row, t_len for
// one row per channel); phase0, f_mod: int64 [channels]; depth: int32
// [channels], each in 0..7, at most dmax; taps: float32 [channels,
// tap_stride], row c = composite taps of depth[c], zero padded, tap_stride
// >= tap_len(dmax); yr, yi: float32 [sum_c t_len >> depth[c]].  t_len must be
// a multiple of 2^dmax.  Returns cudaGetLastError() after the launch.
extern "C" int mix_cascade_launch(const float* xr, const float* xi,
                                  long long x_stride, long long t_len,
                                  const long long* phase0,
                                  const long long* f_mod, const int* depth,
                                  long long fs, float two_pi_over_fs,
                                  const float* taps, int tap_stride, float* yr,
                                  float* yi, int channels, int dmax,
                                  void* stream) {
  if (channels <= 0 || dmax < 0 || dmax > kMaxDepth || t_len <= 0 ||
      (t_len & ((1LL << dmax) - 1)) || tap_stride < tap_len(dmax) || fs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo = tap_len(dmax) - 1;
  const int span = kTileIn + halo;
  int zp_cap = 0;
  for (int d = 0; d <= dmax; ++d) {
    const int need = (1 << d) * poly_pitch(span, d);
    if (need > zp_cap) zp_cap = need;
  }
  zp_cap += (span + zp_cap) & 1;  // keep the double2 partial sums 16-byte aligned
  const size_t smem = static_cast<size_t>(span + zp_cap) * sizeof(float2) +
                      kThreads * sizeof(double2) +
                      static_cast<size_t>(tap_stride) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mix_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n_tiles = (t_len + kTileIn - 1) / kTileIn;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // split the channels over enough blocks to give every SM two
  long long want = (264 + n_tiles - 1) / n_tiles;
  int groups = static_cast<int>(want < channels ? want : channels);
  const int per_block = (channels + groups - 1) / groups;
  groups = (channels + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(groups));
  mix_cascade_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, x_stride, t_len, phase0, f_mod, depth, fs, two_pi_over_fs, taps,
      tap_stride, yr, yi, channels, per_block, halo, zp_cap);
  return static_cast<int>(cudaGetLastError());
}

// The message for a code the launch entries returned.
extern "C" const char* sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
