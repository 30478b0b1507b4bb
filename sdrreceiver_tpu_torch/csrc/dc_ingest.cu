// Fused IQ ingest + one-pole DC-EMA removal for Hopper (sm_90a).
//
// Replaces the TPU kernel sdrreceiver_tpu/pallas/dckernel.py
// (DcKernel._build, kernel body :101-143), both of its instances: the u8
// entry (ingest v - 127 fused into the load) and the f32 entry.  Plain
// version: kernels/dc.dc_block_planar after kernels/ingest (cuda/dckernel.py).
//
// What it computes, per plane (I and Q), with a = 1 - alpha:
//     m[n] = a * m[n-1] + alpha * x[n],   m[-1] = carried mean,
//     y[n] = x[n] - m[n],                 new mean = m[T-1].
//
// Bound: device memory.  Per complex sample it reads 2 bytes (u8) or 8
// bytes (f32) of interleaved input twice and writes 8 bytes of planar
// output, against about 10 flops; at 3.35 TB/s a 1.536 Msample u8 block is
// ~4 us of traffic.  The design answers that by reading the interleaved
// stream directly (one 16-byte load per thread for 8 u8 samples: no
// deinterleave pass, no int8 trick) and keeping every intermediate on chip.
//
// The TPU grid runs its tiles in order and carries the mean from one to the
// next in scratch; GPU blocks run in no order, so the carry takes three
// launches on the caller's stream:
//   (a) dc_tile_totals: each block's zero-carry end value per plane,
//   (b) dc_tile_carries: one block scans those, seeded with the carried
//       mean, into each tile's incoming mean (and the new mean),
//   (c) dc_apply: each block recomputes its zero-carry prefix, adds the
//       decayed incoming mean, and writes y.
// Any T >= 1: when no tile size divides T, the tiles are 2048 samples and
// the last one is partial.  Its valid samples are placed at the END of the
// tile, after `pad` masked positions: a masked position loads 0, so the
// zero-carry prefix stays exactly 0 across it (the identity of the scan),
// the tile's incoming mean is injected where its first valid sample sits,
// and nothing is stored for it.  Every other tile is full and runs the
// vector path unchanged.
// All arithmetic is float32, as in the plain closed form.  Long-range decay
// factors a^n are taken as exp(n * log1p(-alpha)) in double and rounded
// once to float: a itself in float is 1 - 1e-6 only to within 3% of alpha,
// which compounded over a 1.5 Msample block would misplace the mean by
// several percent.  Inside a thread's 8 samples the float recurrence with
// a is exact to ~1e-7.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kPerThread = 8;  // complex samples per thread

__device__ __forceinline__ float apow(double log_a, double n) {
  return static_cast<float>(exp(n * log_a));
}

__device__ __forceinline__ float to_float(uint8_t v) {
  return static_cast<float>(v) - 127.f;
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename In>
struct Loader;

template <>
struct Loader<uint8_t> {
  // 8 complex samples = 16 interleaved bytes I0 Q0 I1 Q1 ... (one load)
  __device__ static void load(const uint8_t* raw, long long s0, float* xr,
                              float* xi) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + 2 * s0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xr[2 * k] = static_cast<float>(w[k] & 0xffu) - 127.f;
      xi[2 * k] = static_cast<float>((w[k] >> 8) & 0xffu) - 127.f;
      xr[2 * k + 1] = static_cast<float>((w[k] >> 16) & 0xffu) - 127.f;
      xi[2 * k + 1] = static_cast<float>(w[k] >> 24) - 127.f;
    }
  }
};

template <>
struct Loader<float> {
  // 8 complex samples = 64 interleaved bytes (four 16-byte loads)
  __device__ static void load(const float* raw, long long s0, float* xr,
                              float* xi) {
    const float4* p = reinterpret_cast<const float4*>(raw + 2 * s0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = p[k];
      xr[2 * k] = v.x;
      xi[2 * k] = v.y;
      xr[2 * k + 1] = v.z;
      xi[2 * k + 1] = v.w;
    }
  }
};

// Positions p0..p0+7 of a partial tile whose first valid position is
// `pad`; position p holds stream sample `first + p` (`first` = the tile's
// start minus `pad`).  Masked positions read as 0.
template <typename In>
__device__ void load_masked(const In* raw, long long first, int p0, int pad,
                            float* xr, float* xi) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const bool ok = p0 + k >= pad;
    const long long s = first + p0 + k;
    xr[k] = ok ? to_float(raw[2 * s]) : 0.f;
    xi[k] = ok ? to_float(raw[2 * s + 1]) : 0.f;
  }
}

// The tile's samples for this thread: a vector load on a full tile, the
// masked load on the partial one.  Returns the tile's pad (0 if full).
template <typename In>
__device__ __forceinline__ int load_tile(const In* raw, long long t_len,
                                         float* xr, float* xi) {
  const long long tile = static_cast<long long>(blockDim.x) * kPerThread;
  const long long base = blockIdx.x * tile;
  const int p0 = threadIdx.x * kPerThread;
  const int pad = blockIdx.x == gridDim.x - 1
                      ? static_cast<int>(gridDim.x * tile - t_len)
                      : 0;
  if (pad == 0) {
    Loader<In>::load(raw, base + p0, xr, xi);
  } else {
    load_masked(raw, base - pad, p0, pad, xr, xi);
  }
  return pad;
}

// Inclusive scan over the block's threads of the linear recurrence
// s[t] = a^step * s[t-1] + v[t] (both planes).  Hillis-Steele: at distance
// d the multiplier is a^(step*d).  On return sh[t] holds s[t] for every t.
__device__ float2 block_scan(float2 v, float2* sh, double log_a,
                             double step) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const float mul = apow(log_a, step * d);
    float2 o = make_float2(0.f, 0.f);
    if (t >= d) o = sh[t - d];
    __syncthreads();
    if (t >= d) {
      v.x = fmaf(mul, o.x, v.x);
      v.y = fmaf(mul, o.y, v.y);
      sh[t] = v;
    }
    __syncthreads();
  }
  return v;
}

// The thread's zero-carry end value over its 8 samples.
__device__ __forceinline__ float2 local_total(const float* xr, const float* xi,
                                              float a, float alpha) {
  float2 m = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    m.x = fmaf(a, m.x, alpha * xr[k]);
    m.y = fmaf(a, m.y, alpha * xi[k]);
  }
  return m;
}

template <typename In>
__global__ void dc_tile_totals(const In* __restrict__ raw, long long t_len,
                               float2* __restrict__ tile_tot, double log_a,
                               float a, float alpha) {
  extern __shared__ float2 sh[];
  float xr[kPerThread], xi[kPerThread];
  load_tile(raw, t_len, xr, xi);
  const float2 s = block_scan(local_total(xr, xi, a, alpha), sh, log_a,
                              static_cast<double>(kPerThread));
  if (threadIdx.x == blockDim.x - 1) tile_tot[blockIdx.x] = s;
}

// One block: tile k's incoming mean M_k = m_end(k-1), with
// m_end(k) = A * m_end(k-1) + E_k, A = a^tile_len, m_end(-1) = mean_in.
// Chunks of blockDim tiles: within a chunk starting at k0 with running
// value R = m_end(k0-1), m_end(k) = A^(k-k0+1) R + scan(E)[k].  Only the
// last tile can be partial, so every M_k is exact as scanned; the new mean
// decays the last tile's M over its tile_len - pad valid samples.
__global__ void dc_tile_carries(const float2* __restrict__ tile_tot,
                                float2* __restrict__ tile_carry,
                                const float* __restrict__ mean_in,
                                float* __restrict__ mean_out, int n_tiles,
                                int pad, double log_a, double tile_len) {
  extern __shared__ float2 sh[];
  const int t = threadIdx.x;
  float2 run = make_float2(mean_in[0], mean_in[1]);
  for (int k0 = 0; k0 < n_tiles; k0 += blockDim.x) {
    const int k = k0 + t;
    const float2 e = k < n_tiles ? tile_tot[k] : make_float2(0.f, 0.f);
    const float2 s = block_scan(e, sh, log_a, tile_len);
    const float dec = apow(log_a, tile_len * (t + 1));
    const float2 mend = make_float2(fmaf(dec, run.x, s.x), fmaf(dec, run.y, s.y));
    sh[t] = mend;  // block_scan ended on a barrier
    __syncthreads();
    const float2 mk = t == 0 ? run : sh[t - 1];
    if (k < n_tiles) tile_carry[k] = mk;
    if (k == n_tiles - 1) {
      const float dl = apow(log_a, tile_len - pad);
      mean_out[0] = fmaf(dl, mk.x, e.x);
      mean_out[1] = fmaf(dl, mk.y, e.y);
    }
    run = sh[min(static_cast<int>(blockDim.x), n_tiles - k0) - 1];
    __syncthreads();
  }
}

template <typename In>
__global__ void dc_apply(const In* __restrict__ raw, long long t_len,
                         const float2* __restrict__ tile_carry,
                         float* __restrict__ yr, float* __restrict__ yi,
                         double log_a, float a, float alpha) {
  extern __shared__ float2 sh[];
  const int t = threadIdx.x;
  const int p0 = t * kPerThread;
  float xr[kPerThread], xi[kPerThread];
  const int pad = load_tile(raw, t_len, xr, xi);
  block_scan(local_total(xr, xi, a, alpha), sh, log_a,
             static_cast<double>(kPerThread));
  // m just before this thread's samples: the zero-carry prefix there plus,
  // past the tile's first valid position, its incoming mean decayed over
  // the p0 - pad samples since; a thread that holds that position injects
  // the mean just before it
  const float2 excl = t > 0 ? sh[t - 1] : make_float2(0.f, 0.f);
  const float2 mk = tile_carry[blockIdx.x];
  float2 m = excl;
  if (p0 > pad) {
    const float dec = apow(log_a, static_cast<double>(p0 - pad));
    m = make_float2(fmaf(dec, mk.x, excl.x), fmaf(dec, mk.y, excl.y));
  }
  float outr[kPerThread], outi[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (p0 + k == pad) {
      m.x += mk.x;
      m.y += mk.y;
    }
    m.x = fmaf(a, m.x, alpha * xr[k]);
    m.y = fmaf(a, m.y, alpha * xi[k]);
    outr[k] = xr[k] - m.x;
    outi[k] = xi[k] - m.y;
  }
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x * kPerThread - pad;
  if (pad == 0) {
    float4* pr = reinterpret_cast<float4*>(yr + first + p0);
    float4* pi = reinterpret_cast<float4*>(yi + first + p0);
    pr[0] = make_float4(outr[0], outr[1], outr[2], outr[3]);
    pr[1] = make_float4(outr[4], outr[5], outr[6], outr[7]);
    pi[0] = make_float4(outi[0], outi[1], outi[2], outi[3]);
    pi[1] = make_float4(outi[4], outi[5], outi[6], outi[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (p0 + k >= pad) {
        yr[first + p0 + k] = outr[k];
        yi[first + p0 + k] = outi[k];
      }
    }
  }
}

template <typename In>
void launch_all(const In* raw, long long t_len, long long n_tiles, int threads,
                const float* mean_in, float* mean_out, float* yr, float* yi,
                float2* tile_tot, float2* tile_carry, double log_a, float a,
                float alpha, long long tile, cudaStream_t s) {
  const size_t sh = threads * sizeof(float2);
  const int pad = static_cast<int>(n_tiles * tile - t_len);
  dc_tile_totals<In><<<static_cast<unsigned>(n_tiles), threads, sh, s>>>(
      raw, t_len, tile_tot, log_a, a, alpha);
  dc_tile_carries<<<1, 1024, 1024 * sizeof(float2), s>>>(
      tile_tot, tile_carry, mean_in, mean_out, static_cast<int>(n_tiles), pad,
      log_a, static_cast<double>(tile));
  dc_apply<In><<<static_cast<unsigned>(n_tiles), threads, sh, s>>>(
      raw, t_len, tile_carry, yr, yi, log_a, a, alpha);
}

}  // namespace

// raw: interleaved I,Q [2*t_len], uint8 (is_u8) or float32, 16-byte aligned;
// any t_len >= 1.  tile_tot, tile_carry: scratch of ceil(t_len/256) float
// pairs each.  Returns cudaGetLastError() after the launches.
extern "C" int dc_ingest_launch(const void* raw, int is_u8, long long t_len,
                                const float* mean_in, float* mean_out,
                                float* yr, float* yi, float* tile_tot,
                                float* tile_carry, double alpha,
                                void* stream) {
  if (t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // samples per block: the largest of 2048..256 dividing T; 2048 with a
  // partial last tile when none does.  2048 for every T would do, but on an
  // H100 it measured ~11% slower at T = 384,000 and 480,000 (half as many
  // or fewer blocks spread less evenly over the 132 SMs)
  long long tile = 2048;
  while (tile > 256 && t_len % tile) tile >>= 1;
  if (t_len % tile) tile = 2048;
  const long long n_tiles = (t_len + tile - 1) / tile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const double log_a = std::log1p(-alpha);
  const float a = static_cast<float>(std::exp(log_a));
  auto* tot = reinterpret_cast<float2*>(tile_tot);
  auto* car = reinterpret_cast<float2*>(tile_carry);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_u8) {
    launch_all(static_cast<const uint8_t*>(raw), t_len, n_tiles,
               static_cast<int>(tile / kPerThread), mean_in, mean_out, yr, yi,
               tot, car, log_a, a, static_cast<float>(alpha), tile, s);
  } else {
    launch_all(static_cast<const float*>(raw), t_len, n_tiles,
               static_cast<int>(tile / kPerThread), mean_in, mean_out, yr, yi,
               tot, car, log_a, a, static_cast<float>(alpha), tile, s);
  }
  return static_cast<int>(cudaGetLastError());
}
