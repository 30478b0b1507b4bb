// Fused IQ ingest + one-pole DC-EMA removal for Hopper (sm_90a).
//
// Replaces the TPU kernel sdrreceiver_tpu/pallas/dckernel.py
// (DcKernel._build, dckernel.py:176, kernel body :101-143), both of its
// instances: the u8 entry (ingest v - 127 fused into the load) and the f32
// entry.  Plain version: kernels/dc.dc_block_planar after kernels/ingest
// (cuda/dckernel.py).
//
// What it computes, per plane (I and Q), with a = 1 - alpha:
//     m[n] = a * m[n-1] + alpha * x[n],   m[-1] = carried mean,
//     y[n] = x[n] - m[n],                 new mean = m[T-1].
//
// Bound: device memory.  Per complex sample it must read 2 bytes (u8) or 8
// bytes (f32) of interleaved input and write 8 bytes of planar output,
// against about 10 flops: at 3.35 TB/s a 1.536 Msample u8 block is ~4.6 us.
// The design reads the input ONCE, in one launch: 16-byte loads straight
// from the interleaved stream (no deinterleave pass), y staged in shared
// memory so that every warp store writes 512 contiguous bytes.  Tiles are
// 4096 samples (256 threads x 16): the look-back is a walk over tiles, so
// fewer tiles keep it short (375 at 1.536 Msamples).  2048-sample tiles at
// 384,000 and 480,000 (more blocks than SMs) measured slower on the card.
//
// The TPU grid runs its tiles in order and carries the mean in scratch; GPU
// blocks run in no order, so the carry is a single-pass chained scan with
// decoupled look-back (as CUB's single-pass prefix scan):
//   - a block takes its tile from an atomic ticket, so tiles start in order
//     and a tile only ever waits for tiles already running: no deadlock;
//   - it scans its tile with zero carry and publishes the aggregate E_k;
//   - one warp resolves the incoming mean M_k = m_end(k-1) from the
//     aggregates of its L = min(128, k) predecessors (4 a lane) and the
//     inclusive end value of tile k-1-L, always the same terms in the same
//     order, so that y is the same in every run (a look-back that stops at
//     whichever predecessor has published its inclusive value sums
//     different terms from run to run, and y then differs in the last bits:
//     measured on the card, a checkpoint split of the alt-rate run was no
//     longer bit-equal to the straight run);
//   - it publishes its inclusive end A M_k + E_k and writes y, its input
//     still in registers.
// Each published value is two 64-bit words (flag << 32 | float bits, one per
// plane), written and read with volatile 64-bit accesses (single-copy
// atomic): a word that is non-zero is complete, so no fence orders value
// and flag, and a publishing thread does not wait for its store.  The wrapper
// allocates the flags with torch.empty; this entry clears them on the stream
// (cudaMemsetAsync) before the launch, so the kernel is CUDA-graph safe.
//
// Any T >= 1: when the tile does not divide T, the last tile is partial.  Its
// valid samples are placed at the END of the tile, after `pad` masked
// positions: a masked position loads 0, so the zero-carry prefix stays
// exactly 0 across it (the identity of the scan), the tile's incoming mean
// is injected where its first valid sample sits, and nothing is stored for
// it.  Every other tile is full and runs the vector path.
//
// All arithmetic is float32, as in the plain closed form.  Decay factors a^n
// are exp(n * log1p(-alpha)) in double, rounded once to float, computed ONCE
// per DcIngest by the wrapper (dckernel.decay_table): a^n for n = 0..4096 and
// a^(4096 j) for j <= 128; no exp per scan level.  a
// itself in float is 1 - 1e-6 only to within 3% of alpha, which compounded
// over a 1.5 Msample block would misplace the mean by several percent.
// Inside a thread's 16 samples the float recurrence with a is exact to
// ~1e-7.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;              // complex samples per thread
constexpr int kTile = kThreads * kPerThread;  // 4096 (dckernel.TILE)
constexpr int kPowN = kTile + 1;  // pw: a^n, n = 0..4096, then a^(kTile j), j <= kLook
constexpr int kPerLane = 4;             // look-back: tiles per lane
constexpr int kLook = 32 * kPerLane;    // and per window
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(uint8_t v) {
  return static_cast<float>(v) - 127.f;
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename In>
struct Loader;

template <>
struct Loader<uint8_t> {
  // 16 complex samples = 32 interleaved bytes I0 Q0 I1 Q1 ... (two loads)
  __device__ static void load(const uint8_t* raw, long long s0, float* xr,
                              float* xi) {
    const uint4* p = reinterpret_cast<const uint4*>(raw + 2 * s0);
#pragma unroll
    for (int h = 0; h < kPerThread / 8; ++h) {
      const uint4 v = p[h];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xr[8 * h + 2 * k] = static_cast<float>(w[k] & 0xffu) - 127.f;
        xi[8 * h + 2 * k] = static_cast<float>((w[k] >> 8) & 0xffu) - 127.f;
        xr[8 * h + 2 * k + 1] = static_cast<float>((w[k] >> 16) & 0xffu) - 127.f;
        xi[8 * h + 2 * k + 1] = static_cast<float>(w[k] >> 24) - 127.f;
      }
    }
  }
};

template <>
struct Loader<float> {
  // 16 complex samples = 128 interleaved bytes (eight 16-byte loads)
  __device__ static void load(const float* raw, long long s0, float* xr,
                              float* xi) {
    const float4* p = reinterpret_cast<const float4*>(raw + 2 * s0);
#pragma unroll
    for (int k = 0; k < kPerThread / 2; ++k) {
      const float4 v = p[k];
      xr[2 * k] = v.x;
      xi[2 * k] = v.y;
      xr[2 * k + 1] = v.z;
      xi[2 * k + 1] = v.w;
    }
  }
};

// Positions p0..p0+15 of a partial tile whose first valid position is
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

// The thread's zero-carry end value over its 16 samples.
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

// Inclusive scan over the block's threads of s[t] = a^16 s[t-1] + v[t]
// (both planes): shuffles inside each warp (distance o: a^(16 o)), then
// the warps' totals (distance o warps: a^(512 o)), then each warp's
// carry-in decayed over its lane's samples.  pw[n] = a^n.
__device__ float2 block_scan(float2 v, float2* warp_tot, const float* pw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_warps = kThreads / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float mul = pw[kPerThread * o];
    const float ox = __shfl_up_sync(kFull, v.x, o);
    const float oy = __shfl_up_sync(kFull, v.y, o);
    if (lane >= o) {
      v.x = fmaf(mul, ox, v.x);
      v.y = fmaf(mul, oy, v.y);
    }
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < n_warps ? warp_tot[lane] : make_float2(0.f, 0.f);
    for (int o = 1; o < n_warps; o <<= 1) {
      const float mul = pw[32 * kPerThread * o];
      const float ox = __shfl_up_sync(kFull, t.x, o);
      const float oy = __shfl_up_sync(kFull, t.y, o);
      if (lane >= o) {
        t.x = fmaf(mul, ox, t.x);
        t.y = fmaf(mul, oy, t.y);
      }
    }
    if (lane < n_warps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    const float2 p = warp_tot[warp - 1];
    const float mul = pw[kPerThread * (lane + 1)];
    v.x = fmaf(mul, p.x, v.x);
    v.y = fmaf(mul, p.y, v.y);
  }
  return v;
}

// Publication slots, per tile k: words 4k, 4k+1 the aggregate (re, im),
// 4k+2, 4k+3 the inclusive end value; word = 1 << 32 | float bits, 0 =
// not yet published.
__device__ __forceinline__ void publish(unsigned long long* w, float2 v) {
  volatile unsigned long long* p = w;  // a 64-bit store is single-copy atomic
  p[0] = (1ull << 32) | __float_as_uint(v.x);
  p[1] = (1ull << 32) | __float_as_uint(v.y);
}

// The pair at `w` if it is published (both words non-zero).
__device__ __forceinline__ bool peek_pair(const unsigned long long* w, float2* v) {
  const volatile unsigned long long* p = w;
  const unsigned long long re = p[0], im = p[1];
  if (!(re >> 32) || !(im >> 32)) return false;
  *v = make_float2(__uint_as_float(static_cast<uint32_t>(re)),
                   __uint_as_float(static_cast<uint32_t>(im)));
  return true;
}

// Waits until the pair at `w` is published; returns it.
__device__ __forceinline__ float2 await_pair(const unsigned long long* w) {
  float2 v;
  while (!peek_pair(w, &v)) __nanosleep(64);
  return v;
}

// Called by one whole warp of tile k > 0: its incoming mean
//     M_k = sum_{l < L} A^l E_(k-1-l) + A^L P_(k-1-L),   L = min(kLook, k),
// with E the tiles' aggregates, P_(k-1-L) the inclusive end value of tile
// k - 1 - L (the carried mean when that is -1), A = a^tile and pw_tile[j] =
// a^(tile j).  Always the same terms, summed in the same order (lane l
// holds distances kPerLane l + q), so the result does not depend on which
// tiles happened to have published what: a run gives the same y every
// time, as the JAX kernel and the plain version do.  The inclusive values
// spread in hops of kLook tiles (3 at 375 tiles).
__device__ float2 look_back(const unsigned long long* slots, int k,
                            const float* mean_in, const float* pw_tile) {
  const int lane = threadIdx.x & 31;
  const int look = k < kLook ? k : kLook;
  // this lane's aggregates, their loads issued together until all are in
  float2 e[kPerLane];
  bool got[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    e[q] = make_float2(0.f, 0.f);
    got[q] = kPerLane * lane + q >= look;
  }
  for (;;) {
    bool wait = false;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (!got[q]) {
        got[q] = peek_pair(slots + 4LL * (k - 1 - kPerLane * lane - q), &e[q]);
        wait |= !got[q];
      }
    }
    if (!wait) break;
    __nanosleep(64);
  }
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const float w = pw_tile[kPerLane * lane + q];  // 0 weight past the window: e = 0
    s.x = fmaf(w, e[q].x, s.x);
    s.y = fmaf(w, e[q].y, s.y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.x += __shfl_xor_sync(kFull, s.x, o);
    s.y += __shfl_xor_sync(kFull, s.y, o);
  }
  const float2 anchor = k == look ? make_float2(mean_in[0], mean_in[1])
                                  : await_pair(slots + 4LL * (k - 1 - look) + 2);
  return make_float2(fmaf(pw_tile[look], anchor.x, s.x), fmaf(pw_tile[look], anchor.y, s.y));
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
dc_ingest_kernel(const In* __restrict__ raw, long long t_len, int n_tiles,
                 const float* __restrict__ mean_in,
                 float* __restrict__ mean_out, float* __restrict__ yr,
                 float* __restrict__ yi, unsigned long long* scratch,
                 const float* __restrict__ pw, const float* __restrict__ pw_tile,
                 float alpha) {
  __shared__ float2 sh[kThreads];  // inclusive per thread
  __shared__ float4 ybuf[2][kTile / 4];  // y of a full tile, for the stores
  __shared__ float2 warp_tot[kThreads / 32];
  __shared__ float2 s_mk;
  __shared__ int s_tile;
  const int t = threadIdx.x;
  if (t == 0) s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
  __syncthreads();
  const int k = s_tile;
  unsigned long long* slots = scratch + 1;
  const float a = pw[1];
  const long long start = static_cast<long long>(k) * kTile;
  const int pad = k == n_tiles - 1
                      ? static_cast<int>(static_cast<long long>(n_tiles) * kTile - t_len)
                      : 0;
  const int p0 = t * kPerThread;
  float xr[kPerThread], xi[kPerThread];
  if (pad == 0) {
    Loader<In>::load(raw, start + p0, xr, xi);
  } else {
    load_masked(raw, start - pad, p0, pad, xr, xi);
  }
  const float2 incl = block_scan(local_total(xr, xi, a, alpha), warp_tot, pw);
  sh[t] = incl;
  if (t == kThreads - 1) publish(slots + 4LL * k, incl);
  __syncthreads();
  if (t < 32) {
    const float2 mk = k == 0 ? make_float2(mean_in[0], mean_in[1])
                             : look_back(slots, k, mean_in, pw_tile);
    if (t == 0) {
      // the end value: the incoming mean decays over the valid samples
      const float2 e = sh[kThreads - 1];
      const float dl = pw[kTile - pad];
      const float2 end = make_float2(fmaf(dl, mk.x, e.x), fmaf(dl, mk.y, e.y));
      if (k < n_tiles - 1) {
        publish(slots + 4LL * k + 2, end);
      } else {
        mean_out[0] = end.x;
        mean_out[1] = end.y;
      }
      s_mk = mk;
    }
  }
  __syncthreads();
  // m just before this thread's samples: the zero-carry prefix there plus,
  // past the tile's first valid position, its incoming mean decayed over
  // the p0 - pad samples since; a thread that holds that position injects
  // the mean just before it
  const float2 mk = s_mk;
  const float2 excl = t > 0 ? sh[t - 1] : make_float2(0.f, 0.f);
  float2 m = excl;
  if (p0 > pad) {
    const float dec = pw[p0 - pad];
    m = make_float2(fmaf(dec, mk.x, excl.x), fmaf(dec, mk.y, excl.y));
  }
  float outr[kPerThread], outi[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (p0 + j == pad) {
      m.x += mk.x;
      m.y += mk.y;
    }
    m.x = fmaf(a, m.x, alpha * xr[j]);
    m.y = fmaf(a, m.y, alpha * xi[j]);
    outr[j] = xr[j] - m.x;
    outi[j] = xi[j] - m.y;
  }
  const long long first = start - pad;
  if (pad == 0) {
    // through shared memory, so that each warp store is 512 contiguous bytes
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      ybuf[0][t * (kPerThread / 4) + q] =
          make_float4(outr[4 * q], outr[4 * q + 1], outr[4 * q + 2], outr[4 * q + 3]);
      ybuf[1][t * (kPerThread / 4) + q] =
          make_float4(outi[4 * q], outi[4 * q + 1], outi[4 * q + 2], outi[4 * q + 3]);
    }
    __syncthreads();
    float4* pr = reinterpret_cast<float4*>(yr + first);
    float4* pi = reinterpret_cast<float4*>(yi + first);
#pragma unroll
    for (int q = 0; q < kPerThread / 4; ++q) {
      pr[t + kThreads * q] = ybuf[0][t + kThreads * q];
      pi[t + kThreads * q] = ybuf[1][t + kThreads * q];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (p0 + j >= pad) {
        yr[first + p0 + j] = outr[j];
        yi[first + p0 + j] = outi[j];
      }
    }
  }
}

template <typename In>
void launch(const In* raw, long long t_len, long long n_tiles, const float* mean_in,
            float* mean_out, float* yr, float* yi, unsigned long long* words,
            const float* pw, float alpha, cudaStream_t s) {
  dc_ingest_kernel<In><<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      raw, t_len, static_cast<int>(n_tiles), mean_in, mean_out, yr, yi, words, pw,
      pw + kPowN, alpha);
}

}  // namespace

// raw: interleaved I,Q [2*t_len], uint8 (is_u8) or float32, 16-byte aligned;
// any t_len >= 1, in tiles of 4096 samples (the last may be partial).
// scratch: at least 1 + 4 * ceil(t_len / 4096) 64-bit words, cleared here
// on the stream.  pw: float32 decay table (dckernel.decay_table).  Returns
// cudaGetLastError() after the launch.
extern "C" int dc_ingest_launch(const void* raw, int is_u8, long long t_len,
                                const float* mean_in, float* mean_out,
                                float* yr, float* yi, void* scratch,
                                const float* pw, double alpha, void* stream) {
  if (t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (t_len + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(1 + 4 * n_tiles) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* words = static_cast<unsigned long long*>(scratch);
  const float al = static_cast<float>(alpha);
  if (is_u8) {
    launch(static_cast<const uint8_t*>(raw), t_len, n_tiles, mean_in, mean_out, yr, yi,
           words, pw, al, s);
  } else {
    launch(static_cast<const float*>(raw), t_len, n_tiles, mean_in, mean_out, yr, yi,
           words, pw, al, s);
  }
  return static_cast<int>(cudaGetLastError());
}
