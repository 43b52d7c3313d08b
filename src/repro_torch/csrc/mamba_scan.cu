// Mamba (S6) selective scan with a carried state, in f32.
//
// Replaces the JAX package's Pallas kernel kernels/mamba_scan/kernel.py::
// mamba_ssm (body _mamba_kernel), as the model's ssm_scan uses it
// (models/mamba.py): for every (batch b, channel c) and step t
//     h_t = exp(dt_t * A[c]) * h_{t-1} + (dt_t * x_t) * B_t     (d_state wide)
//     y_t = <h_t, C_t> + D[c] * x_t
// from h_{-1} = h0 (zero when none is given), returning y (B, S, di) and
// the final state (B, di, d_state).  With h0 = 0 this is the Pallas kernel;
// the carried state is what serving needs: a prefill leaves it in the
// cache, and each decode step is a scan of S = 1 from it.
//
// Bound on an H100: per (b, t, channel) the scan moves 12 bytes (x, dt in,
// y out) and does d_state exponentials and ~6 d_state f32 operations, so
// at d_state = 16 the exponentials on the special-function units (16 a
// clock per SM) bound it, the bytes over 3.35 TB/s taking about as long.
//
// The first design gave each (b, channel) one thread holding all 16
// states: serving's 2 x 8,192 channels made 16,384 threads, ~3.9 warps an
// SM, too few to cover the exponentials' latency, and a block loaded each
// chunk of steps, synchronised and only then stepped it, so nothing was in
// flight while the steps ran.  This design:
//   - splits a channel's 16 states over kLanes = 4 neighbouring lanes, 4
//     states each (its A and states in registers), y_t summed over the 4
//     lanes: 4x the warps (~15.5 an SM at serving's shape) in blocks of 64
//     channels, 256 threads;
//   - stages x, dt (the block's channels) and B_t, C_t (shared by every
//     channel of the batch row) through a ring of kStages chunks of kChunk
//     steps in shared memory: every thread issues cp.async copies of chunk
//     c + 1 right after the barrier that opens chunk c, so they are in
//     flight while chunk c is stepped, and one barrier a chunk is the only
//     synchronisation.  16-byte copies where every row is aligned (di a
//     multiple of 4), 4-byte ones otherwise; B_t and C_t are read as
//     float4 broadcasts;
//   - sums y_t over a channel's 4 lanes kLanes steps at a time: each
//     step's partial stays in a register, and then the 4 lanes
//     reduce-scatter the batch with halving shuffles in a fixed order (no
//     atomics: deterministic), 3 exchanges for 4 steps where one sum a
//     step would take 2 dependent ones;
//   - computes exp(dt A) as exp2f(dt (A log2 e)) with A log2 e held in
//     registers: one special-function instruction and a few on the FMA
//     pipe, where expf's range reduction takes ~4 more (no __expf, no fast
//     math; the reference's 1e-4 tolerance holds over the sweep and on
//     the served activations).
// Each state element is read from h0 and written to h_out by the same
// thread, after its last read, so one tensor may be passed as both (the
// decode updates the cache in place); neither pointer is __restrict__.
// The kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDs = 16;                  // d_state: the value in every config
constexpr int kLanes = 4;                // lanes a channel
constexpr int kStatesPerLane = kDs / kLanes;
constexpr int kChannels = 64;            // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kChunk = 32;               // steps a stage of the ring holds
constexpr int kStages = 2;               // chunk c stepped, c + 1 in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Ring {
  float x[kStages][kChunk][kChannels];
  float dt[kStages][kChunk][kChannels];
  float bm[kStages][kChunk][kDs];
  float cm[kStages][kChunk][kDs];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Every thread: its share of chunk rows [t0, t0 + n) of x and dt (channels
// c0 .. c0 + kChannels - 1 that exist) and of B and C into stage `slot`,
// as one cp.async group.
__device__ __forceinline__ void stage(Ring& ring, int slot, const float* x,
                                      const float* dt, const float* bm,
                                      const float* cm, int64_t row0, int n,
                                      int di, int c0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kQuads = kChannels / 4;
    for (int i = tid; i < n * kQuads; i += kThreads) {
      const int t = i / kQuads, q = i % kQuads;
      if (c0 + 4 * q < di) {
        const int64_t at = (row0 + t) * di + c0 + 4 * q;
        cp_async16(&ring.x[slot][t][4 * q], x + at);
        cp_async16(&ring.dt[slot][t][4 * q], dt + at);
      }
    }
    for (int i = tid; i < n * (kDs / 4); i += kThreads) {
      const int64_t at = row0 * kDs + 4 * i;
      cp_async16(&ring.bm[slot][0][0] + 4 * i, bm + at);
      cp_async16(&ring.cm[slot][0][0] + 4 * i, cm + at);
    }
  } else {
    for (int i = tid; i < n * kChannels; i += kThreads) {
      const int t = i / kChannels, e = i % kChannels;
      if (c0 + e < di) {
        const int64_t at = (row0 + t) * di + c0 + e;
        cp_async4(&ring.x[slot][t][e], x + at);
        cp_async4(&ring.dt[slot][t][e], dt + at);
      }
    }
    for (int i = tid; i < n * kDs; i += kThreads) {
      cp_async4(&ring.bm[slot][0][0] + i, bm + row0 * kDs + i);
      cp_async4(&ring.cm[slot][0][0] + i, cm + row0 * kDs + i);
    }
  }
  cp_async_commit();
}

// A thread: steps u0 .. u0 + kLanes - 1 of the chunk in `slot` (those
// below n; all of them when kWhole, with no test in the unrolled body) on
// its kStatesPerLane states of channel c.  Each step's partial <h, C>
// stays in a register; then the kLanes lanes of the channel reduce-scatter
// them (two halving exchanges, a fixed order), so lane q ends with step
// u0 + q's sum and writes its y.
template <bool kWhole>
__device__ __forceinline__ void batch(const Ring& ring, int slot,
                                      const float (&av)[kStatesPerLane],
                                      float (&h)[kStatesPerLane], float dd,
                                      float* __restrict__ y, int64_t row,
                                      int u0, int n, int di, int c, int cl,
                                      int q, bool live) {
  float acc[kLanes];
#pragma unroll
  for (int u = 0; u < kLanes; ++u) {
    acc[u] = 0.f;
    const int t = u0 + u;
    if (!kWhole && t >= n) continue;        // the same for the whole block
    const float xt = ring.x[slot][t][cl];
    const float dtt = ring.dt[slot][t][cl];
    const float4 b4 = *reinterpret_cast<const float4*>(
        &ring.bm[slot][t][q * kStatesPerLane]);
    const float4 c4 = *reinterpret_cast<const float4*>(
        &ring.cm[slot][t][q * kStatesPerLane]);
    const float bv[kStatesPerLane] = {b4.x, b4.y, b4.z, b4.w};
    const float cv[kStatesPerLane] = {c4.x, c4.y, c4.z, c4.w};
    const float dx = dtt * xt;
#pragma unroll
    for (int s = 0; s < kStatesPerLane; ++s) {
      const float da = exp2f(dtt * av[s]);     // exp(dt A)
      h[s] = fmaf(da, h[s], dx * bv[s]);
      acc[u] = fmaf(h[s], cv[s], acc[u]);
    }
  }
#pragma unroll
  for (int half = kLanes / 2; half >= 1; half /= 2) {
    const bool upper = (q & half) != 0;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const float keep = upper ? acc[m + half] : acc[m];
      const float send = upper ? acc[m] : acc[m + half];
      acc[m] = keep + __shfl_xor_sync(kFull, send, half);
    }
  }
  const int t = u0 + q;
  if (live && (kWhole || t < n))
    y[(row + t) * di + c] = fmaf(dd, ring.x[slot][t][cl], acc[0]);
}

__global__ void __launch_bounds__(kThreads)
mamba_ssm_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ dvec,
                 const float* h0, float* __restrict__ y, float* h_out, int S,
                 int di, bool vec) {
  __shared__ __align__(16) Ring ring;

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int cl = threadIdx.x / kLanes;          // channel in the block
  const int q = threadIdx.x % kLanes;           // quarter of its states
  const int c = c0 + cl;
  const bool live = c < di;
  const int64_t state = (static_cast<int64_t>(b) * di + c) * kDs +
                        q * kStatesPerLane;
  const int64_t row0 = static_cast<int64_t>(b) * S;   // (b, 0) of (B, S, .)

  stage(ring, 0, x, dt, bm, cm, row0, min(kChunk, S), di, c0, vec);
  float av[kStatesPerLane], h[kStatesPerLane];
  float dd = 0.f;
#pragma unroll
  for (int s = 0; s < kStatesPerLane; ++s) {
    av[s] = live ? a[static_cast<int64_t>(c) * kDs + q * kStatesPerLane + s] *
                       kLog2e
                 : 0.f;
    h[s] = (live && h0 != nullptr) ? h0[state + s] : 0.f;
  }
  if (live) dd = dvec[c];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int slot = (t0 / kChunk) % kStages;
    const int n = min(kChunk, S - t0);
    cp_async_wait_all();                // this thread's copies of the chunk
    __syncthreads();                    // everyone's, and chunk - 1 stepped
    stage(ring, (slot + 1) % kStages, x, dt, bm, cm, row0 + t0 + kChunk,
          min(kChunk, S - t0 - kChunk), di, c0, vec);
    if (n == kChunk) {
#pragma unroll
      for (int u0 = 0; u0 < kChunk; u0 += kLanes)
        batch<true>(ring, slot, av, h, dd, y, row0 + t0, u0, n, di, c, cl, q,
                    live);
    } else {
      for (int u0 = 0; u0 < n; u0 += kLanes)
        batch<false>(ring, slot, av, h, dd, y, row0 + t0, u0, n, di, c, cl,
                     q, live);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kStatesPerLane; ++s) h_out[state + s] = h[s];
  }
}

}  // namespace

// x, dt, y: (B, S, di); bm, cm: (B, S, ds); a: (di, ds); dvec: (di,);
// h0 (nullable) and h_out: (B, di, ds); all f32, contiguous.  h0 may equal
// h_out.  ds must be 16.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mamba_ssm_launch(const void* x, const void* dt, const void* bm,
                                const void* cm, const void* a,
                                const void* dvec, const void* h0, void* y,
                                void* h_out, int64_t B, int64_t S, int64_t di,
                                int64_t ds, void* stream) {
  if (ds != kDs || B < 0 || S < 0 || di < 0 || B > 65535 || S > INT32_MAX ||
      di > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || di == 0) return 0;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = di % 4 == 0 && aligned(x) && aligned(dt) && aligned(bm) &&
                   aligned(cm);
  const dim3 grid(static_cast<unsigned>((di + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  mamba_ssm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dvec),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<int>(S), static_cast<int>(di),
      vec);
  return static_cast<int>(cudaGetLastError());
}
