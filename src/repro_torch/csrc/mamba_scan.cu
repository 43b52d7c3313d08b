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
// The recurrence is sequential in t, so the TPU grid's sequential chunk
// dimension becomes a loop over steps inside the block, and the channels
// run in parallel: one thread owns one (b, channel) and keeps its 16
// states and its row of A in registers for the whole scan.  A block of 64
// channels stages a chunk of 32 steps at a time in shared memory: x and dt
// read coalesced across the channels, B_t and C_t (shared by every channel
// of the batch row) read once per block.  A thread reads its h0 before it
// writes the final state, so one tensor may be passed as both (the decode
// updates the cache in place).  expf, not __expf: the reference's 1e-4
// tolerance holds over thousands of steps.
//
// Bound on an H100: per (b, t, channel) the scan moves 12 bytes (x, dt in,
// y out) and does d_state exponentials and ~6 d_state f32 operations, so
// at d_state = 16 the exponentials on the special-function units (16 a
// clock per SM) and the bytes over 3.35 TB/s come out about even.  What
// the design does about it: every input byte is read once and y written
// once, the state never leaves registers, and the 16 independent states
// give each thread the instruction-level parallelism the sequential steps
// deny across time.  Shared memory is 20 KB.  The kernel allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDs = 16;        // d_state: the value in every config
constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 32;     // steps staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
mamba_ssm_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ dvec,
                 const float* h0, float* __restrict__ y, float* h_out, int S,
                 int di) {
  __shared__ float xs[kChunk][kThreads];
  __shared__ float dts[kChunk][kThreads];
  __shared__ float bs[kChunk][kDs];
  __shared__ float cs[kChunk][kDs];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < di;
  const int64_t state = (static_cast<int64_t>(b) * di + c) * kDs;
  float av[kDs], h[kDs];
  float dd = 0.f;
#pragma unroll
  for (int s = 0; s < kDs; ++s) {
    av[s] = live ? a[static_cast<int64_t>(c) * kDs + s] : 0.f;
    h[s] = (live && h0 != nullptr) ? h0[state + s] : 0.f;
  }
  if (live) dd = dvec[c];

  const int64_t row0 = static_cast<int64_t>(b) * S;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();     // the previous chunk's B, C are no longer read
    for (int j = 0; j < n; ++j) {
      const int64_t at = (row0 + t0 + j) * di + c;
      xs[j][threadIdx.x] = live ? x[at] : 0.f;
      dts[j][threadIdx.x] = live ? dt[at] : 0.f;
    }
    for (int i = threadIdx.x; i < n * kDs; i += kThreads) {
      const int64_t at = (row0 + t0) * kDs + i;
      bs[i / kDs][i % kDs] = bm[at];
      cs[i / kDs][i % kDs] = cm[at];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float xt = xs[j][threadIdx.x];
      const float dtt = dts[j][threadIdx.x];
      const float dx = dtt * xt;
      float yt = 0.f;
#pragma unroll
      for (int s = 0; s < kDs; ++s) {
        const float da = expf(dtt * av[s]);
        h[s] = da * h[s] + dx * bs[j][s];
        yt += h[s] * cs[j][s];
      }
      if (live) y[(row0 + t0 + j) * di + c] = yt + dd * xt;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kDs; ++s) h_out[state + s] = h[s];
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
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  mamba_ssm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dvec),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), static_cast<int>(S), static_cast<int>(di));
  return static_cast<int>(cudaGetLastError());
}
