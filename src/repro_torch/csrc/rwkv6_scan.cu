// RWKV-6 WKV recurrence with a carried state, in f32.
//
// Replaces the JAX package's Pallas kernel kernels/rwkv6_scan/kernel.py::
// rwkv6_wkv (body _wkv_kernel), as the model's wkv_scan uses it
// (models/rwkv6.py): for every (batch b, head h) with a (hd x hd) state S
// whose first index is k's,
//     y_t = r_t^T (S + diag(u) k_t v_t^T)
//     S   = diag(w_t) S + k_t v_t^T
// from S = state0 (zero when none is given), returning y and the final
// state.  With a zero state this is the Pallas kernel; serving needs more:
// a prefill leaves the state in the cache, and each decode step is a scan
// of S = 1 from it.  So the kernel also takes the model's (B, S, H, hd)
// layout (no transpose copy), any S (the Pallas kernel asserts S % chunk
// == 0), and writes the final state, which may be the buffer it read.
//
// The recurrence is sequential in t, so the TPU grid's sequential chunk
// dimension becomes a loop over steps inside the block, and the (batch,
// head) pairs run in parallel: one block per pair, hd threads.  Thread j
// owns column j of the state, S[:, j], in hd registers for the whole scan;
// per step it needs all of r_t, k_t, w_t and u, which a chunk of steps at a
// time stages in shared memory (v with them, so a chunk's loads are in
// flight together) and every thread reads as broadcasts.  A thread reads
// its column of state0 before it writes the final state, and no two blocks
// share a pair, so one tensor may be passed as both (the decode updates the
// cache in place).  All f32, no fast math.
//
// Bound on an H100: the function needs per (b, t, h, i, j) 5 f32
// operations (r^T S: a product and a sum; w S + k v: two products and a
// sum) and per (b, t, h) 5 hd more for the bonus term, which is
// (sum_i r_i u_i k_i) v_j, against 20 bytes per (b, t, h, j) of r, k, v, w
// in and y out; at hd = 64 the bytes (3.35 TB/s) bound it, the operations
// (67 TFLOP/s) taking 0.8 of that time.  This kernel computes the bonus
// term per element, 7 operations per (b, t, h, i, j).
// What this first design does about it: every input byte is read once and
// y written once, the state never leaves registers, and the y sum runs in
// four partial sums so the unrolled step has independent FMA chains.  It
// is latency-bound all the same: a serving batch has B x H = 80 blocks of
// 64 threads, under one wave on 132 SMs.  Shared memory is 33 KB at hd 64.
// The kernel allocates nothing and does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 32;     // steps staged in shared memory at a time

template <int HD>
__global__ void __launch_bounds__(HD)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* state0,
                 float* __restrict__ y, float* state_out, int S, int H) {
  __shared__ float rs[kChunk][HD];
  __shared__ float ks[kChunk][HD];
  __shared__ float vs[kChunk][HD];
  __shared__ float ws[kChunk][HD];
  __shared__ float us[HD];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;               // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int64_t st = static_cast<int64_t>(bh) * HD * HD;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s[i] = state0 != nullptr ? state0[st + static_cast<int64_t>(i) * HD + j]
                             : 0.f;
  us[j] = u[h * HD + j];

  // element (b, t, h, j) of a (B, S, H, hd) tensor
  const int64_t row = static_cast<int64_t>(H) * HD;
  const int64_t base = static_cast<int64_t>(b) * S * row +
                       static_cast<int64_t>(h) * HD + j;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();     // the previous chunk is no longer read (and us set)
    for (int c = 0; c < n; ++c) {
      const int64_t at = base + (t0 + c) * row;
      rs[c][j] = r[at];
      ks[c][j] = k[at];
      vs[c][j] = v[at];
      ws[c][j] = w[at];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[c][i] * vj;
        acc[i % 4] += rs[c][i] * (s[i] + us[i] * kv);
        s[i] = ws[c][i] * s[i] + kv;
      }
      y[base + (t0 + c) * row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i)
    state_out[st + static_cast<int64_t>(i) * HD + j] = s[i];
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* state0, void* y, void* state_out,
           int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  rwkv6_wkv_kernel<HD><<<static_cast<unsigned>(B * H), HD, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(state_out),
      static_cast<int>(S), static_cast<int>(H));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, y: (B, S, H, hd); u: (H, hd); state0 (nullable) and
// state_out: (B, H, hd, hd), k index first; all f32, contiguous.  state0
// may equal state_out.  hd must be 16, 32 or 64.  Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* state0, void* y, void* state_out,
                                int64_t B, int64_t S, int64_t H, int64_t hd,
                                void* stream) {
  if (B < 0 || S < 0 || H <= 0 || S > INT32_MAX || H > INT32_MAX ||
      B * H > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(r, k, v, w, u, state0, y, state_out, B, S, H, s);
    case 32: return launch<32>(r, k, v, w, u, state0, y, state_out, B, S, H, s);
    case 64: return launch<64>(r, k, v, w, u, state0, y, state_out, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
