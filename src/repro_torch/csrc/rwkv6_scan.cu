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
// Bound on an H100: the function needs per (b, t, h, i, j) 5 f32
// operations (r^T S: a product and a sum; w S + k v: two products and a
// sum) and per (b, t, h) 5 hd more for the bonus term, which is
// (sum_i r_i u_i k_i) v_j, against 20 bytes per (b, t, h, j) of r, k, v, w
// in and y out; at hd = 64 the bytes (3.35 TB/s) bound it, the operations
// (67 TFLOP/s) taking 0.8 of that time.
//
// The first design (one block of hd threads per (b, h), thread j walking
// its column's hd rows each step) was latency-bound: serving's B x H = 80
// pairs made 80 blocks of 2 warps on 132 SMs, each step a 64-deep chain of
// shared-memory reads and FMAs (~1,200 cycles a step); the staging of a
// chunk never overlapped the steps; and the bonus term cost 2 more
// operations per element.  This design:
//   - splits each pair's state over more threads: a thread holds kRows
//     rows of one column in registers (8 at hd 64), and the kGroups
//     threads that share a column sit in one warp.  The columns of a pair
//     are split over 2 to 8 blocks, so that there are about 4 blocks an SM
//     (serving's 80 pairs make 640 blocks of 2 compute warps);
//   - sums y_t over a column's rows kGroups steps at a time: each step's
//     partial stays in a register, and then the kGroups lanes
//     reduce-scatter the batch with halving shuffles in a fixed order (no
//     atomics: deterministic), kGroups - 1 exchanges for kGroups steps
//     where one sum a step would take log2(kGroups) dependent ones;
//   - stages r, k, w and the block's columns of v through a ring of
//     kStages chunks of kChunk steps in shared memory, filled by one
//     staging warp with cp.async (16-byte copies where every row is
//     aligned, 4-byte ones otherwise).  Chunk c + 2 is in flight and
//     chunk c + 1 has landed while the compute warps step chunk c, so one
//     barrier a chunk is the only synchronisation;
//   - has the staging warp compute the bonus b_t = sum_i r_i u_i k_i once
//     a step, for the chunk that has landed, into shared memory: a compute
//     thread adds b_t v_j to its column's y_t, so an element costs the
//     bound's 5 operations (a product and two FMAs);
//   - reads r, k, w as float4 broadcasts: thread g of a column holds the
//     rows of quads g, g + kGroups, ..., so the kGroups row groups of a
//     warp hit kGroups distinct bank quads (one wavefront).
// No tensor cores, on purpose.  The chunked matrix form (products of r and
// k under cumulative decays, as flash-linear-attention computes it) would
// run them in TF32, which keeps about three digits and cannot meet the
// 1e-4 tolerance over a served prefill.  Its decay factors also under- or
// overflow within a chunk at w down to 0.37.  The recurrence as written
// costs 5 operations an element, no more than that form on the f32 units.
// Each state element is read from state0 and written to state_out by the
// same thread, after its last read, so one tensor may be passed as both
// (the decode updates the cache in place); neither pointer is __restrict__.
// All f32, no fast math; the kernel allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 16;     // steps a stage of the ring holds
constexpr int kStages = 3;     // chunk c stepped, c + 1 landed, c + 2 sent
constexpr int kMaxParts = 8;   // blocks a (batch, head) pair's columns span
constexpr unsigned kFull = 0xffffffffu;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// How a head size's state is cut over threads.
template <int HD>
struct Wkv {
  static constexpr int kRows = HD == 64 ? 8 : 4;    // state rows a thread
  static constexpr int kGroups = HD / kRows;        // threads sharing a column
  static constexpr int kSlots = 32 / kGroups;       // columns of a warp
  static constexpr int kMaxCols = HD / 2;           // a block holds <= half
  static constexpr int kThreads = kMaxCols / kSlots * 32 + 32;
  static_assert(kGroups * kSlots == 32 && kMaxCols % kSlots == 0, "");
};

template <int HD>
struct Ring {
  float r[kStages][kChunk][HD];
  float k[kStages][kChunk][HD];
  float w[kStages][kChunk][HD];
  float v[kStages][kChunk][Wkv<HD>::kMaxCols];
  float bonus[kStages][kChunk];
  float u[HD];
};

// The staging warp: chunk rows [t0, t0 + n) of r, k, w (whole rows) and v
// (the block's columns) into stage `slot`, as one cp.async group.
template <int HD>
__device__ __forceinline__ void stage(Ring<HD>& ring, int slot, int lane,
                                      const float* r, const float* k,
                                      const float* w, const float* v,
                                      int64_t row, int t0, int n, int cols,
                                      bool vec) {
  if (vec) {
    constexpr int kQuads = HD / 4;
    for (int i = lane; i < n * kQuads; i += 32) {
      const int t = i / kQuads, e = 4 * (i % kQuads);
      const int64_t at = (t0 + t) * row + e;
      cp_async16(&ring.r[slot][t][e], r + at);
      cp_async16(&ring.k[slot][t][e], k + at);
      cp_async16(&ring.w[slot][t][e], w + at);
    }
    const int vq = cols / 4;
    for (int i = lane; i < n * vq; i += 32) {
      const int t = i / vq, e = 4 * (i % vq);
      cp_async16(&ring.v[slot][t][e], v + (t0 + t) * row + e);
    }
  } else {
    for (int i = lane; i < n * HD; i += 32) {
      const int t = i / HD, e = i % HD;
      const int64_t at = (t0 + t) * row + e;
      cp_async4(&ring.r[slot][t][e], r + at);
      cp_async4(&ring.k[slot][t][e], k + at);
      cp_async4(&ring.w[slot][t][e], w + at);
    }
    for (int i = lane; i < n * cols; i += 32) {
      const int t = i / cols, e = i % cols;
      cp_async4(&ring.v[slot][t][e], v + (t0 + t) * row + e);
    }
  }
  cp_async_commit();
}

// The staging warp, once the chunk in `slot` has landed: b_t = sum_i r_i
// u_i k_i for its n steps.  Lanes t and t + 16 each sum half the rows of
// step t, from a quad that rotates with t (so the 8 lanes of a load phase
// hit 8 bank quads), then one shuffle.
template <int HD>
__device__ __forceinline__ void bonus(Ring<HD>& ring, int slot, int lane,
                                      int n) {
  static_assert(kChunk == 16, "two lanes a step");
  constexpr int kHalf = HD / 8;                 // quads in half a row
  const int t = lane % kChunk;
  const int half = lane / kChunk;
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const int e = 4 * (half * kHalf + (m + t) % kHalf);
    const float4 r4 = *reinterpret_cast<const float4*>(&ring.r[slot][t][e]);
    const float4 k4 = *reinterpret_cast<const float4*>(&ring.k[slot][t][e]);
    const float4 u4 = *reinterpret_cast<const float4*>(&ring.u[e]);
    acc = fmaf(r4.x * u4.x, k4.x, acc);
    acc = fmaf(r4.y * u4.y, k4.y, acc);
    acc = fmaf(r4.z * u4.z, k4.z, acc);
    acc = fmaf(r4.w * u4.w, k4.w, acc);
  }
  acc += __shfl_xor_sync(kFull, acc, kChunk);
  if (half == 0 && t < n) ring.bonus[slot][t] = acc;
}

// A compute thread: steps u0 .. u0 + G - 1 of the chunk in `slot` (those
// below n; all of them when kWhole, with no test in the unrolled body) on
// its rows of column cb (of the block) / j (of the head).  Each step's y
// partial over its rows stays in a register; then the G = kGroups lanes of
// the column reduce-scatter them (at each halving a lane keeps the half of
// the steps its bit of g selects and adds its partner's partials of that
// half), so lane g ends with step u0 + g's sum over all rows and writes
// it, plus the bonus term, to y.
template <int HD, bool kWhole>
__device__ __forceinline__ void batch(const Ring<HD>& ring, int slot,
                                      float (&s)[Wkv<HD>::kRows], float* yp,
                                      int64_t row, int u0, int n, int g,
                                      int cb) {
  using P = Wkv<HD>;
  constexpr int R = P::kRows, G = P::kGroups;
  float acc[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    acc[u] = 0.f;
    const int t = u0 + u;
    if (!kWhole && t >= n) continue;        // the same for the whole block
    float rr[R], kk[R], ww[R];
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {
      const int e = 4 * (g + G * m);
      const float4 r4 = *reinterpret_cast<const float4*>(&ring.r[slot][t][e]);
      const float4 k4 = *reinterpret_cast<const float4*>(&ring.k[slot][t][e]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ring.w[slot][t][e]);
      rr[4 * m] = r4.x; rr[4 * m + 1] = r4.y;
      rr[4 * m + 2] = r4.z; rr[4 * m + 3] = r4.w;
      kk[4 * m] = k4.x; kk[4 * m + 1] = k4.y;
      kk[4 * m + 2] = k4.z; kk[4 * m + 3] = k4.w;
      ww[4 * m] = w4.x; ww[4 * m + 1] = w4.y;
      ww[4 * m + 2] = w4.z; ww[4 * m + 3] = w4.w;
    }
    const float vj = ring.v[slot][t][cb];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float kv = kk[i] * vj;
      acc[u] = fmaf(rr[i], s[i], acc[u]);
      s[i] = fmaf(ww[i], s[i], kv);
    }
  }
#pragma unroll
  for (int half = G / 2; half >= 1; half /= 2) {
    const bool upper = (g & half) != 0;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const float keep = upper ? acc[m + half] : acc[m];
      const float send = upper ? acc[m] : acc[m + half];
      acc[m] = keep + __shfl_xor_sync(kFull, send, half * P::kSlots);
    }
  }
  const int t = u0 + g;
  if (kWhole || t < n)
    yp[static_cast<int64_t>(t) * row] =
        fmaf(ring.bonus[slot][t], ring.v[slot][t][cb], acc[0]);
}

template <int HD>
__global__ void __launch_bounds__(Wkv<HD>::kThreads)
rwkv6_wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* state0,
                 float* __restrict__ y, float* state_out, int S, int H,
                 bool vec) {
  using P = Wkv<HD>;
  constexpr int R = P::kRows, G = P::kGroups;
  __shared__ __align__(16) Ring<HD> ring;

  const int bh = blockIdx.x;                // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int cols = HD / gridDim.y;          // this block's columns
  const int col0 = blockIdx.y * cols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool stager = warp == cols / P::kSlots;
  const int64_t row = static_cast<int64_t>(H) * HD;  // a step of (B, S, H, hd)
  const int64_t head = static_cast<int64_t>(b) * S * row +
                       static_cast<int64_t>(h) * HD;
  const float* rh = r + head;
  const float* kh = k + head;
  const float* wh = w + head;
  const float* vh = v + head + col0;
  const int chunks = (S + kChunk - 1) / kChunk;

  // a compute thread's piece of the state: rows 4 (g + G m) + e of column j
  const int g = lane / P::kSlots;
  const int cb = warp * P::kSlots + lane % P::kSlots;    // in the block
  const int64_t st = static_cast<int64_t>(bh) * HD * HD + col0 + cb;
  const auto at = [&](int i) {
    return st + static_cast<int64_t>(4 * (g + G * (i / 4)) + i % 4) * HD;
  };
  float s[R];

  if (stager) {
    for (int i = lane; i < HD; i += 32) ring.u[i] = u[h * HD + i];
    stage(ring, 0, lane, rh, kh, wh, vh, row, 0, min(kChunk, S), cols, vec);
    stage(ring, 1, lane, rh, kh, wh, vh, row, kChunk,
          min(kChunk, S - kChunk), cols, vec);
    cp_async_wait<1>();                     // chunk 0 landed
    __syncwarp();
    bonus(ring, 0, lane, min(kChunk, S));
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      s[i] = state0 != nullptr ? state0[at(i)] : 0.f;
  }
  __syncthreads();

  float* yp = y + head + col0 + cb;
  for (int ch = 0; ch < chunks; ++ch) {
    const int slot = ch % kStages;
    const int t0 = ch * kChunk;
    const int n = min(kChunk, S - t0);
    if (stager) {
      stage(ring, (ch + 2) % kStages, lane, rh, kh, wh, vh, row,
            t0 + 2 * kChunk, min(kChunk, S - t0 - 2 * kChunk), cols, vec);
      if (ch + 1 < chunks) {
        cp_async_wait<1>();                 // chunk ch + 1 landed
        __syncwarp();
        bonus(ring, (ch + 1) % kStages, lane, min(kChunk, S - t0 - kChunk));
      }
    } else {
      float* yc = yp + static_cast<int64_t>(t0) * row;
      if (n == kChunk) {        // a whole chunk unrolled: one batch's loads
#pragma unroll                  // overlap the last one's exchanges
        for (int u0 = 0; u0 < kChunk; u0 += G)
          batch<HD, true>(ring, slot, s, yc, row, u0, n, g, cb);
      } else {
        for (int u0 = 0; u0 < n; u0 += G)
          batch<HD, false>(ring, slot, s, yc, row, u0, n, g, cb);
      }
    }
    __syncthreads();
  }

  if (!stager) {
#pragma unroll
    for (int i = 0; i < R; ++i) state_out[at(i)] = s[i];
  }
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* state0, void* y, void* state_out,
           int64_t B, int64_t S, int64_t H, cudaStream_t stream) {
  using P = Wkv<HD>;
  // a pair's columns over 2, 4 or 8 blocks: the fewest that give about 4
  // blocks an SM, each with at least one compute warp
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int parts = 2;
  while (parts < kMaxParts && B * H * parts < 4 * static_cast<int64_t>(sms) &&
         HD / (2 * parts) >= P::kSlots)
    parts *= 2;
  const int threads = HD / parts / P::kSlots * 32 + 32;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = aligned(r) && aligned(k) && aligned(v) && aligned(w);
  rwkv6_wkv_kernel<HD><<<dim3(static_cast<unsigned>(B * H), parts), threads,
                         0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(y), static_cast<float*>(state_out),
      static_cast<int>(S), static_cast<int>(H), vec);
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
