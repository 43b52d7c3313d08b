// Grouped-query forward attention, causal or not, with an f32 online
// softmax.
//
// Replaces the JAX package's Pallas kernel
// kernels/flash_attention/kernel.py::flash_attention_grouped (body
// _fa_kernel).  It takes the model's own layouts as _project_qkv makes
// them, q (B, S, H, hd) and k, v (B, S, Kv, hd), bf16 or f32, contiguous,
// with no transpose copy, and writes o (B, S, H, hd) in q's dtype.
//
// One block owns one (batch, kv head, query tile) and all G = H / Kv query
// heads of that group: kRows = 64 (query, head) rows, G rows per query
// position, so a tile holds 64 / G query positions.  The K and V tiles of
// the group are staged into shared memory once and serve all G heads, as
// the TPU kernel's (G * bq)-row blocks did.  A loop over kv tiles inside
// the block takes the place of the TPU grid's sequential kv dimension; when
// causal it stops at the tile holding the block's last query position, and
// keys at or past S are masked here, so nothing pads S to a tile multiple.
// The running max, denominator and output accumulator are f32 in
// registers, and the result is divided by max(denom, 1e-30) at the end, as
// in the Pallas kernel.  Where the caller passes an lse buffer, each row's
// log-sum-exp m + log(max(denom, 1e-30)) of the scaled scores is written
// there too (B, S, H) f32, as the JAX model's _fa_forward returns it for
// the backward; serving passes null.  Each body is instantiated with and
// without that write, so serving runs the body it ran before.  Two bodies share that decomposition:
//   - bf16: the products on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate), the serving path's dtype;
//   - f32: scalar f32 FMAs (4 threads per row, hd / 4 dims each), exact
//     f32 math for the f32 configurations and the tests' 2e-5 tolerance.
//
// Bound on an H100: at the serving shapes (S in the hundreds to thousands,
// hd 128) attention does ~S/2 multiply-adds per byte it must move, far
// above the card's balance, so it is bound by arithmetic: the tensor
// cores' 989 TFLOP/s (bf16 dense).  What the design does about it: every
// K/V element is read from device memory once per block for G heads at
// once, kv tiles wholly above the diagonal are skipped, the longest causal
// rows are scheduled first, and the bf16 body feeds the tensor cores from
// registers and conflict-free shared memory.  mma.sync reaches only part of
// the Hopper tensor-core rate, and nothing overlaps the tile loads with the
// products; wgmma, TMA and a warp-specialised pipeline are later work.
// Shared memory stays under the 48 KB static limit (see
// flash_attention_smem_bytes).  The kernel allocates nothing and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                  // (query, head) rows per block
constexpr int kTpr = kThreads / kRows;     // threads per row
constexpr int kBk = 32;                    // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------- f32 on scalar FMAs ----
template <int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int Kv, int G,
                       int bq, float scale, int causal) {
  constexpr int kChunks = HD / (4 * kTpr);   // float4 chunks per thread
  __shared__ __align__(16) float ks[kBk][HD];
  __shared__ __align__(16) float vs[kBk][HD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * bq;
  const int tid = threadIdx.x;
  const int r = tid / kTpr;
  const int sub = tid % kTpr;
  const int qpos = q0 + r / G;
  const int h = kvh * G + r % G;
  const bool live = r < G * bq && qpos < S;
  // this thread's dims: [16 c + 4 sub, 16 c + 4 sub + 4) for c < kChunks
  const int64_t row = ((static_cast<int64_t>(b) * S + qpos) * H + h) * HD;

  float qr[4 * kChunks], acc[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = ld4(q + row + 16 * c + 4 * sub);
    qr[4 * c] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 4 * kChunks; ++i) acc[i] = 0.f;
  float m = kNegInf, den = 0.f;

  const int q_last = min(S, q0 + bq) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * S * Kv + kvh) * HD;

  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();
    for (int i = tid; i < kBk * HD / 4; i += kThreads) {
      const int j = i / (HD / 4);
      const int c = (i % (HD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < S) {
        const int64_t at = kv_base + (k0 + j) * kv_stride + c;
        kx = ld4(k + at);
        vx = ld4(v + at);
      }
      *reinterpret_cast<float4*>(&ks[j][c]) = kx;
      *reinterpret_cast<float4*>(&vs[j][c]) = vx;
    }
    __syncthreads();

    float s[kBk];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kx =
            *reinterpret_cast<const float4*>(&ks[j][16 * c + 4 * sub]);
        part = fmaf(qr[4 * c], kx.x, part);
        part = fmaf(qr[4 * c + 1], kx.y, part);
        part = fmaf(qr[4 * c + 2], kx.z, part);
        part = fmaf(qr[4 * c + 3], kx.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      const bool masked = kpos >= S || (causal && kpos > qpos);
      s[j] = masked ? kNegInf : part * scale;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    den = den * corr + psum;
#pragma unroll
    for (int i = 0; i < 4 * kChunks; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vx =
            *reinterpret_cast<const float4*>(&vs[j][16 * c + 4 * sub]);
        acc[4 * c] = fmaf(s[j], vx.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(s[j], vx.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(s[j], vx.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(s[j], vx.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float d = fmaxf(den, 1e-30f);
  if (kLse && sub == 0) lse[row / HD] = m + logf(d);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    *reinterpret_cast<float4*>(o + row + 16 * c + 4 * sub) =
        make_float4(acc[4 * c] / d, acc[4 * c + 1] / d, acc[4 * c + 2] / d,
                    acc[4 * c + 3] / d);
}

// ------------------------------------------------ bf16 on tensor cores ----
// The same block decomposition with the products on the tensor cores:
// mma.sync m16n8k16, bf16 inputs, f32 accumulation.  Four warps of 16 rows
// each; Q stays in registers as A fragments, each K tile is staged row-major
// and each V tile transposed (so every B fragment is one 32-bit shared load),
// both with 8 elements of padding per row against bank conflicts.  The
// probabilities are rounded to bf16 for the PV product, as the JAX model's
// XLA fallback does (p.astype(v.dtype)); scores, max, denominator and the
// output accumulator stay f32.
constexpr int kMmaThreads = 128;           // 4 warps x 16 rows = kRows
constexpr int kMmaBk = 64;                 // keys per tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Three blocks of 128 threads fit an SM only at <= 168 registers a thread
// (registers are allocated 256 a warp); at hd 128 the LSE epilogue alone
// took the body to 170, two blocks an SM and 15 % slower, so hd 128 asks
// for three.  hd 64 keeps three blocks at the 140-167 registers it takes.
template <int HD, bool kLse>
__global__ void __launch_bounds__(kMmaThreads, HD >= 128 ? 3 : 1)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int Kv,
                           int G, int bq, float scale, int causal) {
  constexpr int KS = HD / 16;              // k-steps over the head dim
  constexpr int NT = kMmaBk / 8;           // key n-tiles per kv tile
  constexpr int OT = HD / 8;               // output n-tiles
  constexpr int KLD = HD + 8;              // K tile row stride (elements)
  constexpr int VLD = kMmaBk + 8;          // V^T tile row stride
  __shared__ __align__(16) bf16 ks[kMmaBk * KLD];
  __shared__ __align__(16) bf16 vt[HD * VLD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * bq;
  const int warp = threadIdx.x / 32;
  const int gid = (threadIdx.x % 32) / 4;     // fragment row group
  const int tig = threadIdx.x % 4;            // thread in group
  // this thread's two rows: gid and gid + 8 of the warp's 16
  int qpos[2];
  bool live[2];
  int64_t row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + r / G;
    live[i] = r < G * bq && qpos[i] < S;
    row[i] = ((static_cast<int64_t>(b) * S + qpos[i]) * H + kvh * G + r % G) *
             HD;
  }
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 16 * kk + 2 * tig;
    qf[kk][0] = live[0] ? ld32(q + row[0] + c) : 0u;
    qf[kk][1] = live[1] ? ld32(q + row[1] + c) : 0u;
    qf[kk][2] = live[0] ? ld32(q + row[0] + c + 8) : 0u;
    qf[kk][3] = live[1] ? ld32(q + row[1] + c + 8) : 0u;
  }
  float oacc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
    oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};

  const int q_last = min(S, q0 + bq) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * S * Kv + kvh) * HD;

  for (int k0 = 0; k0 < k_end; k0 += kMmaBk) {
    __syncthreads();
    // neighbouring threads take neighbouring keys of one 8-element chunk
    for (int i = threadIdx.x; i < kMmaBk * HD / 8; i += kMmaThreads) {
      const int j = i % kMmaBk;
      const int c = (i / kMmaBk) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + j < S) {
        const int64_t at = kv_base + (k0 + j) * kv_stride + c;
        kx = *reinterpret_cast<const uint4*>(k + at);
        vx = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(&ks[j * KLD + c]) = kx;
      const bf16* ve = reinterpret_cast<const bf16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * VLD + j] = ve[e];
    }
    __syncthreads();

    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
      const bf16* kr = &ks[(8 * n + gid) * KLD + 2 * tig];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(sacc[n], qf[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + 8 * n + 2 * tig + (e & 1);
        const bool masked = kpos >= S || (causal && kpos > qpos[i]);
        sacc[n][e] = masked ? kNegInf : sacc[n][e] * scale;
        mx[i] = fmaxf(mx[i], sacc[n][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = expf(sacc[n][e] - m[e >> 1]);
        psum[e >> 1] += sacc[n][e];
      }
    }
    // per-thread partial denominators; the quad's four are summed at the end
    den[0] = den[0] * corr[0] + psum[0];
    den[1] = den[1] * corr[1] + psum[1];
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      oacc[t][0] *= corr[0];
      oacc[t][1] *= corr[0];
      oacc[t][2] *= corr[1];
      oacc[t][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0],
                                        sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2],
                                        sacc[2 * kk + 1][3])};
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        const bf16* vr = &vt[(8 * t + gid) * VLD + 16 * kk + 2 * tig];
        mma_bf16(oacc[t], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const float d = fmaxf(den[i], 1e-30f);
    if (kLse && tig == 0) lse[row[i] / HD] = m[i] + logf(d);
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<uint32_t*>(o + row[i] + 8 * t + 2 * tig) =
          pack_bf16(oacc[t][2 * i] / d, oacc[t][2 * i + 1] / d);
  }
}

float softmax_scale(int hd) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
}

dim3 grid_of(int64_t B, int64_t S, int64_t Kv, int bq) {
  return dim3(static_cast<unsigned>((S + bq - 1) / bq),
              static_cast<unsigned>(Kv), static_cast<unsigned>(B));
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int64_t B, int64_t S, int64_t H, int64_t Kv,
               int causal, cudaStream_t stream) {
  const int G = static_cast<int>(H / Kv);
  const int bq = kRows / G;
  auto* kernel = lse != nullptr ? flash_attention_kernel<HD, true>
                                : flash_attention_kernel<HD, false>;
  kernel<<<grid_of(B, S, Kv, bq), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(Kv), G, bq,
      softmax_scale(HD), causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t B, int64_t S, int64_t H, int64_t Kv,
                int causal, cudaStream_t stream) {
  const int G = static_cast<int>(H / Kv);
  const int bq = kRows / G;
  auto* kernel = lse != nullptr ? flash_attention_mma_kernel<HD, true>
                                : flash_attention_mma_kernel<HD, false>;
  kernel<<<grid_of(B, S, Kv, bq), kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(Kv), G, bq,
      softmax_scale(HD), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Kv, hd); contiguous, 16-byte aligned,
// all of one dtype: 0 = float32, 1 = bfloat16.  lse: (B, S, H) f32, or
// null to skip it.  hd in {64, 128}, H a
// multiple of Kv with H / Kv <= 64.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int64_t B, int64_t S, int64_t H,
                                      int64_t Kv, int64_t hd, int dtype,
                                      int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Kv <= 0 || H % Kv != 0 || H / Kv > kRows || S > INT32_MAX / H)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, o, l, B, S, H, Kv, causal, st);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, o, l, B, S, H, Kv, causal, st);
  if (dtype == 1 && hd == 64)
    return launch_bf16<64>(q, k, v, o, l, B, S, H, Kv, causal, st);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128>(q, k, v, o, l, B, S, H, Kv, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one block uses at head dim `hd` for `dtype` (bytes).
extern "C" int64_t flash_attention_smem_bytes(int64_t hd, int dtype) {
  if (dtype == 1)
    return (kMmaBk * (hd + 8) + hd * (kMmaBk + 8)) *
           static_cast<int64_t>(sizeof(bf16));
  return 2 * kBk * hd * static_cast<int64_t>(sizeof(float));
}
