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
// heads of that group, G rows per query position.  The K and V tiles of
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
// without that write, so serving runs a body without the epilogue.  Two
// bodies:
//   - bf16 (the serving and training dtype): the products on the tensor
//     cores (mma.sync m16n8k16, bf16 in, f32 accumulate), 128 (query, head)
//     rows a block; see its section below;
//   - f32: scalar f32 FMAs, 64 rows a block (4 threads per row, hd / 4 dims
//     each), exact f32 math for the f32 configurations and the tests' 2e-5
//     tolerance.
//
// Bound on an H100: at the serving and training shapes (S in the hundreds
// to thousands, hd 128 or 160) attention does ~S/2 multiply-adds per byte
// it must move, far above the card's balance, so it is bound by arithmetic:
// the tensor cores' 989 TFLOP/s (bf16 dense).  What the design does about it:
// every K/V element is read from device memory once per block for G heads
// at once; kv tiles wholly above the diagonal are skipped; the longest
// causal rows are scheduled first across the whole grid; the bf16 body
// keeps the next kv tiles' asynchronous copies in flight while the current
// one is multiplied, and feeds the tensor cores through ldmatrix.  mma.sync
// reaches only part of Hopper's tensor-core rate; wgmma, TMA and a
// warp-specialised pipeline are later work.  The kernel allocates nothing
// and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                  // (query, head) rows per block
constexpr int kMaxGroup = 64;              // largest H / Kv taken
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
// The same decomposition with the products on the tensor cores: mma.sync
// m16n8k16, bf16 inputs, f32 accumulation.  Eight warps of 16 rows each,
// 128 (query, head) rows a block, so each K/V byte staged serves 128 rows.
//   - Q, K and V tiles are copied by cp.async.cg, consecutive threads taking
//     consecutive 16-byte chunks of one row (coalesced), into dynamic shared
//     memory: Q once, K and V through a ring of kFaStages kv tiles of 64
//     keys (two: a third measured no faster), so the copies of the next
//     tile are in flight while the current one is multiplied; one
//     __syncthreads a kv tile.  Keys past S and rows
//     past the block's queries are zero-filled by the copy's source size.
//   - Rows are padded to hd + 8 elements (2 hd + 16 bytes, an odd number of
//     16-byte units at hd 64, 128 and 160), so the eight rows an ldmatrix
//     phase reads fall on distinct banks.  Q fragments come from ldmatrix
//     once, into registers; K fragments from ldmatrix (K's rows are the
//     product's columns); V stays row-major and the PV fragments come from
//     ldmatrix.trans: no transpose in shared memory.
//   - The softmax runs in base 2: the scores are scaled by scale * log2 e
//     and exponentiated with exp2f; the running max and denominator are
//     f32, and the LSE is written in natural log, m ln 2 + log(max(den,
//     1e-30)).  The probabilities are rounded to bf16 for the PV product,
//     as the JAX model's XLA fallback does (p.astype(v.dtype)).
// At hd 128 a thread holds 32 Q-fragment, 64 output and 32 score registers,
// at hd 160 40, 80 and 32, so one block of 256 threads fits an SM (both
// instantiations of each; the three-block limit of the 64-row design no
// longer applies); at hd 64 two blocks fit.  Shared memory a block at hd
// 160: Q 128 x 168 x 2 + 2 stages x (K, V) x 64 x 168 x 2 = 129,024 B.
constexpr int kFaThreads = 256;            // 8 warps x 16 rows
constexpr int kFaRows = 128;               // (query, head) rows per block
constexpr int kFaBk = 64;                  // keys per kv tile
constexpr int kFaStages = 2;               // kv tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Byte layout of the dynamic shared memory: Q (128 rows), then kFaStages
// x (K tile, V tile) of 64 rows, every row hd + 8 elements.
template <int HD>
struct FaSmem {
  static constexpr int kLd = HD + 8;
  static constexpr int kQ = kFaRows * kLd * 2;
  static constexpr int kKV = kFaBk * kLd * 2;
  static constexpr int kBytes = kQ + kFaStages * 2 * kKV;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; bytes past src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// Copies kv tile [k0, k0 + 64) of (batch, kv head) into K and V stages;
// keys at or past S are zeros.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        int64_t kv_base, int64_t kv_stride,
                                        int k0, int S) {
  constexpr int kCh = HD / 8;              // 16-byte chunks a row
  constexpr int kLd = FaSmem<HD>::kLd;
#pragma unroll
  for (int i = 0; i < kFaBk * kCh / kFaThreads; ++i) {
    const int c = threadIdx.x + i * kFaThreads;
    const int j = c / kCh;
    const int col = (c % kCh) * 8;
    const bool ok = k0 + j < S;
    const int64_t at = ok ? kv_base + (k0 + j) * kv_stride + col : 0;
    cp_async16(ks + j * kLd + col, k + at, ok ? 16 : 0);
    cp_async16(vs + j * kLd + col, v + at, ok ? 16 : 0);
  }
}

// grid: one block per (query tile, kv head, batch), flattened with the
// query tile slowest and taken longest rows first.  Dynamic shared memory:
// FaSmem<HD>::kBytes.
template <int HD, bool kLse>
__global__ void __launch_bounds__(kFaThreads, HD >= 128 ? 1 : 2)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int Kv,
                           int B, int G, int bq, float scale_log2,
                           int causal) {
  using L = FaSmem<HD>;
  constexpr int kLd = L::kLd;
  constexpr int KS = HD / 16;              // k-steps over the head dim
  constexpr int NT = kFaBk / 8;            // key n-tiles per kv tile
  constexpr int OT = HD / 8;               // output n-tiles
  constexpr int kCh = HD / 8;              // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto kst = [&](int t) {
    return reinterpret_cast<bf16*>(smem + L::kQ +
                                   (t % kFaStages) * 2 * L::kKV);
  };
  auto vst = [&](int t) {
    return reinterpret_cast<bf16*>(smem + L::kQ +
                                   (t % kFaStages) * 2 * L::kKV + L::kKV);
  };

  const int groups = Kv * B;
  const int qt = (gridDim.x - 1 - blockIdx.x) / groups;  // longest first
  const int kvh = blockIdx.x % Kv;
  const int b = (blockIdx.x / Kv) % B;
  const int q0 = qt * bq;
  const int nrows = G * min(bq, S - q0);   // rows r < nrows are live
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;                // fragment row group
  const int tig = lane % 4;                // thread in group

  const int q_last = min(S, q0 + bq) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int nkt = (k_end + kFaBk - 1) / kFaBk;
  const int64_t kv_stride = static_cast<int64_t>(Kv) * HD;
  const int64_t kv_base = (static_cast<int64_t>(b) * S * Kv + kvh) * HD;
  // row r: query q0 + r / G, head kvh * G + r % G; the G rows of one query
  // are contiguous in q and o
  const int64_t q_base =
      ((static_cast<int64_t>(b) * S + q0) * H + static_cast<int64_t>(kvh) * G)
      * HD;
  auto row_at = [&](int r) {
    return q_base + (static_cast<int64_t>(r / G) * H + r % G) * HD;
  };

  // group 0: Q and kv tile 0; then tiles 1 .. kFaStages - 2
#pragma unroll
  for (int i = 0; i < kFaRows * kCh / kFaThreads; ++i) {
    const int c = threadIdx.x + i * kFaThreads;
    const int r = c / kCh;
    const int col = (c % kCh) * 8;
    const bool ok = r < nrows;
    cp_async16(qs + r * kLd + col, q + (ok ? row_at(r) + col : 0),
               ok ? 16 : 0);
  }
#pragma unroll 1
  for (int t = 0; t < kFaStages - 1; ++t) {
    if (t < nkt)
      load_kv<HD>(kst(t), vst(t), k, v, kv_base, kv_stride, t * kFaBk, S);
    cp_async_commit();
  }
  cp_async_wait<kFaStages - 2>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], qs + (16 * warp + (lane & 15)) * kLd + 16 * kk +
                            (lane >> 4) * 8);

  // this thread's two rows: gid and gid + 8 of the warp's 16
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (16 * warp + gid + 8 * i) / G;
  float oacc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
    oacc[t][0] = oacc[t][1] = oacc[t][2] = oacc[t][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, den[2] = {0.f, 0.f};

#pragma unroll 1
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kFaStages - 2>();        // tile t landed
    // every thread's copies visible; the products of t - 1 done, so its
    // stage may be refilled
    __syncthreads();
    const int next = t + kFaStages - 1;
    if (next < nkt)
      load_kv<HD>(kst(next), vst(next), k, v, kv_base, kv_stride,
                  next * kFaBk, S);
    cp_async_commit();

    const bf16* kt = kst(t);
    const bf16* vt = vst(t);
    const int k0 = t * kFaBk;
    // S = Q K^T: one ldmatrix.x4 gives an n-tile's B fragments for two
    // k-steps
    float sacc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (8 * n + (lane & 7)) * kLd + 16 * kk +
                           (lane >> 3) * 8);
        mma_bf16(sacc[n], qf[kk], r[0], r[1]);
        mma_bf16(sacc[n], qf[kk + 1], r[2], r[3]);
      }
    }
    const bool edge = k0 + kFaBk > S || (causal && k0 + kFaBk - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + 8 * n + 2 * tig + (e & 1);
        const bool masked =
            edge && (kpos >= S || (causal && kpos > qpos[i]));
        sacc[n][e] = masked ? kNegInf : sacc[n][e] * scale_log2;
        mx[i] = fmaxf(mx[i], sacc[n][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = exp2f(sacc[n][e] - m[e >> 1]);
        psum[e >> 1] += sacc[n][e];
      }
    }
    // per-thread partial denominators; the quad's four are summed at the end
    den[0] = den[0] * corr[0] + psum[0];
    den[1] = den[1] * corr[1] + psum[1];
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      oacc[j][0] *= corr[0];
      oacc[j][1] *= corr[0];
      oacc[j][2] *= corr[1];
      oacc[j][3] *= corr[1];
    }
    // O += P V: V row-major, B fragments of two output n-tiles from one
    // ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0],
                                        sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2],
                                        sacc[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < OT / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (16 * kk + (lane & 15)) * kLd + 16 * j +
                                 (lane >> 4) * 8);
        mma_bf16(oacc[2 * j], pa, r[0], r[1]);
        mma_bf16(oacc[2 * j + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gid + 8 * i;
    if (r >= nrows) continue;
    const int64_t row = row_at(r);
    const float d = fmaxf(den[i], 1e-30f);
    if (kLse && tig == 0) lse[row / HD] = m[i] * kLn2 + logf(d);
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(o + row + 8 * j + 2 * tig) =
          pack_bf16(oacc[j][2 * i] / d, oacc[j][2 * i + 1] / d);
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
  const int bq = kFaRows / G;
  const int64_t blocks = (S + bq - 1) / bq * Kv * B;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = lse != nullptr ? flash_attention_mma_kernel<HD, true>
                                : flash_attention_mma_kernel<HD, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FaSmem<HD>::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();              // the error is returned, not left set
    return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kFaThreads, FaSmem<HD>::kBytes,
           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(Kv),
      static_cast<int>(B), G, bq, softmax_scale(HD) * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Kv, hd); contiguous, 16-byte aligned,
// all of one dtype: 0 = float32, 1 = bfloat16.  lse: (B, S, H) f32, or
// null to skip it.  hd in {64, 128, 160}, H a multiple of Kv with H / Kv
// <= 64.  Launches on `stream`; returns the error of the shared-memory
// attribute call or cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int64_t B, int64_t S, int64_t H,
                                      int64_t Kv, int64_t hd, int dtype,
                                      int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Kv <= 0 || H % Kv != 0 || H / Kv > kMaxGroup || S > INT32_MAX / H ||
      B > INT32_MAX)
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
  if (dtype == 0 && hd == 160)
    return launch_f32<160>(q, k, v, o, l, B, S, H, Kv, causal, st);
  if (dtype == 1 && hd == 160)
    return launch_bf16<160>(q, k, v, o, l, B, S, H, Kv, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory one block uses at head dim `hd` for `dtype` (bytes): the
// dynamic Q tile and kv ring of the bf16 body, the static K and V tiles of
// the f32 body; -1 for a head dim the kernel is not instantiated for.
extern "C" int64_t flash_attention_smem_bytes(int64_t hd, int dtype) {
  if (hd != 64 && hd != 128 && hd != 160) return -1;
  if (dtype == 1)
    return hd == 64 ? FaSmem<64>::kBytes
                    : hd == 128 ? FaSmem<128>::kBytes : FaSmem<160>::kBytes;
  return 2 * kBk * hd * static_cast<int64_t>(sizeof(float));
}
