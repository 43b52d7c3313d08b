// Grouped matmul for the MoE expert FFNs: out[e] = x[e] @ w[e].
//
// Replaces the JAX package's Pallas kernel kernels/moe_gmm/kernel.py::
// moe_gmm (body _gmm_kernel).  x (E, M, K) and w (E, K, N) are contiguous
// row-major; out (E, M, N) is written in x's dtype from f32 sums.  M, K and
// N are any sizes: rows past M, columns past N and the depth past K are
// masked here, so the model's (E, G * C, d) capacity rows go in as they are
// (the TPU kernel asserts block multiples).  The TPU grid's sequential
// contraction dimension becomes a loop over K tiles inside the block, with
// the f32 accumulator in registers instead of VMEM scratch.  Routes:
//   - x bf16, w bf16 or f32: the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate).  An f32 weight is rounded to bf16 as it is loaded
//     (__float2bfloat16_rn, bit for bit torch's .to(torch.bfloat16)), so the
//     model's f32 expert weights are read once, with no cast copy;
//   - x f32, w f32: scalar f32 FMAs, exact f32 for the f32 configurations.
//
// Bound on an H100: a prefill launch (M in the hundreds, K and N in the
// thousands) does ~M / 3 multiply-adds per weight byte, far above the
// card's balance, so it is bound by the tensor cores' bf16 rate
// (989 TFLOP/s dense); a decode launch (M = batch x capacity, a few rows)
// is bound by the weight bytes over 3.35 TB/s.  What the design does about
// it: one block owns a 128 x 128 output tile of one expert; K tiles of 32
// are staged in shared memory (double buffered, the next tile's global
// loads in flight during the current tile's products), rows k-contiguous
// with 8 elements of padding so every fragment is one conflict-free 32-bit
// load; the M tiles of one weight tile are neighbours in the grid, so the
// weight tile is read from device memory about once and served from L2 to
// the rest; warps whose 16-row slices lie past M skip their products, so a
// decode launch costs its weight bytes and little else.  mma.sync reaches
// only part of the Hopper tensor-core rate; wgmma with TMA and a
// warp-specialised pipeline is later work.  Shared memory stays under the
// 48 KB static limit.  The kernel allocates nothing and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// --------------------------------------------------- bf16 tensor cores ----
constexpr int kThreads = 256;          // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBm = 128;               // output rows per block
constexpr int kBn = 128;               // output columns per block
constexpr int kBk = 32;                // depth per shared-memory tile
constexpr int kLd = kBk + 8;           // tile row stride (elements)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

// Four consecutive weights of one row as loaded from device memory (kept
// raw in registers while the current tile's products run), and element j
// of them rounded to bf16.
template <typename TW>
struct W4;

template <>
struct W4<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p, int valid,
                                             bool vec) {
    if (vec && valid >= 4) return *reinterpret_cast<const float4*>(p);
    Raw r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid > 0) r.x = p[0];
    if (valid > 1) r.y = p[1];
    if (valid > 2) r.z = p[2];
    if (valid > 3) r.w = p[3];
    return r;
  }
  static __device__ __forceinline__ bf16 get(const Raw& r, int j) {
    return __float2bfloat16_rn(j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z
                                                                    : r.w);
  }
};

template <>
struct W4<bf16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const bf16* p, int valid,
                                             bool vec) {
    if (vec && valid >= 4) return *reinterpret_cast<const uint2*>(p);
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) e[j] = q[j];
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  static __device__ __forceinline__ bf16 get(const Raw& r, int j) {
    const uint32_t word = j < 2 ? r.x : r.y;
    return __ushort_as_bfloat16(
        static_cast<unsigned short>((j & 1) ? word >> 16 : word & 0xffffu));
  }
};

// The registers one thread carries from a tile's global loads to its
// shared-memory stores: two 8-element chunks of x, and for two (k pair,
// 4 columns) units of w the two rows k and k + 1.
template <typename TW>
struct Staged {
  uint4 a[2];
  typename W4<TW>::Raw lo[2], hi[2];
};

template <typename TW>
__device__ __forceinline__ void load_tile(Staged<TW>& st, const bf16* x,
                                          const TW* w, int M, int K, int N,
                                          int m0, int n0, int k0, bool vec_a,
                                          bool vec_b) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;     // 512 chunks of 8
    const int gm = m0 + (c >> 2);
    const int gk = k0 + (c & 3) * 8;
    const bf16* p = x + static_cast<int64_t>(gm) * K + gk;
    if (gm < M && vec_a && gk + 8 <= K) {
      st.a[i] = *reinterpret_cast<const uint4*>(p);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (gm < M && gk + j < K) ? q[j] : 0u;
      st.a[i] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                           e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = threadIdx.x + i * kThreads;     // 16 k pairs x 32 groups
    const int k = k0 + 2 * (u & 15);
    const int n = n0 + 4 * (u >> 4);
    const int valid = N - n;
    const TW* p = w + static_cast<int64_t>(k) * N + n;
    st.lo[i] = W4<TW>::load(p, k < K ? valid : 0, vec_b);
    st.hi[i] = W4<TW>::load(p + N, k + 1 < K ? valid : 0, vec_b);
  }
}

// x chunks go to as[row][k]; w pairs (w[k][n], w[k + 1][n]) go to
// bs[n][k] as one 32-bit word, so the B fragments are k-contiguous like
// the A fragments.
template <typename TW>
__device__ __forceinline__ void store_tile(const Staged<TW>& st, bf16* as,
                                           bf16* bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(&as[(c >> 2) * kLd + (c & 3) * 8]) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int kp = u & 15;
    const int n = 4 * (u >> 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(&bs[(n + j) * kLd + 2 * kp]) =
          pack2(W4<TW>::get(st.lo[i], j), W4<TW>::get(st.hi[i], j));
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
moe_gmm_mma_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                   bf16* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) bf16 as[2][kBm * kLd];
  __shared__ __align__(16) bf16 bs[2][kBn * kLd];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBm;   // M tiles of one weight tile adjacent
  const int n0 = blockIdx.y * kBn;
  x += static_cast<int64_t>(e) * M * K;
  w += static_cast<int64_t>(e) * K * N;
  out += static_cast<int64_t>(e) * M * N;
  const bool vec_a = K % 8 == 0;
  const bool vec_b = N % 4 == 0;

  const int warp = threadIdx.x / 32;
  const int gid = (threadIdx.x % 32) / 4;     // fragment row group
  const int tig = threadIdx.x % 4;            // thread in group
  const int wm = (warp / 4) * 64;             // warp's rows in the tile
  const int wn = (warp % 4) * 32;             // warp's columns in the tile
  bool live[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) live[mt] = m0 + wm + 16 * mt < M;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int nk = (K + kBk - 1) / kBk;
  Staged<TW> st;
  if (nk > 0) {
    load_tile(st, x, w, M, K, N, m0, n0, 0, vec_a, vec_b);
    store_tile(st, as[0], bs[0]);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk)
      load_tile(st, x, w, M, K, N, m0, n0, (kt + 1) * kBk, vec_a, vec_b);
    const bf16* at = as[cur];
    const bf16* bt = bs[cur];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const int c = 16 * kk + 2 * tig;
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* br = &bt[(wn + 8 * nt + gid) * kLd + c];
        b[nt][0] = ld32(br);
        b[nt][1] = ld32(br + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (!live[mt]) continue;
        const bf16* ar = &at[(wm + 16 * mt + gid) * kLd + c];
        const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kLd), ld32(ar + 8),
                               ld32(ar + 8 * kLd + 8)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    if (kt + 1 < nk) store_tile(st, as[cur ^ 1], bs[cur ^ 1]);
    __syncthreads();
  }

  const bool vec_o = N % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (!live[mt]) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * mt + gid + 8 * half;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        bf16* o = out + static_cast<int64_t>(row) * N + col;
        if (vec_o && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) o[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------ f32 scalar FMAs ----
constexpr int kFBm = 64;
constexpr int kFBn = 64;
constexpr int kFBk = 16;

__global__ void __launch_bounds__(kThreads)
moe_gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ float as[kFBk][kFBm + 1];     // transposed: as[k][m]
  __shared__ float bs[kFBk][kFBn];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kFBm;
  const int n0 = blockIdx.y * kFBn;
  x += static_cast<int64_t>(e) * M * K;
  w += static_cast<int64_t>(e) * K * N;
  out += static_cast<int64_t>(e) * M * N;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // this thread's outputs: rows ty + 16 i, columns tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int m = c / kFBk, k = c % kFBk;
      as[k][m] = (m0 + m < M && k0 + k < K)
                     ? x[static_cast<int64_t>(m0 + m) * K + k0 + k]
                     : 0.f;
      const int kb = c / kFBn, n = c % kFBn;
      bs[kb][n] = (k0 + kb < K && n0 + n < N)
                      ? w[static_cast<int64_t>(k0 + kb) * N + n0 + n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBk; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[static_cast<int64_t>(row) * N + col] = acc[i][j];
    }
  }
}

dim3 grid_of(int64_t E, int64_t M, int64_t N, int bm, int bn) {
  return dim3(static_cast<unsigned>((M + bm - 1) / bm),
              static_cast<unsigned>((N + bn - 1) / bn),
              static_cast<unsigned>(E));
}

}  // namespace

// x: (E, M, K), w: (E, K, N), out: (E, M, N); contiguous, 16-byte aligned.
// Dtype codes: 0 = float32, 1 = bfloat16; routes (x, w) = (1, 1), (1, 0)
// and (0, 0); out has x's dtype.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int64_t E, int64_t M, int64_t K, int64_t N,
                              int x_dtype, int w_dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (K < 0 || E > 65535 || M > INT32_MAX || K > INT32_MAX || N > INT32_MAX ||
      (N + kFBn - 1) / kFBn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(M), k = static_cast<int>(K),
            n = static_cast<int>(N);
  if (x_dtype == 1 && w_dtype == 1) {
    moe_gmm_mma_kernel<bf16><<<grid_of(E, M, N, kBm, kBn), kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(out), m, k, n);
  } else if (x_dtype == 1 && w_dtype == 0) {
    moe_gmm_mma_kernel<float><<<grid_of(E, M, N, kBm, kBn), kThreads, 0,
                                 st>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(w),
        static_cast<bf16*>(out), m, k, n);
  } else if (x_dtype == 0 && w_dtype == 0) {
    moe_gmm_f32_kernel<<<grid_of(E, M, N, kFBm, kFBn), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), m, k, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block uses on the tensor-core route (bytes).
extern "C" int64_t moe_gmm_smem_bytes() {
  return 2 * (kBm + kBn) * kLd * static_cast<int64_t>(sizeof(bf16));
}
