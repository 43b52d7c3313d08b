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
//   - x bf16, w bf16 or f32: the tensor cores (wgmma, bf16 in, f32
//     accumulate).  An f32 weight is rounded to bf16 once per block
//     (__floats2bfloat162_rn, cvt.rn.bf16x2.f32: bit for bit torch's
//     .to(torch.bfloat16)), so the model's f32 expert weights are read once,
//     with no cast copy;
//   - x f32, w f32: scalar f32 FMAs, exact f32 for the f32 configurations.
//
// Bound on an H100, at the serving shapes (E 16, d 4,096, f 14,336 and back,
// f32 weights): a prefill launch (M = 448 rows an expert) does 224
// multiply-adds per weight byte, under the card's ~295 FLOP a byte, so it
// is bound by the 3.76 GB of f32 weights over 3.35 TB/s (1.12 ms) with the
// bf16 products (0.85 ms at 989 TFLOP/s) close behind; a decode launch
// (M = 4) is bound by the weight bytes alone.
//
// What the design does about it, on the two tensor-core routes:
//   - the products are Hopper's warpgroup MMA (wgmma.mma_async), A (x) and
//     B (the bf16 weights) read from shared memory through descriptors, so
//     no fragment passes through registers; mma.sync reaches only about
//     half the card's bf16 rate, and an mma.sync version of this design
//     measured less than half as fast;
//   - a ring of 32-deep K tiles in dynamic shared memory, copied several
//     tiles ahead of the products by the tensor memory accelerator (TMA:
//     cp.async.bulk.tensor with tensor maps made per launch, one thread
//     issuing, one mbarrier per slot counting the bytes); the products of a
//     tile run asynchronously (two groups in flight) while the next tiles'
//     copies and conversion are issued, and one __syncthreads a K tile
//     orders slot reuse.  TMA zero-fills past M, K and N.  Where a row is
//     not 16-byte aligned (K not a multiple of 8 for x, N not a multiple of
//     16 bytes for w), which tensor maps refuse, every thread copies its
//     share with cp.async.cg 16-byte copies (ragged edges zero-filled by the
//     source-size operand, misaligned chunks gathered element by element),
//     so any M, K and N stay valid.  A cp.async ring for every shape
//     measured a quarter slower at the prefill shapes: its address work and
//     copy traffic through the load/store pipe competed with the products;
//   - shared-memory layouts are the ones wgmma reads without bank
//     conflicts: x K-major with the 64-byte swizzle (32-element rows), the
//     bf16 weights MN-major with the 128-byte swizzle (64-column atoms of
//     8 K rows); the tensor maps' swizzle modes write exactly those;
//   - f32 weights: a cooperative pass turns each landed f32 tile into the
//     swizzled bf16 tile, one conversion per weight and block, one tile
//     ahead of the products (three bf16 tiles rotate: one being written,
//     two read by products in flight).  Taken over converting in every
//     consumer because wgmma reads B from shared memory only, in bf16: the
//     tile has to exist there once anyway, and each weight is then
//     converted once per block, by one thread, from a conflict-free 16-byte
//     read;
//   - M tiling for the path's shapes: M > 64 goes in tiles of 256 rows x
//     128 columns, warpgroup g computing rows [128 g, 128 g + 128) as two
//     m64n128 blocks, so each K step issues four wgmma a warpgroup; 448
//     rows are two tiles, the second 192 rows deep.  Its fourth 64-row
//     block is computed on zero rows all the same (14 % more products at
//     M = 448): skipping it needs a branch on the warpgroup, under which
//     ptxas serialises every wgmma of the kernel (info C7520), and the
//     alternative that skips it (warpgroups splitting the columns, m64n64,
//     each reading all of x) measured no faster.  The M tiles of one weight
//     tile are neighbours in the grid, so the weights come from device
//     memory about once;
//   - M <= 64 (decode) takes the same kernel with a 64-row x tile, the two
//     warpgroups splitting its 128 columns (m64n64), and 8 (f32) or 14
//     (bf16) tiles in flight: ~128 KB of weights per SM, where ~25-30 KB
//     cover device-memory latency at 3.35 TB/s.
// Measured at serve_hybrid's shapes (PERF.md): decode reaches ~90 % of its
// byte bound.  Prefill is held by the tiles' traffic from L2 into the SMs
// (x re-read for each 128-column tile, the weights for each M tile, ~6 TB/s
// together), not by device memory; sharing x between two blocks of a
// cluster by TMA multicast measured slower in this lockstep design (the
// pair waits on each other every K tile), and a warp-specialised pipeline
// is later work.  One block per SM (256 threads, 128 f32 accumulators
// each).  The kernel allocates nothing and does not synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ PTX helpers --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; bytes past src_bytes (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// this thread's shared-memory writes (copies landed, conversions) made
// visible to the tensor cores' asynchronous reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's product groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the accumulators in their registers across asynchronous products
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// mbarriers and the tensor memory accelerator (TMA)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a phase, announcing `bytes` of copies to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one box of a 3-d tensor map at (c0, c1, c2) into shared memory; the
// bytes are counted on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// d (64 x 128, f32, the warpgroup's fragment) += A (64 x 16, K-major, from
// shared memory) * B (16 x 128, MN-major, from shared memory); asynchronous
// until wgmma_wait
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32, the warpgroup's fragment) += A (64 x 16, K-major, from
// shared memory) * B (16 x 64, MN-major, from shared memory); asynchronous
// until wgmma_wait
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int kBytes>
struct BitsOf;
template <>
struct BitsOf<2> { using T = unsigned short; };
template <>
struct BitsOf<4> { using T = unsigned int; };

// The first `valid` elements of src (fewer than 16 bytes' worth, or none)
// into one 16-byte shared-memory chunk, zeros after them: the copy of a
// chunk whose global address is not 16-byte aligned.
template <typename T>
__device__ __forceinline__ void gather16(void* dst, const T* src, int valid) {
  using B = typename BitsOf<sizeof(T)>::T;
  constexpr int kCh = 16 / sizeof(T);
  const B* s = reinterpret_cast<const B*>(src);
  union {
    uint4 v;
    B e[kCh];
  } u;
#pragma unroll
  for (int j = 0; j < kCh; ++j) u.e[j] = j < valid ? s[j] : B(0);
  *reinterpret_cast<uint4*>(dst) = u.v;
}

// ----------------------------------------------- bf16 tensor cores (wgmma) --
constexpr int kThreads = 256;    // two warpgroups
constexpr int kBn = 128;         // output columns per block (one wgmma N)
constexpr int kBk = 32;          // depth per stage (two wgmma K steps)
constexpr int kWideRows = 256;   // rows per block for M > kNarrowRows
constexpr int kNarrowRows = 64;  // decode
constexpr int kTile = kBk * kBn * 2;  // one swizzled bf16 weight tile

// Byte layout of one configuration's dynamic shared memory (after aligning
// its start to 1,024 bytes).  bf16 weights: LOOK + DEPTH stages of (x tile,
// weight tile).  f32 weights: LOOK + DEPTH x tiles, LOOK raw f32 weight
// tiles and DEPTH + 1 converted bf16 tiles.  x: XROWS rows of 64 B, 64-byte
// swizzle; bf16 weight tiles in the swizzled wgmma layout; f32 tiles
// unswizzled (the conversion reads them a row at a time).  Tile t is copied
// LOOK K tiles ahead of its products, and its x and bf16 weights stay until
// the products of DEPTH - 1 later tiles have been issued.
template <typename TW, int XROWS, int LOOK, int DEPTH>
struct Smem {
  static constexpr bool kConvert = std::is_same<TW, float>::value;
  static constexpr int kX = XROWS * kBk * 2;
  static constexpr int kW = kBk * kBn * static_cast<int>(sizeof(TW));
  static constexpr int kSlots = LOOK + DEPTH;
  // bf16: x and weights side by side in one slot; f32: x slots, then raw
  // weight slots, then converted tiles
  static constexpr int kXStride = kConvert ? kX : kX + kW;
  static constexpr int kRaw = kSlots * kXStride;
  static constexpr int kConv = kRaw + (kConvert ? LOOK * kW : 0);
  // one mbarrier per slot, for the TMA copies
  static constexpr int kBars = kConv + (kConvert ? (DEPTH + 1) * kTile : 0);
  static constexpr int kBytes = 1024 + kBars + kSlots * 8;
};

// byte offset of x's 16-byte chunk c (of 4) in row r: 64-byte swizzle
__device__ __forceinline__ int x_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// byte offset of weight (k, n) in a 32 x 128 bf16 tile, MN-major: atoms of
// 64 columns x 8 K rows (1,024 B, 128-byte swizzle), the four K groups of an
// atom column contiguous (stride 1,024 B), the two atom columns 4,096 B apart
__device__ __forceinline__ int w_off(int k, int n) {
  const int rr = k & 7;
  return (((n >> 6) * 4 + (k >> 3)) << 10) + (rr << 7) +
         ((((n >> 3) & 7) ^ rr) << 4) + ((n & 7) << 1);
}

// One thread's share of the copies of every K tile, its addresses worked
// out once: XI 16-byte chunks of x (row r, chunk c; rows past `rows` and
// depth past K zero) and WI chunks of the 32 x 128 weights (depth past K
// and columns past N zero).
template <typename TW, int XROWS>
struct Loader {
  static constexpr bool kConvert = std::is_same<TW, float>::value;
  static constexpr int XI = XROWS * 4 / kThreads;
  static constexpr int kCh = 16 / static_cast<int>(sizeof(TW));
  static constexpr int kPerRow = kBn / kCh;
  static constexpr int WI = kBk * kPerRow / kThreads;
  const bf16* xp[XI];        // row r's chunk c at depth 0
  int xo[XI];                // its shared-memory offset
  int xk[XI];                // its depth offset, 8 c
  bool xrow[XI];             // r < rows
  bool xact[XI];             // r < rowsp: copied at all
  const TW* wp[WI];          // weight row kr, column chunk at depth 0
  int wo[WI];
  int wk[WI];                // kr
  int wn[WI];                // columns of the chunk inside N (may be <= 0)
  const bf16* x0;
  const TW* w0;
  int K, N;
  bool vec_a, vec_b;

  __device__ __forceinline__ Loader(const bf16* x, const TW* w, int rows,
                                    int rowsp, int K_, int N_, int n0)
      : x0(x), w0(w), K(K_), N(N_) {
    vec_a = K % 8 == 0;
    vec_b = N % kCh == 0;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c >> 2;
      xk[i] = (c & 3) * 8;
      xp[i] = x + static_cast<int64_t>(r) * K + xk[i];
      xo[i] = x_off(r, c & 3);
      xrow[i] = r < rows;
      xact[i] = r < rowsp;
    }
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int kr = c / kPerRow;
      const int nc = (c % kPerRow) * kCh;
      wk[i] = kr;
      wn[i] = N - (n0 + nc);
      wp[i] = w + static_cast<int64_t>(kr) * N + n0 + nc;
      wo[i] = kConvert ? (kr * kBn + nc) * 4 : w_off(kr, nc);
    }
  }

  // copies K tile [k0, k0 + 32) into x slot xs and weight slot ws
  __device__ __forceinline__ void load(unsigned char* xs, unsigned char* ws,
                                       int k0) const {
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      if (!xact[i]) continue;
      const int kc = k0 + xk[i];
      if (vec_a) {
        const bool ok = xrow[i] && kc < K;
        cp_async16(xs + xo[i], ok ? xp[i] + k0 : x0, ok ? 16 : 0);
      } else {
        gather16(xs + xo[i], xp[i] + k0, xrow[i] ? K - kc : 0);
      }
    }
    const int64_t koff = static_cast<int64_t>(k0) * N;
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const bool in_k = k0 + wk[i] < K;
      if (vec_b) {
        const bool ok = in_k && wn[i] > 0;
        cp_async16(ws + wo[i], ok ? wp[i] + koff : w0, ok ? 16 : 0);
      } else {
        gather16(ws + wo[i], wp[i] + koff, in_k ? wn[i] : 0);
      }
    }
  }
};

// f32 weight tile (32 x 128, unswizzled) -> swizzled bf16 tile: each warp
// converts whole rows (512 B read, 256 B written, no bank conflicts).
__device__ __forceinline__ void convert_tile(const unsigned char* ws,
                                             unsigned char* tile) {
#pragma unroll
  for (int i = 0; i < kBk * kBn / 4 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int kr = c / (kBn / 4);
    const int nc = (c % (kBn / 4)) * 4;
    const float4 v =
        *reinterpret_cast<const float4*>(ws + (kr * kBn + nc) * 4);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(tile + w_off(kr, nc)) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// grid: (M tiles of XROWS rows, N / 128, E); M tiles of one weight tile are
// adjacent.  Dynamic shared memory: Smem<...>::kBytes.  256-row tiles:
// warpgroup g computes rows [128 g, 128 g + 128) as two 64-row blocks, each
// one wgmma m64n128k16 a K step; every block is computed, also one past the
// tile's rows (its products are not stored), because a wgmma under a
// thread-dependent branch makes ptxas serialise every wgmma of the kernel.
// 64-row tiles (decode): warpgroup g computes columns [64 g, 64 g + 64) of
// the one block (m64n64k16).  TMA: the K tiles come by tensor
// maps tx (x: K, M, E; box 32 x XROWS, 64-byte swizzle) and tw (w: N, K, E;
// box 128 x 32 for f32, two 64 x 32 boxes with the 128-byte swizzle for
// bf16), issued by thread 0 and counted on one mbarrier per slot; without
// TMA (rows not 16-byte aligned) every thread copies its share with
// cp.async.
template <typename TW, int XROWS, int LOOK, int DEPTH, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_wgmma_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                     bf16* __restrict__ out, int M, int K, int N,
                     const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw) {
  using L = Smem<TW, XROWS, LOOK, DEPTH>;
  static_assert(XROWS == 256 || XROWS == 64, "row or column split");
  constexpr bool kRowSplit = XROWS == 256;
  constexpr int kCols = kRowSplit ? 128 : 64;   // a warpgroup's columns
  constexpr int kAcc = 2 * kCols;               // 256 or 64 rows x kCols
  static_assert(LOOK >= 2 && DEPTH >= 1, "f32: tile t + 1 converted at t");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * XROWS;
  const int n0 = blockIdx.y * kBn;
  const int rows = min(XROWS, M - m0);
  // cp.async fills every row of the tile (zeros past M), as TMA does
  const int rowsp = XROWS;
  x += (static_cast<int64_t>(e) * M + m0) * K;
  w += static_cast<int64_t>(e) * K * N;
  out += (static_cast<int64_t>(e) * M + m0) * N;
  const Loader<TW, XROWS> ld(x, w, rows, rowsp, K, N, n0);

  const int wg = threadIdx.x / 128;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  auto xslot = [&](int t) { return smem + (t % L::kSlots) * L::kXStride; };
  auto wslot = [&](int t) {
    return L::kConvert ? smem + L::kRaw + (t % LOOK) * L::kW
                       : smem + (t % L::kSlots) * L::kXStride + L::kX;
  };
  auto conv = [&](int t) {
    return smem + L::kConv + (t % (DEPTH + 1)) * kTile;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  const int nk = (K + kBk - 1) / kBk;
  constexpr uint32_t tx_bytes = L::kX + L::kW;
  // tile t's copies into its slots: TMA from thread 0, else every thread's
  // share by cp.async (one commit group a tile, empty past nk)
  auto load = [&](int t) {
    if (TMA) {
      if (t < nk && threadIdx.x == 0) {
        uint64_t* bar = &bars[t % L::kSlots];
        mbar_expect(bar, tx_bytes);
        tma_load(xslot(t), &tx, bar, t * kBk, m0, e);
        tma_load(wslot(t), &tw, bar, n0, t * kBk, e);
        if (!L::kConvert)
          tma_load(wslot(t) + 4096, &tw, bar, n0 + 64, t * kBk, e);
      }
    } else {
      if (t < nk) ld.load(xslot(t), wslot(t), t * kBk);
      cp_async_commit();
    }
  };
  // wait for tile t (TMA: its slot's mbarrier phase; cp.async: all but the
  // PENDING copy groups committed after it)
  auto landed = [&](int t, auto pending) {
    if (TMA) {
      if (t < nk) mbar_wait(&bars[t % L::kSlots], (t / L::kSlots) & 1);
    } else {
      cp_async_wait<decltype(pending)::value>();
    }
  };
  if (TMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < L::kSlots; ++i) mbar_init(&bars[i]);
      mbar_init_fence();
    }
    __syncthreads();
  }

  // prologue: tiles 0 .. LOOK - 1 in flight
#pragma unroll 1
  for (int t = 0; t < LOOK; ++t) load(t);
  if (L::kConvert) {
    landed(0, std::integral_constant<int, LOOK - 1>{});
    __syncthreads();
    if (nk > 0) convert_tile(wslot(0), conv(0));
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    // the products of kt - DEPTH done, so its x slot and bf16 tile may be
    // refilled; f32: tile kt + 1 landed (converted below), tile kt's raw
    // slot already converted; bf16: tile kt landed
    wgmma_wait<DEPTH - 1>();
    if (L::kConvert)
      landed(kt + 1, std::integral_constant<int, LOOK - 2>{});
    else
      landed(kt, std::integral_constant<int, LOOK - 1>{});
    // (also orders this thread's generic reads of a slot before the TMA
    // that refills it)
    fence_proxy_async();
    __syncthreads();

    const unsigned char* xs = xslot(kt);
    const unsigned char* wt = L::kConvert ? conv(kt) : wslot(kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      if constexpr (kRowSplit) {
        const uint64_t b = smem_desc(wt + kk * 2048, 4096, 1024, 1);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wgmma_m64n128k16(
              acc + 64 * j,
              smem_desc(xs + (2 * wg + j) * 4096 + kk * 32, 16, 512, 2), b);
      } else {
        wgmma_m64n64k16(acc,
                        smem_desc(xs + kk * 32, 16, 512, 2),
                        smem_desc(wt + wg * 4096 + kk * 2048, 4096, 1024, 1));
      }
    }
    wgmma_commit();
    pin<kAcc>(acc);

    load(kt + LOOK);
    if (L::kConvert && kt + 1 < nk) convert_tile(wslot(kt + 1), conv(kt + 1));
  }
  wgmma_wait<0>();
  pin<kAcc>(acc);
  cp_async_wait<0>();

  // the wgmma accumulator layout: warp q of the warpgroup holds rows
  // 16 q + lane / 4 (+ 8) of each 64-row block, register 4 c + i column
  // 8 c + 2 (lane % 4) (+ 1)
  const int lane = threadIdx.x % 32;
  const int q = (threadIdx.x % 128) / 32;
  const bool vec_o = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < (kRowSplit ? 2 : 1); ++j) {
    const int row0 = (kRowSplit ? 64 * (2 * wg + j) : 0) + 16 * q + lane / 4;
#pragma unroll
    for (int c = 0; c < kCols / 8; ++c) {
      const int col = n0 + (kRowSplit ? 0 : 64 * wg) + 8 * c + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= rows) continue;
        const float v0 = acc[kCols / 2 * j + 4 * c + 2 * half];
        const float v1 = acc[kCols / 2 * j + 4 * c + 2 * half + 1];
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

// A 3-d tensor map of a contiguous (d2, d1, d0) tensor with a d0 x d1 box;
// false where cuTensorMapEncodeTiled refuses it.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* base, int64_t d0, int64_t d1, int64_t d2,
                int b0, int b1, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * elem),
                                 static_cast<cuuint64_t>(d0 * d1 * elem)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, type, 3, const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TW, int XROWS, int LOOK, int DEPTH, bool TMA>
int launch_mma(const void* x, const void* w, void* out, int64_t E, int64_t M,
               int64_t K, int64_t N, cudaStream_t st) {
  constexpr int kBytes = Smem<TW, XROWS, LOOK, DEPTH>::kBytes;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
  auto* kernel = moe_gmm_wgmma_kernel<TW, XROWS, LOOK, DEPTH, TMA>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();              // the error is returned, not left set
    return static_cast<int>(err);
  }
  CUtensorMap tx{}, tw{};
  if (TMA) {
    const bool f32 = std::is_same<TW, float>::value;
    if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, E,
                    kBk, XROWS, CU_TENSOR_MAP_SWIZZLE_64B) ||
        !tensor_map(&tw,
                    f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    f32 ? 4 : 2, w, N, K, E, f32 ? kBn : kBn / 2, kBk,
                    f32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                        : CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid_of(E, M, N, XROWS, kBn), kThreads, kBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const TW*>(w),
      static_cast<bf16*>(out), static_cast<int>(M), static_cast<int>(K),
      static_cast<int>(N), tx, tw);
  return static_cast<int>(cudaGetLastError());
}

// the configuration a route takes at M rows: rows a block, tiles copied
// ahead (LOOK), product groups in flight (DEPTH)
//   - two product groups in flight (a third measured no faster);
//   - f32 weights: 4 tiles ahead at M > 64, 8 at decode, where only the
//     weights' bytes count (184 and 193 KB of shared memory);
//   - bf16 weights: 6 and 14 tiles ahead (both 193 KB).
template <typename TW>
struct Config {
  static constexpr bool kF32 = std::is_same<TW, float>::value;
  static constexpr int kD = 2;
  static constexpr int kWide = kF32 ? 4 : 6;
  static constexpr int kNarrow = kF32 ? 8 : 14;
  // TMA where every row of x and w starts 16-byte aligned (the tensor
  // maps' strides must be multiples of 16 bytes), cp.async otherwise
  template <bool TMA>
  static int run(const void* x, const void* w, void* out, int64_t E,
                 int64_t M, int64_t K, int64_t N, cudaStream_t st) {
    if (M <= kNarrowRows)
      return launch_mma<TW, kNarrowRows, kNarrow, kD, TMA>(x, w, out, E, M,
                                                           K, N, st);
    return launch_mma<TW, kWideRows, kWide, kD, TMA>(x, w, out, E, M, K, N,
                                                     st);
  }
  static int launch(const void* x, const void* w, void* out, int64_t E,
                    int64_t M, int64_t K, int64_t N, cudaStream_t st) {
    const bool aligned = K > 0 && K % 8 == 0 && N % (kF32 ? 4 : 8) == 0;
    return aligned ? run<true>(x, w, out, E, M, K, N, st)
                   : run<false>(x, w, out, E, M, K, N, st);
  }
  static int64_t smem(int64_t M) {
    return M <= kNarrowRows ? Smem<TW, kNarrowRows, kNarrow, kD>::kBytes
                            : Smem<TW, kWideRows, kWide, kD>::kBytes;
  }
};

}  // namespace

// x: (E, M, K), w: (E, K, N), out: (E, M, N); contiguous, 16-byte aligned.
// Dtype codes: 0 = float32, 1 = bfloat16; routes (x, w) = (1, 1), (1, 0)
// and (0, 0); out has x's dtype.  Launches on `stream`; returns the error of
// the shared-memory attribute call or cudaGetLastError() after the launch
// (cudaErrorInvalidValue for what it does not take).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              int64_t E, int64_t M, int64_t K, int64_t N,
                              int x_dtype, int w_dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (K < 0 || E > 65535 || M > INT32_MAX || K > INT32_MAX || N > INT32_MAX ||
      (N + kFBn - 1) / kFBn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1)
    return Config<bf16>::launch(x, w, out, E, M, K, N, st);
  if (x_dtype == 1 && w_dtype == 0)
    return Config<float>::launch(x, w, out, E, M, K, N, st);
  if (x_dtype == 0 && w_dtype == 0) {
    moe_gmm_f32_kernel<<<grid_of(E, M, N, kFBm, kFBn), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), static_cast<int>(M), static_cast<int>(K),
        static_cast<int>(N));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory (bytes) one block of the route (x_dtype, w_dtype) uses at
// M rows an expert: the dynamic ring of the tensor-core routes (with its
// 1,024 bytes of alignment slack), the static tiles of the f32 route; -1
// for a pair that is not a route.
extern "C" int64_t moe_gmm_smem_bytes(int x_dtype, int w_dtype, int64_t M) {
  if (x_dtype == 1 && w_dtype == 1) return Config<bf16>::smem(M);
  if (x_dtype == 1 && w_dtype == 0) return Config<float>::smem(M);
  if (x_dtype == 0 && w_dtype == 0)
    return (kFBk * (kFBm + 1) + kFBk * kFBn) *
           static_cast<int64_t>(sizeof(float));
  return -1;
}
