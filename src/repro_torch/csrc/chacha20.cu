// Stand-alone ChaCha20 XOR (RFC 8439) over (N, 16) u32 blocks.
//
// Replaces the JAX package's Pallas kernel
// kernels/chacha20/kernel.py::chacha20_xor (body _chacha_kernel).
//
// One thread per 64-byte block; the block's counter is
// counter0 + global block index with u32 wrap.  The data moves as four
// 16-byte loads and stores per thread.  Any N works: the ragged edge is
// masked here, so the wrapper never pads.
//
// Bound on an H100: about 1,000 integer operations per 128 bytes moved,
// far above the card's int-ops-per-byte balance, so the kernel is bound by
// the INT32 issue rate, not by memory.  The design keeps all 16 state words
// in registers (no shared memory, no spills) and fully unrolls the rounds so
// nothing but the ALU work is left; it allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chacha20_xor_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                    const uint32_t* __restrict__ key,
                    const uint32_t* __restrict__ nonce, uint32_t counter0,
                    int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t k[8], nc[3], ks[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) k[w] = __ldg(key + w);
#pragma unroll
  for (int w = 0; w < 3; ++w) nc[w] = __ldg(nonce + w);
  repro_torch::chacha20_block(k, counter0 + static_cast<uint32_t>(i), nc, ks);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[4 * i + q] = repro_torch::xor_quad(data[4 * i + q], ks, q);
}

}  // namespace

// data, out: (n, 16) u32, contiguous, 16-byte aligned; key (8,), nonce (3,)
// u32 on the same device.  Launches on `stream`; returns cudaGetLastError().
extern "C" int chacha20_xor_launch(const void* data, void* out,
                                   const void* key, const void* nonce,
                                   uint32_t counter0, int64_t n,
                                   void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  chacha20_xor_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out),
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(nonce),
      counter0, n);
  return static_cast<int>(cudaGetLastError());
}
