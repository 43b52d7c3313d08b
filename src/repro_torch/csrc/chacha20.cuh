// ChaCha20 block function (RFC 8439) over 16 uint32_t registers.
//
// Shared by both kernels of the port (chacha20.cu, vpc_datapath.cu), as
// kernels/chacha20/core.py is shared by the plain PyTorch paths.  One
// thread computes one 64-byte block; the whole state lives in registers and
// the loops unroll completely, so the block function is pure integer ALU
// work (add, xor, funnel-shift rotate) with no memory traffic.
#pragma once

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d = rotl32(d ^ a, 16);
  c += d; b = rotl32(b ^ c, 12);
  a += b; d = rotl32(d ^ a, 8);
  c += d; b = rotl32(b ^ c, 7);
}

// ks = ChaCha20 block(key, counter, nonce): 20 rounds, then the
// feed-forward add of the initial state.
__device__ __forceinline__ void chacha20_block(const uint32_t key[8],
                                               uint32_t counter,
                                               const uint32_t nonce[3],
                                               uint32_t ks[16]) {
  uint32_t init[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                       key[0], key[1], key[2], key[3],
                       key[4], key[5], key[6], key[7],
                       counter, nonce[0], nonce[1], nonce[2]};
  uint32_t x[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) x[w] = init[w];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    // column rounds
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    // diagonal rounds
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int w = 0; w < 16; ++w) ks[w] = x[w] + init[w];
}

// XOR one 64-byte block (four uint4) with the keystream.
__device__ __forceinline__ uint4 xor_quad(uint4 v, const uint32_t ks[16],
                                          int q) {
  v.x ^= ks[4 * q];
  v.y ^= ks[4 * q + 1];
  v.z ^= ks[4 * q + 2];
  v.w ^= ks[4 * q + 3];
  return v;
}

}  // namespace repro_torch
