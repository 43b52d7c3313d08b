// Fused VPC datapath: firewall -> NAT -> ChaCha20 -> egress in one launch.
//
// Replaces the JAX package's Pallas kernel
// kernels/vpc_datapath/kernel.py::vpc_datapath_kernel_call (body
// _vpc_datapath_kernel).
//
// One thread per packet, blocks of 256 threads.  Each thread
//   1. reads its 5 header words and its keystream counter;
//   2. runs the longest-prefix match of dst over every rule, keeping the
//      first rule among equal mask lengths (the reference's argmax
//      tie-break); no hit means allow;
//   3. computes the NAT flow hash with wrapping u32 multiplies;
//   4. for an allowed packet, generates the ChaCha20 keystream in registers
//      and XORs its 16 payload words;
//   5. writes allow, headers and payload with the egress verdict applied
//      (denied: original header, zero payload).
// The rule table (prefix, mask, mask length, allow: 16 bytes a rule) is
// staged into shared memory in chunks of kRuleChunk, so any R >= 1 works;
// every thread of a block then reads the same rule at once (a broadcast,
// no bank conflicts).
//
// Bound on an H100: per packet about 5 integer operations per rule plus
// about 1,000 for the keystream, against 173 bytes moved, so the kernel is
// bound by the INT32 issue rate.  Headers, verdict and keystream never leave
// registers between the three NTs (the fusion the Pallas kernel got from
// VMEM), the only shared memory is the rule chunk, and nothing is allocated
// or synchronised here.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRuleChunk = 1024;  // 16 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
vpc_datapath_kernel(const uint32_t* __restrict__ headers,
                    const uint4* __restrict__ payload,
                    const uint32_t* __restrict__ ctr,
                    const uint4* __restrict__ rules,
                    const uint32_t* __restrict__ key,
                    const uint32_t* __restrict__ nonce,
                    const uint32_t* __restrict__ nat_ip, uint32_t salt,
                    uint8_t* __restrict__ allow_out,
                    uint32_t* __restrict__ hout, uint4* __restrict__ pout,
                    int64_t n, int64_t r) {
  __shared__ uint4 srules[kRuleChunk];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;

  uint32_t h[5] = {0, 0, 0, 0, 0};
  if (live) {
#pragma unroll
    for (int w = 0; w < 5; ++w) h[w] = headers[5 * i + w];
  }

  // ---- NT 1: firewall (longest-prefix match on dst, default allow) ----
  int best_len = -1;
  uint32_t best_allow = 1;
  for (int64_t base = 0; base < r; base += kRuleChunk) {
    const int m = static_cast<int>(r - base < kRuleChunk ? r - base
                                                         : kRuleChunk);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = threadIdx.x; j < m; j += kThreads) srules[j] = rules[base + j];
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; ++j) {
        const uint4 rule = srules[j];  // {prefix, mask, mask length, allow}
        const int len = static_cast<int>(rule.z);
        if ((h[1] & rule.y) == rule.x && len > best_len) {
          best_len = len;
          best_allow = rule.w;
        }
      }
    }
  }
  if (!live) return;
  const bool allow = best_len < 0 || best_allow != 0;

  // ---- NT 2: NAT source rewrite (flow-hash port, fixed ip) ----
  const uint32_t flow = h[0] ^ (h[1] * 2654435761u) ^ (h[2] << 16) ^ h[3] ^
                        h[4];
  const uint32_t port = ((flow * salt) >> 16) & 0xFFFFu;

  // ---- egress: verdict, header, and the ChaCha20 payload ----
  allow_out[i] = allow ? 1 : 0;
  uint32_t* ho = hout + 5 * i;
  ho[0] = allow ? __ldg(nat_ip) : h[0];
  ho[1] = h[1];
  ho[2] = allow ? port : h[2];
  ho[3] = h[3];
  ho[4] = h[4];
  if (allow) {
    uint32_t k[8], nc[3], ks[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) k[w] = __ldg(key + w);
#pragma unroll
    for (int w = 0; w < 3; ++w) nc[w] = __ldg(nonce + w);
    repro_torch::chacha20_block(k, ctr[i], nc, ks);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pout[4 * i + q] = repro_torch::xor_quad(payload[4 * i + q], ks, q);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) pout[4 * i + q] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// headers (n, 5), payload (n, 16), ctr (n,) u32; rules (r, 4) u32 rows of
// {prefix, mask, mask length, allow}; key (8,), nonce (3,), nat_ip (1,) u32;
// outputs allow (n,) bytes (a torch.bool tensor), headers (n, 5) and
// payload (n, 16) u32.  All contiguous on one device, payload and rules
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError().
extern "C" int vpc_datapath_launch(const void* headers, const void* payload,
                                   const void* ctr, const void* rules,
                                   const void* key, const void* nonce,
                                   const void* nat_ip, uint32_t salt,
                                   void* allow_out, void* hout, void* pout,
                                   int64_t n, int64_t r, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  vpc_datapath_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(headers),
      static_cast<const uint4*>(payload), static_cast<const uint32_t*>(ctr),
      static_cast<const uint4*>(rules), static_cast<const uint32_t*>(key),
      static_cast<const uint32_t*>(nonce),
      static_cast<const uint32_t*>(nat_ip), salt,
      static_cast<uint8_t*>(allow_out), static_cast<uint32_t*>(hout),
      static_cast<uint4*>(pout), n, r);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block of the kernel holds (the staged rule chunk).
extern "C" int64_t vpc_datapath_smem_bytes() {
  return static_cast<int64_t>(kRuleChunk) * sizeof(uint4);
}
