// Fused VPC datapath: firewall -> NAT -> ChaCha20 -> egress in one launch.
//
// Replaces the JAX package's Pallas kernel
// kernels/vpc_datapath/kernel.py::vpc_datapath_kernel_call (body
// _vpc_datapath_kernel).
//
// A block of 128 threads takes a tile of 256 packets, two a thread (four
// a thread left fewer warps to hide the loads with, and were slower at
// every batch the main path sends):
//   1. the block reads the tile's (n, 5) header rows and counters into
//      shared memory with coalesced 16-byte loads, and with them the first
//      chunk of the rule table;
//   2. the rule table is staged in chunks of 1,024 rules; as a chunk is
//      staged each rule {prefix, mask, mask length, allow} is rewritten as
//      {prefix, mask, key}, key = hit bit (bit 31) | mask length << 25 |
//      (R - 1 - rule index) << 1 | allow.  Among the rules that hit, the
//      largest key is the reference's winner (longest mask, then the first
//      index, as its argmax breaks ties) and its low bit the verdict; no hit
//      leaves 0, which means allow (a /0 deny rule at the last index has a
//      key of 0x80000000, so it is never read as "no hit").  Per rule and
//      packet the loop is t = (dst & mask) ^ prefix, t == 0 and a
//      predicated unsigned max, which ptxas issues as two instructions
//      (LOP3 with a predicate out, predicated VIMNMX); every shared load of
//      a rule (a broadcast) serves the thread's two packets, whose compares
//      are independent;
//   3. the NAT flow hash and the egress header are written over the staged
//      header rows, the verdict byte straight out;
//   4. each warp lists its allowed packets (ballot, popc) and its lanes run
//      the 20 ChaCha20 rounds over that list only, each lane's packet's
//      payload loaded before its rounds and XOR-ed straight out; denied
//      packets' payload is zeroed;
//   5. the header rows leave shared memory with coalesced 16-byte stores.
// The 24 index bits of the key limit R to 16,777,216 rules (the launch
// returns cudaErrorInvalidValue above it; the wrapper raises first).
//
// Bound on an H100: per packet 3 integer operations a rule (the logic op,
// the compare, the max), the NAT hash and ~1,000 for an allowed packet's
// keystream, against 173 bytes moved: at R = 300 the operations and the
// bytes nearly balance.  In SASS the firewall's two instructions and the
// keystream's xors and funnel shifts all issue on the 64-lane integer
// pipe, which bounds the kernel in practice; the keystream's adds go to
// the FMA pipe.  Staging the payload in shared memory (a bulk copy during
// the firewall), an L2 bulk prefetch of it, and loads pipelined one packet
// ahead were each measured slower on the card (PERF.md §6).  Headers,
// verdict and keystream never leave the block between the three NTs (the
// fusion the Pallas kernel got from VMEM).  Nothing is allocated or
// synchronised here.
#include <cuda_runtime.h>

#include <cstdint>

#include "chacha20.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRuleChunk = 1024;           // rules staged at a time
constexpr int kIndexBits = 24;             // rule-index bits of the key
constexpr int64_t kMaxRules = int64_t(1) << kIndexBits;
constexpr int kPackets = 2;                // packets a thread
constexpr int kTile = kThreads * kPackets;  // packets a block
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  uint4 rules[kRuleChunk];                 // {prefix, mask, key, 0}
  uint32_t headers[kTile * 5];             // rows of 5 words
  uint32_t ctr[kTile];
  uint16_t list[kTile];                    // allowed packets, per warp
};

// rules [base, base + m) of r, packed as {prefix, mask, key, 0}
__device__ __forceinline__ void stage_rules(uint4* dst,
                                            const uint4* __restrict__ rules,
                                            int64_t base, int m, int64_t r) {
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const uint4 rule = __ldg(rules + base + j);
    const uint32_t index = static_cast<uint32_t>(r - 1 - (base + j));
    dst[j] = make_uint4(rule.x, rule.y,
                        0x80000000u | (rule.z & 63u) << 25 | index << 1 |
                            (rule.w != 0 ? 1u : 0u),
                        0u);
  }
}

// best = max(best, key) where (dst & mask) == prefix
__device__ __forceinline__ void match(uint32_t& best, uint32_t dst,
                                      const uint4& rule) {
  const uint32_t t = (dst & rule.y) ^ rule.x;
  asm("{\n"
      ".reg .pred hit;\n"
      "setp.eq.u32 hit, %1, 0;\n"
      "@hit max.u32 %0, %0, %2;\n"
      "}\n"
      : "+r"(best) : "r"(t), "r"(rule.z));
}

// `words` u32 from global `src` into shared `dst` (16-byte aligned), as
// 16-byte vectors where `src` allows
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* src, int words) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vecs = words / 4;
    for (int v = threadIdx.x; v < vecs; v += kThreads)
      reinterpret_cast<uint4*>(dst)[v] =
          __ldg(reinterpret_cast<const uint4*>(src) + v);
    done = vecs * 4;
  }
  for (int w = done + threadIdx.x; w < words; w += kThreads)
    dst[w] = __ldg(src + w);
}

__device__ __forceinline__ void unstage_words(uint32_t* dst,
                                              const uint32_t* src, int words) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = words / 4;
    for (int v = threadIdx.x; v < vecs; v += kThreads)
      reinterpret_cast<uint4*>(dst)[v] =
          reinterpret_cast<const uint4*>(src)[v];
    done = vecs * 4;
  }
  for (int w = done + threadIdx.x; w < words; w += kThreads)
    dst[w] = src[w];
}

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
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int cnt = static_cast<int>(n - i0 < kTile ? n - i0 : kTile);

  // the tile's header rows and counters and the first rule chunk, all
  // loads in flight at once
  stage_words(sm.headers, headers + 5 * i0, 5 * cnt);
  stage_words(sm.ctr, ctr + i0, cnt);
  int m = static_cast<int>(r < kRuleChunk ? r : kRuleChunk);
  stage_rules(sm.rules, rules, 0, m, r);
  __syncthreads();

  // ---- NT 1: firewall (longest-prefix match on dst, default allow) ----
  uint32_t dst[kPackets], best[kPackets];
#pragma unroll
  for (int k = 0; k < kPackets; ++k) {
    const int p = k * kThreads + tid;
    dst[k] = p < cnt ? sm.headers[5 * p + 1] : 0u;
    best[k] = 0u;
  }
  for (int64_t base = 0;;) {
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const uint4 rule = sm.rules[j];
#pragma unroll
      for (int k = 0; k < kPackets; ++k) match(best[k], dst[k], rule);
    }
    base += kRuleChunk;
    if (base >= r) break;
    m = static_cast<int>(r - base < kRuleChunk ? r - base : kRuleChunk);
    __syncthreads();                       // the last chunk is done with
    stage_rules(sm.rules, rules, base, m, r);
    __syncthreads();
  }

  // ---- NT 2: NAT source rewrite, and the egress header and verdict ----
  const uint32_t nat = __ldg(nat_ip);
  bool allowed[kPackets];
#pragma unroll
  for (int k = 0; k < kPackets; ++k) {
    const int p = k * kThreads + tid;
    allowed[k] = false;
    if (p < cnt) {
      const bool ok = best[k] == 0u || (best[k] & 1u) != 0u;
      allowed[k] = ok;
      uint32_t* h = sm.headers + 5 * p;
      if (ok) {
        const uint32_t flow = h[0] ^ (h[1] * 2654435761u) ^ (h[2] << 16) ^
                              h[3] ^ h[4];
        h[0] = nat;
        h[2] = ((flow * salt) >> 16) & 0xFFFFu;
      }
      allow_out[i0 + p] = ok ? 1 : 0;
    }
  }

  // ---- the warp's allowed packets, listed densely ----
  uint16_t* list = sm.list + warp * 32 * kPackets;
  int listed = 0;
#pragma unroll
  for (int k = 0; k < kPackets; ++k) {
    const unsigned ballot = __ballot_sync(kFull, allowed[k]);
    if (allowed[k])
      list[listed + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(k * kThreads + tid);
    listed += __popc(ballot);
  }
  __syncwarp();

  // ---- NT 3: ChaCha20 over the allowed packets; denied ones zeroed ----
#pragma unroll
  for (int k = 0; k < kPackets; ++k) {
    const int p = k * kThreads + tid;
    if (p < cnt && !allowed[k]) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pout[4 * (i0 + p) + q] = make_uint4(0, 0, 0, 0);
    }
  }
  if (listed > 0) {
    uint32_t kw[8], nc[3], ks[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) kw[w] = __ldg(key + w);
#pragma unroll
    for (int w = 0; w < 3; ++w) nc[w] = __ldg(nonce + w);
    for (int j = lane; j < listed; j += 32) {
      const int64_t i = i0 + list[j];
      uint4 data[4];                     // in flight during the rounds
#pragma unroll
      for (int q = 0; q < 4; ++q) data[q] = __ldg(payload + 4 * i + q);
      repro_torch::chacha20_block(kw, sm.ctr[i - i0], nc, ks);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pout[4 * i + q] = repro_torch::xor_quad(data[q], ks, q);
    }
  }
  __syncthreads();                         // the egress header rows

  // ---- egress: the tile's header rows out ----
  unstage_words(hout + 5 * i0, sm.headers, 5 * cnt);
}

}  // namespace

// headers (n, 5), payload (n, 16), ctr (n,) u32; rules (r, 4) u32 rows of
// {prefix, mask, mask length, allow}, the lengths the masks' popcounts
// (at most 32); key (8,), nonce (3,), nat_ip (1,) u32; outputs allow (n,)
// bytes (a torch.bool tensor), headers (n, 5) and payload (n, 16) u32.  All
// contiguous on one device, payload, pout and rules 16-byte aligned;
// 1 <= r <= 16,777,216.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for an r it does not take).
extern "C" int vpc_datapath_launch(const void* headers, const void* payload,
                                   const void* ctr, const void* rules,
                                   const void* key, const void* nonce,
                                   const void* nat_ip, uint32_t salt,
                                   void* allow_out, void* hout, void* pout,
                                   int64_t n, int64_t r, void* stream) {
  if (n <= 0) return 0;
  if (r < 1 || r > kMaxRules) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(headers);
  const auto* p = static_cast<const uint4*>(payload);
  const auto* c = static_cast<const uint32_t*>(ctr);
  const auto* ru = static_cast<const uint4*>(rules);
  const auto* k = static_cast<const uint32_t*>(key);
  const auto* nc = static_cast<const uint32_t*>(nonce);
  const auto* ip = static_cast<const uint32_t*>(nat_ip);
  auto* a = static_cast<uint8_t*>(allow_out);
  auto* ho = static_cast<uint32_t*>(hout);
  auto* po = static_cast<uint4*>(pout);
  vpc_datapath_kernel<<<static_cast<unsigned>((n + kTile - 1) / kTile),
                        kThreads, 0, st>>>(h, p, c, ru, k, nc, ip, salt, a,
                                           ho, po, n, r);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block of the kernel holds: the staged rule chunk and
// the tile's header rows, counters and allowed list.
extern "C" int64_t vpc_datapath_smem_bytes() {
  return static_cast<int64_t>(sizeof(Smem));
}
