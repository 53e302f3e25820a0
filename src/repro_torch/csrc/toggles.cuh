// Bus-toggle arithmetic of the weight-stationary toggle counters: K1
// (activity_profile.cu) and K2 (activity_batch.cu) count the transitions of
// partial sums held in registers with these.
//
// A bus of b bits carries the low b bits of a value's two's-complement
// representation. A partial sum is a sign-extended int64, so the toggles of
// a transition s -> s' are popcount((s ^ s') & mask(b)). On a bus wider than
// 32 bits the XOR's high word is masked to its hb = b - 32 bits; those are
// few (5 at b_v = 37), so `transitions` packs the masked high words of
// several transitions into one word before a single popcount.
#pragma once

#include <cstdint>

namespace toggles {

// Toggles of a sign-extended int32 XOR `d` on a bus of low-word mask `lo`
// and `hi_bits` bits above bit 31 (all copies of bit 31).
__device__ __forceinline__ unsigned bus32(int32_t d, unsigned lo, unsigned hi_bits) {
  return __popc(static_cast<unsigned>(d) & lo) + (d < 0 ? hi_bits : 0u);
}

// The toggles of the N - 1 transitions between neighbouring partial sums
// s[j - 1] -> s[j] on a bus of low-word mask `lo_mask` and high-word mask
// `hi_mask`. S is the field width of the packed high words: 0 when the bus
// has none (b <= 32), else 32 / S masked high words share one popcount; a
// field's high word is below 2^S, so fields never overlap and adding them
// is OR-ing them.
template <int S, int N>
__device__ __forceinline__ unsigned transitions(const long long (&s)[N], unsigned lo_mask,
                                                unsigned hi_mask) {
  constexpr int kSteps = N - 1;
  constexpr int kFields = S ? 32 / S : 1;
  constexpr int kWords = (kSteps + kFields - 1) / kFields;
  unsigned cnt = 0;
  unsigned packed[kWords] = {};
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const unsigned lo = static_cast<unsigned>(s[j]) ^ static_cast<unsigned>(s[j - 1]);
    cnt += __popc(lo & lo_mask);
    if constexpr (S > 0) {
      const unsigned hi =
          (static_cast<unsigned>(s[j] >> 32) ^ static_cast<unsigned>(s[j - 1] >> 32)) & hi_mask;
      packed[(j - 1) / kFields] += hi << ((j - 1) % kFields * S);
    }
  }
  if constexpr (S > 0) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) cnt += __popc(packed[i]);
  }
  return cnt;
}

}  // namespace toggles
