// Bus-toggle arithmetic of the toggle counters: K1 (activity_profile.cu)
// and K2 (activity_batch.cu) count the transitions of partial sums held in
// registers with the masked popcounts; L1 and L2 (lane_toggles.cu) count
// them per bit lane with the bit-sliced counters at the end.
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

// Bit-sliced lane counters. Plane j of a counter holds bit j of 32 per-lane
// counts, one lane per bit position, so a full adder on three words adds 32
// lanes at once (two LOP3s: the sum and the carry).
__device__ __forceinline__ void full_add(unsigned a, unsigned b, unsigned c, unsigned& sum,
                                         unsigned& carry) {
  sum = a ^ b ^ c;
  carry = (a & b) | (c & (a ^ b));
}

// The per-lane counts of the set bits of 15 words (each 0..15) as 4 planes:
// a tree of 11 full adders, where adding each word to a counter one at a
// time would ripple through every plane.
__device__ __forceinline__ void count15(const unsigned (&x)[15], unsigned (&c)[4]) {
  unsigned s0, s1, s2, s3, s4, k0, k1, k2, k3, k4;  // weight 1 sums, weight 2 carries
  full_add(x[0], x[1], x[2], s0, k0);
  full_add(x[3], x[4], x[5], s1, k1);
  full_add(x[6], x[7], x[8], s2, k2);
  full_add(x[9], x[10], x[11], s3, k3);
  full_add(x[12], x[13], x[14], s4, k4);
  unsigned t0, m0, m1;
  full_add(s0, s1, s2, t0, m0);
  full_add(t0, s3, s4, c[0], m1);
  unsigned u0, u1, f0, f1, f2;  // weight 2 sums, weight 4 carries
  full_add(k0, k1, k2, u0, f0);
  full_add(k3, k4, m0, u1, f1);
  full_add(u0, u1, m1, c[1], f2);
  full_add(f0, f1, f2, c[2], c[3]);
}

// acc += c, lane by lane: a 4-plane count into a P-plane counter. The
// caller bounds every lane's count below 2^P, so nothing carries out.
template <int P>
__device__ __forceinline__ void add_planes(unsigned (&acc)[P], const unsigned (&c)[4]) {
  unsigned carry = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const unsigned x = j < 4 ? c[j] : 0u;
    const unsigned sum = acc[j] ^ x ^ carry;
    carry = (acc[j] & x) | (carry & (acc[j] ^ x));
    acc[j] = sum;
  }
}

// Lane b's count in a P-plane counter.
template <int P>
__device__ __forceinline__ unsigned lane_count(const unsigned (&acc)[P], int b) {
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) v |= ((acc[j] >> b) & 1u) << j;
  return v;
}

}  // namespace toggles
