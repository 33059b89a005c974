// Helpers shared by the port's CUDA kernels (multipaxos.cu,
// compartmentalized.cu, mencius.cu, fastmultipaxos.cu, horizontal.cu,
// scalog.cu). Each kernel computes what its plain PyTorch twin
// computes, bit for bit, and these are the places where C++ and the array
// libraries part ways:
//   * Floor mod. jnp's and torch's % on ints is floor mod; C++ % truncates.
//     Ring ordinals (w - head) % W go through floor_mod().
//   * Wrapping int32. JAX and torch int32 arithmetic wraps; C++ signed
//     overflow is undefined. An int32 add/sub that can reach the edge (tick
//     stamps, heads) is computed in uint32 and cast back (wadd, wsub).
//   * int16 weak typing. JAX computes clock - 1 in int16 (a Python scalar
//     does not widen the array); age_clock() subtracts, casts to int16,
//     then saturates at the clock floor, keeping the INF16 sentinel.
//   * Bool masks enter and leave as uint8 (0/1), the byte layout of
//     torch.bool.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf16 = 32767;
constexpr int kClockFloor = -1;

__device__ __forceinline__ int wadd(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}
__device__ __forceinline__ int wsub(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) - static_cast<unsigned>(y));
}
__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int16_t age_clock(int16_t x) {
  if (x == kInf16) return x;
  int16_t d = static_cast<int16_t>(static_cast<int>(x) - 1);
  return d > kClockFloor ? d : static_cast<int16_t>(kClockFloor);
}

// 16-byte vector access (the vector routes of multipaxos.cu's phase-1
// kernel and compartmentalized.cu's grid vote): 8 int16, 4 int32 or 16
// int8 lanes in one load or store. Every pointer must be 16-byte aligned
// (8-byte for the 8-lane byte planes, V8); the launchers check it.
union V16 {
  uint4 u;
  uint32_t w[4];
  int16_t h[8];
  int32_t i[4];
};
union V8 {
  uint2 u;
  int8_t b[8];
  uint8_t ub[8];
};

__device__ __forceinline__ V16 ld16(const void* p) {
  V16 v;
  v.u = *static_cast<const uint4*>(p);
  return v;
}
__device__ __forceinline__ void st16(void* p, const V16& v) {
  *static_cast<uint4*>(p) = v.u;
}
__device__ __forceinline__ V8 ld8(const void* p) {
  V8 v;
  v.u = *static_cast<const uint2*>(p);
  return v;
}
__device__ __forceinline__ void st8(void* p, const V8& v) {
  *static_cast<uint2*>(p) = v.u;
}

// Lane l of an 8-lane int32 row held as two V16.
__device__ __forceinline__ int& lane32(V16* v, int l) { return v[l >> 2].i[l & 3]; }

// Lane work on int16 rows runs two lanes a 32-bit word (a row of 8 slots
// is a V16: 4 words) with per-halfword SIMD ops, and lane masks take the
// same layout: a word per lane pair (2k, 2k + 1), 0xffff in a half where
// its lane is set.
// age_clock on both int16 halves of a word: INF16 stays, else
// max(x - 1, -1) with the int16 wrap.
__device__ __forceinline__ unsigned age2(unsigned x) {
  const unsigned inf = __vcmpeq2(x, 0x7fff7fffu);
  const unsigned d = __vmaxs2(__vsub2(x, 0x00010001u), 0xffffffffu);
  return (x & inf) | (d & ~inf);
}
__device__ __forceinline__ unsigned sel2(unsigned m, unsigned a, unsigned b) {
  return (a & m) | (b & ~m);
}
// Bytes b0..b3 of a word (0 or not) as the 16-bit masks of lanes (0, 1)
// (half = 0) or (2, 3) (half = 1).
__device__ __forceinline__ unsigned byte_mask2(unsigned bytes, int half) {
  const unsigned nz = __vcmpne4(bytes, 0u);
  return __byte_perm(nz, 0u, half ? 0x3322u : 0x1100u);
}
// The 8 lanes of a byte row (V8) as 4 mask words.
__device__ __forceinline__ void byte_masks(unsigned* m, const V8& v) {
  m[0] = byte_mask2(v.u.x, 0);
  m[1] = byte_mask2(v.u.x, 1);
  m[2] = byte_mask2(v.u.y, 0);
  m[3] = byte_mask2(v.u.y, 1);
}
// The low halves of an int32 row's lanes (2k, 2k+1), packed as int16.
__device__ __forceinline__ unsigned low_halves(const V16* v, int k) {
  return __byte_perm(static_cast<unsigned>(v[k >> 1].i[(k & 1) * 2]),
                     static_cast<unsigned>(v[k >> 1].i[(k & 1) * 2 + 1]),
                     0x5410u);
}
// Mask words of 16-bit lanes as 8 bytes of 0 / 1 (lane order).
__device__ __forceinline__ V8 mask_bytes(const unsigned* m) {
  V8 v;
  v.u.x = __byte_perm(m[0], m[1], 0x6420u) & 0x01010101u;
  v.u.y = __byte_perm(m[2], m[3], 0x6420u) & 0x01010101u;
  return v;
}
__device__ __forceinline__ bool any_lane(const unsigned* m, int k0, int n) {
  unsigned o = 0;
  for (int k = k0; k < k0 + n; ++k) o |= m[k];
  return o != 0;
}
// The lanes of an int32 row that the mask words name: the 16-byte half of
// the row that holds no such lane is not read (and reads as 0).
__device__ __forceinline__ void load_masked(V16* v, const int* row,
                                            const unsigned* m) {
  v[0].u = v[1].u = make_uint4(0, 0, 0, 0);
  if (any_lane(m, 0, 2)) v[0] = ld16(row);
  if (any_lane(m, 2, 2)) v[1] = ld16(row + 4);
}
// The 32-bit mask of lane l (its half of mask word m), for int32 lanes.
__device__ __forceinline__ unsigned lane_mask32(unsigned m, int l) {
  return __byte_perm(m, 0u, (l & 1) ? 0x3232u : 0x1010u);
}

// Host side: is every non-null pointer of ptrs[0..n) 16-byte aligned?
inline bool all_aligned16(void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15u) return false;
  }
  return true;
}

// Per-group reductions into shared memory. Every thread of the block
// calls these (masked threads with a value that is then discarded). With
// `aligned` (W % 32 == 0) every warp lies inside one group: one warp
// reduction, then one shared atomic per warp; otherwise one shared atomic
// per thread.
__device__ __forceinline__ void group_max(int* slot, int v, bool aligned) {
  if (aligned) {
    v = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) atomicMax(slot, v);
  } else {
    atomicMax(slot, v);
  }
}
__device__ __forceinline__ void group_min(int* slot, int v, bool aligned) {
  if (aligned) {
    v = __reduce_min_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) atomicMin(slot, v);
  } else {
    atomicMin(slot, v);
  }
}

}  // namespace
