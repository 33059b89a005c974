// Hand-written Hopper (sm_90a) kernels for the Mencius vote plane.
//
//   fpx_mencius_vote  replaces fused_mencius_vote
//                     (frankenpaxos_tpu/ops/mencius.py:81, pallas_call at
//                     :124): the acceptors of every leader stripe vote on
//                     the Phase2a messages that arrive now, schedule their
//                     Phase2b replies, and the per-slot vote count sums the
//                     acceptor axis.
//
// It computes exactly what reference_mencius_vote in
// frankenpaxos_tpu_torch/ops/mencius.py computes, bit for bit: per cell,
// arrived = p2a == t; voted |= arrived; p2b = min(p2b, t + lat) where
// arrived and delivered (t + lat in wrapping int32); the count adds the
// cells with p2b <= t and voted.
//
// Design. The State is leader-major [L, W, A] with the acceptor axis
// minor, so a slot's A acceptors are neighbouring cells, and 4 consecutive
// slots are 4A neighbouring cells: A 16-byte vectors of an int32 plane, A
// 4-byte words of a bool plane, whatever A is, aligned wherever the planes
// are. Two routes, the wrapper's choice (ops/mencius.py
// mencius_vote_route), checked here:
//
//   * vector (mencius_vote_vec): a thread owns one 16-byte vector of
//     cells (4 cells), a CTA of 32 * A threads the 32 * A vectors of 32
//     slot quads (L*W % 4 == 0, A in {3, 5, 7, 9}). A thread issues the
//     loads of its Phase2a ticks, Phase2b ticks and vote bits (a 16-byte
//     vector, a 16-byte vector and a 4-byte word) before any store; then
//     the delivery bit of each cell whose Phase2a arrives now, then the
//     latency of each of those whose reply is delivered (one byte and one
//     int a cell, where the function needs them); then it stores a
//     16-byte vector of Phase2b ticks and a 4-byte word of vote bits. The
//     cells' counts meet in shared memory, and the CTA's first 32 threads
//     each sum a slot quad's 4A of them into one 16-byte vector of counts.
//     Threads past the last cell are masked, not returned. A chip race
//     (harness/chain_race.py) chose this over a thread a slot quad (A
//     vectors of each plane a thread, the counts in registers), which was
//     slower than the general route (PERF.md).
//   * general (mencius_vote_kernel, the kernel the route was first
//     written as, its pointers __restrict__): one thread per (l, w) slot
//     walks its A cells and reads the vote bit only where nothing arrives
//     now, the delivery bit only where something does, the latency only
//     where a delivered reply is scheduled.
//
// Bound. A few integer ops per byte: bound by the bytes moved. The bytes
// the function needs (ops/mencius.py mencius_vote_needed_bytes: what the
// general route reads, 9 B a cell and the latency where a delivered reply
// is scheduled, and 5 B a cell and 4 B a slot out) are 5.16 MB at (L, W,
// A) = (3334, 32, 3) on the kernels line's inputs, 1.5 us at 3.35 TB/s;
// the vector route also reads the vote bits of the cells whose Phase2a
// arrives now (mencius_vote_route_bytes, 5.24 MB); every input and output
// once is 6.5 MB.

#include "common.cuh"

namespace {

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/mencius.py, _PTR_SLOTS).
enum Slot { P2A, VOTED, P2B, LAT, DELIV, O_VOTED, O_P2B, O_NV, NUM_SLOTS };

// Routes, as the wrapper names them (ops/mencius.py mencius_vote_route;
// codes of ops/registry.py ROUTES).
enum Route { kGeneral = 1, kVector = 2 };

// Slot quads (4 slots, 4A cells, A vectors of cells) a CTA of the vector
// route owns: a CTA of 32 * A threads.
constexpr int kQuads = 32;

struct Args {
  void* p[NUM_SLOTS];
  int L, W, A, t;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// One cell after the vote. voted_in() is called only where nothing
// arrives now, delivered() only where something does, lat() only where a
// delivered reply is scheduled.
struct Cell {
  bool voted;
  int p2b;
};

template <typename Voted, typename Deliv, typename Lat>
__device__ __forceinline__ Cell vote_cell(int t, int p2a, int p2b,
                                          Voted voted_in, Deliv delivered,
                                          Lat lat) {
  Cell c{false, p2b};
  if (p2a == t) {
    c.voted = true;
    if (delivered()) {
      const int cand = wadd(t, lat());
      if (cand < p2b) c.p2b = cand;
    }
  } else {
    c.voted = voted_in();
  }
  return c;
}

__device__ __forceinline__ int counts(const Cell& c, int t) {
  return (c.voted && c.p2b <= t) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// General route: any shape, any alignment.
// ---------------------------------------------------------------------------

__global__ void mencius_vote_kernel(const Args a) {
  const size_t LW = static_cast<size_t>(a.L) * a.W;
  const size_t s = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= LW) return;
  const int* __restrict__ p2a = in<int>(a, P2A);
  const uint8_t* __restrict__ voted_in = in<uint8_t>(a, VOTED);
  const int* __restrict__ p2b_in = in<int>(a, P2B);
  const int* __restrict__ lat = in<int>(a, LAT);
  const uint8_t* __restrict__ deliv = in<uint8_t>(a, DELIV);
  uint8_t* __restrict__ o_voted = out<uint8_t>(a, O_VOTED);
  int* __restrict__ o_p2b = out<int>(a, O_P2B);

  int nv = 0;
  for (int k = 0; k < a.A; ++k) {
    const size_t i = s * a.A + k;
    const Cell c = vote_cell(
        a.t, p2a[i], p2b_in[i], [&] { return voted_in[i] != 0; },
        [&] { return deliv[i] != 0; }, [&] { return lat[i]; });
    o_voted[i] = c.voted;
    o_p2b[i] = c.p2b;
    nv += counts(c, a.t);
  }
  out<int>(a, O_NV)[s] = nv;
}

// ---------------------------------------------------------------------------
// Vector route (module comment): a 16-byte vector of cells a thread.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool byte_of(unsigned w, int b) {
  return ((w >> (8 * b)) & 0xffu) != 0;
}

template <int A>
__global__ void __launch_bounds__(32 * A) mencius_vote_vec(const Args a) {
  __shared__ uint8_t s_cnt[kQuads * 4 * A];
  const int t = a.t;
  const size_t quads = static_cast<size_t>(a.L) * a.W / 4;
  const size_t q0 = static_cast<size_t>(blockIdx.x) * kQuads;
  const size_t c0 = (q0 * A + threadIdx.x) * 4;  // the thread's first cell
  const bool active = c0 < quads * 4 * A;

  // One trip: the Phase2a ticks, Phase2b ticks and vote bits.
  V16 p2a, p2b;
  p2a.u = p2b.u = make_uint4(0, 0, 0, 0);
  unsigned voted = 0;
  if (active) {
    p2a = ld16(in<int>(a, P2A) + c0);
    p2b = ld16(in<int>(a, P2B) + c0);
    voted = *reinterpret_cast<const unsigned*>(in<uint8_t>(a, VOTED) + c0);
  }
  // The delivery bits of the cells whose Phase2a arrives now, then the
  // latencies of those whose reply is delivered.
  const uint8_t* __restrict__ deliv_in = in<uint8_t>(a, DELIV) + c0;
  const int* __restrict__ lat_in = in<int>(a, LAT) + c0;
  bool del[4];
  int lat[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    del[b] = active && p2a.i[b] == t && deliv_in[b] != 0;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) lat[b] = del[b] ? lat_in[b] : 0;

  V16 o_p2b;
  unsigned o_voted = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const Cell c = vote_cell(
        t, p2a.i[b], p2b.i[b], [&] { return byte_of(voted, b); },
        [&] { return del[b]; }, [&] { return lat[b]; });
    o_p2b.i[b] = c.p2b;
    o_voted |= (c.voted ? 1u : 0u) << (8 * b);
    s_cnt[4 * threadIdx.x + b] = counts(c, t);
  }
  if (active) {
    st16(out<int>(a, O_P2B) + c0, o_p2b);
    *reinterpret_cast<unsigned*>(out<uint8_t>(a, O_VOTED) + c0) = o_voted;
  }
  __syncthreads();
  const size_t q = q0 + threadIdx.x;
  if (threadIdx.x >= kQuads || q >= quads) return;
  V16 nv;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    nv.i[l] = 0;
#pragma unroll
    for (int k = 0; k < A; ++k) nv.i[l] += s_cnt[(threadIdx.x * 4 + l) * A + k];
  }
  st16(out<int>(a, O_NV) + q * 4, nv);
}

template <int A>
void launch_vector(size_t LW, cudaStream_t st, const Args& a) {
  const size_t quads = LW / 4;
  const unsigned grid = static_cast<unsigned>((quads + kQuads - 1) / kQuads);
  mencius_vote_vec<A><<<grid, kQuads * A, 0, st>>>(a);
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_mencius_num_slots() { return NUM_SLOTS; }

// Launch the vote kernel. ptrs holds NUM_SLOTS device pointers;
// ints = {L, W, A, t, threads per block of the general route, route
// (`Route`)}. The vector route runs 32 * A threads a CTA; it is refused
// unless L * W % 4 == 0, A is in {3, 5, 7, 9} and every pointer is 16-byte
// aligned. Returns the CUDA error of the launch (0 = launched). Does not
// synchronise.
int fpx_mencius_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.L = ints[0];
  a.W = ints[1];
  a.A = ints[2];
  a.t = ints[3];
  const int threads = ints[4];
  const int route = ints[5];
  if (a.L <= 0 || a.W <= 0) return 0;
  if (a.A <= 0 || threads < 32 || threads > 1024) return cudaErrorInvalidValue;
  const size_t LW = static_cast<size_t>(a.L) * a.W;
  if ((LW + threads - 1) / threads > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kVector) {
    if (LW % 4 || !all_aligned16(a.p, NUM_SLOTS)) return cudaErrorInvalidValue;
    switch (a.A) {
      case 3: launch_vector<3>(LW, st, a); break;
      case 5: launch_vector<5>(LW, st, a); break;
      case 7: launch_vector<7>(LW, st, a); break;
      case 9: launch_vector<9>(LW, st, a); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (route == kGeneral) {
    const unsigned grid = static_cast<unsigned>((LW + threads - 1) / threads);
    mencius_vote_kernel<<<grid, threads, 0, st>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
