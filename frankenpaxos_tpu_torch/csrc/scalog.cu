// Hand-written Hopper (sm_90a) kernel for the Scalog cut-commit plane.
//
//   fpx_scalog_cut_commit  replaces fused_scalog_cut_commit
//                          (frankenpaxos_tpu/ops/scalog.py:184, pallas_call
//                          at :247): the in-order commit scan over the
//                          in-flight cut ring, the newest committed cut's
//                          projection, each committing cut's record count
//                          and ordering lag, and the ring-slot frees.
//
// It computes exactly what reference_scalog_cut_commit in
// frankenpaxos_tpu_torch/ops/scalog.py computes, bit for bit:
//   * cut i of the issue order (i = 0 .. P-1 from committed_cuts) lives in
//     ring slot (committed_cuts + i) mod P (a floor mod) and is live while
//     committed_cuts + i < next_cut; it commits iff it is live and every
//     cut up to it has its decision landed (commit tick <= t). That is the
//     reference's running max over issue order, as a prefix of a ballot;
//   * the record count of a committing cut is the sum over shards of its
//     vector minus the previous cut's (the first one's previous is
//     last_committed_cut), in wrapping int32;
//   * the lag is (t - snap) + floor((snap - prev_snap + 1) / 2), a FLOOR
//     division (C's / truncates), in wrapping int32.
//
// Design. The grid runs over shards, one thread per shard s. The [P]-space
// ring walk is recomputed by the first warp of every CTA from the P commit
// ticks (one lane per cut, a warp ballot for the committed prefix) into
// shared memory; for P > 32 (a deeper pipeline than the main path's, as
// the JAX config accepts) a wide instantiation keeps the ring's slots in
// dynamic shared memory and loops its ballot over ceil(P / 32) words.
// Each thread then walks the committed
// prefix: it reads the committing cuts' values of its shard (a coalesced
// row of the [P, S] ring each), writes the newest one (or
// last_committed_cut) to new_cut[s], and adds vec_i[s] - prev_i[s] into
// recs[i]: a warp-shuffle reduction, then one int32 atomicAdd per warp and
// committed cut into recs, which the launch zeroes on the same stream
// first. Integer atomics wrap mod 2^32 whatever their order, so the sum is
// the plain version's wrapping sum32 exactly (the CUDA answer to the Pallas
// kernel's accumulation across grid steps). CTA 0 writes the [P]-space
// outputs. The ragged edge of the shard axis is masked per thread; its
// lanes add 0.
//
// Bound. Bytes: the committing cuts' rows (4 B per shard each),
// last_committed_cut in and new_cut out (8 B per shard), and ~30 B per ring
// slot. At (P, S) = (8, 10000) with every cut committing, 0.40 MB: 0.12 us
// at 3.35 TB/s. No launch is that short: the launch is a memset and a
// grid, and fpx_scalog_floor_launch runs the same two with a kernel that
// does nothing, the floor this plane's time is held against.

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 30;
constexpr int kMaxP = 32;

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/scalog.py, _PTR_SLOTS). CC and NC are 0-d
// device ints: committed_cuts and next_cut.
enum Slot {
  VEC, COMMIT, SNAP, PREV, LAST, CC, NC,
  O_CUT, O_COMMITTED, O_RECS, O_LAG, O_SLOTC, O_COMMIT, O_SNAP,
  NUM_SLOTS
};

struct Args {
  void* p[NUM_SLOTS];
  int P, S, t;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// floor(x / 2) for any int32 x.
__device__ __forceinline__ int floor_div2(int x) {
  const int q = x / 2;
  return (x < 0 && (x & 1)) ? q - 1 : q;
}

// kWide = false: P <= 32, one ballot of the first warp walks the ring.
// kWide = true: any P, the ring's slots in dynamic shared memory and a loop
// of ballots over ceil(P / 32) words; the committed prefix is the sum of
// the leading full words' 32 plus the first gap of the word that breaks.
template <bool kWide>
__global__ void scalog_cut_commit_kernel(const Args a) {
  __shared__ int s_fixed[kMaxP];
  extern __shared__ int s_dyn[];
  int* s_slot = kWide ? s_dyn : s_fixed;
  __shared__ int s_ncommit;
  const int P = a.P;
  const int t = a.t;
  const int lane = threadIdx.x & 31;

  // The [P]-space ring walk (every CTA, first warp).
  if (threadIdx.x < 32) {
    const int cc = *in<int>(a, CC);
    const int nc = *in<int>(a, NC);
    int n = 0;
    bool open = true;
    for (int base = 0; base < (kWide ? P : 1); base += 32) {
      const int i = base + lane;
      bool ok = false;
      if (i < P) {
        const int idx = wadd(cc, i);
        const int slot = floor_mod(idx, P);
        s_slot[i] = slot;
        ok = idx < nc && in<int>(a, COMMIT)[slot] <= t;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      const int run = ballot == 0xffffffffu ? 32 : __ffs(~ballot) - 1;
      if (open) n += run;
      open = open && run == 32;
    }
    if (lane == 0) s_ncommit = n;
  }
  __syncthreads();
  const int n = s_ncommit;

  // Per shard: the newest committed value and the record deltas.
  const int S = a.S;
  const size_t s = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in_range = s < static_cast<size_t>(S);
  const int* vec = in<int>(a, VEC);
  int* recs = out<int>(a, O_RECS);
  int prev = in_range ? in<int>(a, LAST)[s] : 0;
  for (int i = 0; i < n; ++i) {
    const int v = in_range ? vec[static_cast<size_t>(s_slot[i]) * S + s] : prev;
    const unsigned d = __reduce_add_sync(
        0xffffffffu, static_cast<unsigned>(wsub(v, prev)));
    if (lane == 0 && d != 0u) atomicAdd(&recs[i], static_cast<int>(d));
    prev = v;
  }
  if (in_range) out<int>(a, O_CUT)[s] = prev;

  // The [P]-space outputs, from CTA 0.
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const bool committed = i < n;
    int lag = 0;
    if (committed) {
      const int snap = in<int>(a, SNAP)[s_slot[i]];
      const int prev_snap = in<int>(a, PREV)[s_slot[i]];
      lag = wadd(wsub(t, snap), floor_div2(wadd(wsub(snap, prev_snap), 1)));
    }
    out<uint8_t>(a, O_COMMITTED)[i] = committed;
    out<int>(a, O_LAG)[i] = lag;
    // Ring slot j = i: committed iff the cut of the issue order that lives
    // there is (the last such cut, as the Pallas kernel's where-chain).
    const int j = i;
    bool sc = false;
    for (int k = 0; k < P; ++k) {
      if (s_slot[k] == j) sc = k < n;
    }
    out<uint8_t>(a, O_SLOTC)[j] = sc;
    out<int>(a, O_COMMIT)[j] = sc ? kInf : in<int>(a, COMMIT)[j];
    out<int>(a, O_SNAP)[j] = sc ? kInf : in<int>(a, SNAP)[j];
  }
}

// A kernel that does nothing: the launch floor of the cut-commit launch.
__global__ void scalog_empty_kernel(const Args) {}

// Zero recs on the stream, then run the grid over shards: the cut-commit
// kernel, or (empty) the empty kernel on the same grid.
int launch(void* const* ptrs, const int* ints, void* stream, bool empty) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.P = ints[0];
  a.S = ints[1];
  a.t = ints[2];
  const int threads = ints[3];
  if (a.P < 1 || a.S < 0) return cudaErrorInvalidValue;
  if (threads < 32 || threads > 1024 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a.p[O_RECS], 0, sizeof(int) * a.P, st);
  if (err != cudaSuccess) return err;
  size_t blocks = (static_cast<size_t>(a.S) + threads - 1) / threads;
  if (blocks == 0) blocks = 1;  // CTA 0 writes the [P]-space outputs
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  if (empty) {
    scalog_empty_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(a);
  } else if (a.P <= kMaxP) {
    scalog_cut_commit_kernel<false>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(a);
  } else {
    const size_t shmem = sizeof(int) * static_cast<size_t>(a.P);
    if (shmem > 227 * 1024) return cudaErrorInvalidValue;
    if (shmem > 48 * 1024) {
      cudaFuncSetAttribute(scalog_cut_commit_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shmem));
    }
    scalog_cut_commit_kernel<true>
        <<<static_cast<unsigned>(blocks), threads, shmem, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_scalog_num_slots() { return NUM_SLOTS; }

// Launch the cut-commit kernel: zero recs on the stream, then run the grid
// over shards. ptrs holds NUM_SLOTS device pointers; ints = {P, S, t,
// threads per block}. P <= 32 runs the one-ballot kernel, any larger P the
// wide one; threads must be a multiple of 32. Returns the CUDA error of the
// launch (0 = launched). Does not synchronise.
int fpx_scalog_launch(void* const* ptrs, const int* ints, void* stream) {
  return launch(ptrs, ints, stream, false);
}

// The launch floor of fpx_scalog_launch on the same arguments: the same
// memset of recs and a grid of the same shape, running a kernel that does
// nothing (the least time any launch of this plane can take). It writes
// only recs.
int fpx_scalog_floor_launch(void* const* ptrs, const int* ints, void* stream) {
  return launch(ptrs, ints, stream, true);
}

}  // extern "C"
