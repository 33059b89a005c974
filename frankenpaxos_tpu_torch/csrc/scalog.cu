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
// Two routes; the wrapper picks one (ops/scalog.py scalog_cut_commit_route)
// and the launcher refuses a route whose conditions fail.
//
// The cluster route (P <= 16 and at most one_max_shards shards: one launch).
// One thread-block cluster of up to kMaxCluster CTAs, each thread kSpt
// shards. Every load is issued in one trip before any of it is used: the
// two 0-d counters, the P commit ticks in ring order (lane j loads slot j;
// they do not depend on committed_cuts), the snapshot ticks (warp 0 of CTA 0), last_committed_cut
// of its shards and all P ring rows of its shards (4 P bytes a shard).
// The record counts telescope: the deltas of issue order i sum to X_i -
// X_(i-1), X a ring row's sum over shards (X_(-1) last_committed_cut's),
// in wrapping int32 as any order of integer adds gives. So the threads sum
// each ring row, whichever cuts commit, and no work waits on the ring
// walk but the newest cut's projection. Each warp walks the ring in
// registers: lane i takes issue order i, fetches its slot's commit tick
// from lane (committed_cuts + i) mod P by a shuffle, and a ballot gives the
// committed prefix; no barrier stands before any load. The row sums meet
// in shared memory: a warp reduction each, the CTA's warps, then each
// CTA's sums stored into CTA 0's shared memory across the cluster
// (distributed shared memory), one cluster barrier, and CTA 0's first warp
// takes the differences into recs. No memset: recs is written once, by one
// warp. The same warp writes the [P]-space outputs from registers (the
// slot map by shuffles, no P x P loop over global loads). The cluster's
// few SMs issue all of it: on an NVIDIA H100 80GB HBM3 at 700 W
// (harness/chain_race.py), cold, 0.0081 ms against the general route's
// 0.0093 at (P, S) = (8, 10000), but 0.0087 against 0.0084 at (8, 16384)
// and 0.0094 against 0.0088 at (32, 2500), so the wrapper picks it only
// up to 12,000 shards and 16 cuts (ops/scalog.py scalog_cut_commit_route).

// The general route (any P; the kernel as first written). The grid runs
// over shards, one thread per shard s, after a memset of recs. The
// [P]-space ring walk is recomputed by the first warp of every CTA from
// the P commit ticks (one lane per cut, a warp ballot for the committed
// prefix) into shared memory; for P > 32 a wide instantiation keeps the
// ring's slots in dynamic shared memory and loops its ballot over
// ceil(P / 32) words. Each thread then walks the committed prefix: it reads
// the committing cuts' values of its shard, writes the newest one (or
// last_committed_cut) to new_cut[s], and adds vec_i[s] - prev_i[s] into
// recs[i]: a warp-shuffle reduction, then one int32 atomicAdd per warp and
// committed cut. CTA 0 writes the [P]-space outputs.
//
// Bound. Bytes: the committing cuts' rows (4 B per shard each),
// last_committed_cut in and new_cut out (8 B per shard), and ~30 B per ring
// slot. At (P, S) = (8, 10000) with every cut committing, 0.40 MB: 0.12 us
// at 3.35 TB/s. No launch is that short, so the time a launch takes is the
// floor: fpx_scalog_one_floor_launch runs the route's launch shape with a
// kernel that does nothing, fpx_scalog_floor_launch the general route's
// memset and grid.

#include <climits>

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------------
// The cluster route (P <= kClusterMaxP).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterMaxP = 16;  // cuts in flight a thread's rows hold
constexpr int kSpt = 2;           // shards a thread, loaded in one trip
constexpr int kMaxCluster = 8;    // CTAs of the cluster (the portable most)
constexpr int kMinThreads = 128;  // a CTA's shards before a second CTA
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

// A CTA's most threads for kRows rows a shard: the registers of 2 * kRows
// row values and kRows sums a thread stay unspilled (64 a thread at 1024).
__host__ __device__ constexpr int one_max_threads(int rows) {
  return rows <= 8 ? 1024 : 512;
}

// A load of trip 1, issued where it is written: the compiler may not sink
// it into the branch that first uses it (past the ballot, which waits for
// the counters), so every load of the trip is in flight at once. The
// inputs are read-only for the whole launch.
__device__ __forceinline__ int ld_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// kRows >= P: the ring rows a thread holds a shard (8 or 16). The sums
// are by ring slot (sums[j]); warp 0 of CTA 0 takes the differences in
// issue order.
template <int kRows>
__global__ void __launch_bounds__(one_max_threads(kRows))
scalog_one_kernel(const Args a) {
  // Each warp's row sums ([kRows]: last_committed_cut's), each CTA's (in
  // CTA 0, over the cluster) and their total.
  __shared__ unsigned s_warp[kMaxWarps][kRows + 1];
  __shared__ unsigned s_cta[kMaxCluster][kRows + 1];
  __shared__ unsigned s_tot[kRows + 1];
  const int P = a.P, S = a.S, t = a.t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lead = blockIdx.x == 0 && warp == 0;
  const int* __restrict__ vec = in<int>(a, VEC);
  const int* __restrict__ last = in<int>(a, LAST);
  int* __restrict__ cut_out = out<int>(a, O_CUT);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t s0 = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;

  // Trip 1: the counters and ring-order ticks (lane j: slot j).
  const int cc = ld_now(in<int>(a, CC));
  const int nc = ld_now(in<int>(a, NC));
  int c_r = kInf, snap_r = 0, prev_r = 0;
  if (lane < P) {
    c_r = ld_now(in<int>(a, COMMIT) + lane);
    if (lead) {
      snap_r = ld_now(in<int>(a, SNAP) + lane);
      prev_r = ld_now(in<int>(a, PREV) + lane);
    }
  }

  unsigned sums[kRows], sum_last = 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) sums[r] = 0u;
  // Trip 1 (the rest): the thread's shards and their P ring rows.
  size_t sh[kSpt];
  bool ok[kSpt];
  int lst[kSpt], v[kSpt][kRows];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    sh[k] = s0 + k * stride;
    ok[k] = sh[k] < static_cast<size_t>(S);
    lst[k] = ok[k] ? ld_now(last + sh[k]) : 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      v[k][j] = (ok[k] && j < P)
                    ? ld_now(vec + static_cast<size_t>(j) * S + sh[k]) : 0;
    }
  }

  // The ring walk in registers: lane i takes issue order i, its slot's
  // commit tick from lane (committed_cuts + i) mod P.
  const int idx = wadd(cc, lane);
  const int my_slot = lane < P ? floor_mod(idx, P) : 0;
  const int c_i = __shfl_sync(kFull, c_r, my_slot);
  const unsigned b = __ballot_sync(kFull, lane < P && idx < nc && c_i <= t);
  const int n = b == kFull ? 32 : __ffs(~b) - 1;
  const int newest = __shfl_sync(kFull, my_slot, n > 0 ? n - 1 : 0);
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    int cut = lst[k];
    sum_last += static_cast<unsigned>(lst[k]);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      sums[j] += static_cast<unsigned>(v[k][j]);
      // The newest committed cut: ring slot `newest`.
      if (n > 0 && j == newest) cut = v[k][j];
    }
    if (ok[k]) cut_out[sh[k]] = cut;
  }

  // The sums: a warp reduction each, then the CTA's warps, then the CTAs.
#pragma unroll
  for (int r = 0; r <= kRows; ++r) {
    if (r < kRows && r >= P) continue;
    const unsigned sum = __reduce_add_sync(kFull, r < kRows ? sums[r] : sum_last);
    if (lane == 0) s_warp[warp][r] = sum;
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  const int col = threadIdx.x < P ? threadIdx.x : kRows;  // thread P: last's
  unsigned cta = 0;
  if (threadIdx.x <= P) {
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) {
      if (w < warps) cta += s_warp[w][col];
    }
  }
  // Each CTA's sums into CTA 0's shared memory across the cluster, and
  // CTA 0 adds them up into s_tot.
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x <= P) {
    cluster.map_shared_rank(&s_cta[0][0], 0)[blockIdx.x * (kRows + 1) + col] = cta;
  }
  cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x <= P) {
    unsigned sum = 0;
    for (unsigned c = 0; c < gridDim.x; ++c) sum += s_cta[c][col];
    s_tot[col] = sum;
  }
  __syncthreads();

  // recs from the sums and the [P]-space outputs from registers (warp 0
  // of CTA 0): lane i the cut of issue order i, lane j ring slot j.
  if (lead) {
    const int before = __shfl_sync(kFull, my_slot, lane > 0 ? lane - 1 : 0);
    if (lane < P) {
      const unsigned x = s_tot[my_slot];
      const unsigned y = lane == 0 ? s_tot[kRows] : s_tot[before];
      out<int>(a, O_RECS)[lane] = lane < n ? static_cast<int>(x - y) : 0;
    }
    const int snap_i = __shfl_sync(kFull, snap_r, my_slot);
    const int prev_i = __shfl_sync(kFull, prev_r, my_slot);
    // The last issue order that lives in slot `lane`: (lane - cc) mod P,
    // but past INT_MAX (where two cuts share a slot) found by a walk.
    int owner = floor_mod(lane - floor_mod(cc, P), P);
    if (cc > INT_MAX - (P - 1)) {
      owner = -1;
      for (int k = 0; k < P; ++k) {
        if (__shfl_sync(kFull, my_slot, k) == lane) owner = k;
      }
    }
    if (lane < P) {
      const bool committed = lane < n;
      const int lag = committed
          ? wadd(wsub(t, snap_i), floor_div2(wadd(wsub(snap_i, prev_i), 1)))
          : 0;
      out<uint8_t>(a, O_COMMITTED)[lane] = committed;
      out<int>(a, O_LAG)[lane] = lag;
      const bool sc = owner >= 0 && owner < n;
      out<uint8_t>(a, O_SLOTC)[lane] = sc;
      out<int>(a, O_COMMIT)[lane] = sc ? kInf : c_r;
      out<int>(a, O_SNAP)[lane] = sc ? kInf : snap_r;
    }
  }
}

// A kernel that does nothing: the launch floors.
__global__ void scalog_empty_kernel(const Args) {}
__global__ void scalog_one_empty_kernel(const Args) {}

// Route codes (the order of frankenpaxos_tpu_torch/ops/registry.py ROUTES).
enum Route { ROUTE_GENERAL = 1, ROUTE_CLUSTER = 3 };

// The general route: zero recs on the stream, then run the grid over
// shards (the cut-commit kernel, or with `empty` the empty kernel on the
// same grid; with `memset` false the grid alone).
int launch_general(const Args& a, int threads, cudaStream_t st, bool empty,
                   bool memset) {
  if (threads < 32 || threads > 1024 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  if (memset) {
    cudaError_t err = cudaMemsetAsync(a.p[O_RECS], 0, sizeof(int) * a.P, st);
    if (err != cudaSuccess) return err;
  }
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

// The cluster route's most shards for kRows rows: one trip of the whole
// cluster (kSpt shards a thread).
constexpr long long one_max_shards(int rows) {
  return static_cast<long long>(kMaxCluster) * one_max_threads(rows) * kSpt;
}

template <int kRows>
int launch_one_rows(const Args& a, cudaStream_t st, bool empty) {
  // The launch shape: as many CTAs as the shards fill at kMinThreads
  // threads of kSpt shards each (at most the cluster), their threads a
  // whole number of warps.
  if (a.S > one_max_shards(kRows)) return cudaErrorInvalidValue;
  const long long need = (static_cast<long long>(a.S) + kSpt - 1) / kSpt;
  long long ctas = (need + kMinThreads - 1) / kMinThreads;
  ctas = ctas < 1 ? 1 : (ctas > kMaxCluster ? kMaxCluster : ctas);
  long long threads = ((need + ctas - 1) / ctas + 31) / 32 * 32;
  // At least 64: threads 0..P (P <= 16) add up the per-cut sums.
  threads = threads < 64 ? 64 : threads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = empty
      ? cudaLaunchKernelEx(&cfg, scalog_one_empty_kernel, a)
      : cudaLaunchKernelEx(&cfg, scalog_one_kernel<kRows>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The rows a thread holds a shard for P cuts in flight (P <=
// kClusterMaxP): the instantiation of scalog_one_kernel that P takes.
constexpr int one_rows(int P) { return P <= 8 ? 8 : kClusterMaxP; }

// The cluster route (P <= kClusterMaxP, S <= one_max_shards), or with
// `empty` its launch shape running a kernel that does nothing.
int launch_one(const Args& a, cudaStream_t st, bool empty) {
  if (a.P > kClusterMaxP) return cudaErrorInvalidValue;
  return one_rows(a.P) == 8 ? launch_one_rows<8>(a, st, empty)
                            : launch_one_rows<kClusterMaxP>(a, st, empty);
}

enum Which { KERNEL, FLOOR_GENERAL, FLOOR_ONE };

int launch(void* const* ptrs, const int* ints, void* stream, Which which) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.P = ints[0];
  a.S = ints[1];
  a.t = ints[2];
  const int threads = ints[3];
  const int route = ints[4];
  if (a.P < 1 || a.S < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == FLOOR_GENERAL) return launch_general(a, threads, st, true, true);
  const bool empty = which == FLOOR_ONE;
  switch (route) {
    case ROUTE_GENERAL: return launch_general(a, threads, st, empty, !empty);
    case ROUTE_CLUSTER: return launch_one(a, st, empty);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_scalog_num_slots() { return NUM_SLOTS; }

// The most shards the cluster route can take with P cuts in flight (one
// trip of the cluster), 0 for a P it cannot take. ops/scalog.py
// cluster_max_shards mirrors it (the route is chosen without a card), and
// chip_smoke.py holds the two against each other for every P.
int fpx_scalog_cluster_max_shards(int P) {
  if (P < 1 || P > kClusterMaxP) return 0;
  return static_cast<int>(one_max_shards(one_rows(P)));
}

// Launch the cut-commit kernel. ptrs holds NUM_SLOTS device pointers; ints
// = {P, S, t, threads per block of the general route, route}, the route the
// wrapper chose (ops/scalog.py scalog_cut_commit_route): 1 general (zero
// recs on the stream, then the grid over shards; P <= 32 runs the
// one-ballot kernel, any larger P the wide one; threads a multiple of 32),
// 3 cluster (P <= 16 and S at most one trip of the cluster,
// fpx_scalog_cluster_max_shards: one launch of one cluster, refused past
// either).
// Returns the CUDA error of the launch (0 = launched). Does not
// synchronise.
int fpx_scalog_launch(void* const* ptrs, const int* ints, void* stream) {
  return launch(ptrs, ints, stream, KERNEL);
}

// The general route's launch floor on the same arguments: the same memset
// of recs and a grid of the same shape, running a kernel that does nothing.
// It writes only recs.
int fpx_scalog_floor_launch(void* const* ptrs, const int* ints, void* stream) {
  return launch(ptrs, ints, stream, FLOOR_GENERAL);
}

// The one-launch floor of the route in ints: its launch shape (the
// cluster, or the general route's grid without the memset) running a
// kernel that does nothing. It writes nothing.
int fpx_scalog_one_floor_launch(void* const* ptrs, const int* ints,
                                void* stream) {
  return launch(ptrs, ints, stream, FLOOR_ONE);
}

}  // extern "C"
