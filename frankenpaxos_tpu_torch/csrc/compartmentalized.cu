// Hand-written Hopper (sm_90a) kernels for the Compartmentalized MultiPaxos
// acceptor grid: the fused grid vote, and its six-pass twin (at the end of
// this file).
//
//   fpx_cz_grid_vote  replaces fused_grid_vote
//                     (frankenpaxos_tpu/ops/compartmentalized.py:289,
//                     pallas_call at :345): in one pass over the [R,C,G,W]
//                     grid and the [NR,G,W] replica plane, offset-clock
//                     aging, column-transversal votes (Phase2b min-write),
//                     every-row-voted chosen detection gated on the slot's
//                     proxy, the commit broadcast and each replica's
//                     executed watermark, and the full-grid retry.
//
// It computes exactly what reference_grid_vote in
// frankenpaxos_tpu_torch/ops/compartmentalized.py computes, bit for bit
// (integer work only; see common.cuh). Order inside the pass, as in the
// plain version: the grid cells are aged once; a vote reads the AGED p2a;
// the status turns CHOSEN before the replicas are armed, so a slot armed
// this tick (latency >= 1) is not yet ready; the watermark and the retry
// read the updated status; a retry OVERWRITES the aged p2a of the cells it
// reaches. As in JAX, the replica watermark's live range tests the ring
// position w (not its ordinal) against next - head.
//
// Design. One thread per (g, w) ring slot; blockDim = (W, gpb) holds gpb =
// max(1, 256 / W) whole groups, the layout of multipaxos.cu. The R x C grid
// cells and the NR replicas are runtime register loops (a few each): the
// aged p2a of each cell is stored at once, and a timed-out slot's retry
// stores its cells again, so no per-cell state outlives its loop. The
// per-replica first gap (a min over W) is a warp reduction when W % 32 ==
// 0 (at the main shape W = 32 a group is one warp), else one shared atomic
// per thread; the watermark is written after one barrier. Latencies and
// delivery masks are read only where they are used: p2b_lat / p2b_del at
// cells that vote now, rep_lat where a slot is newly chosen, retry_lat /
// retry_del at the cells of a timed-out slot. The grid's ragged edge is
// masked per thread; masked threads still reach the barrier. For W > 1024
// a general kernel runs one CTA per group with a block-stride loop over
// the W slots and the same per-slot body; its per-replica min over W is a
// full-warp reduction at every step, exact in any order.
//
// Bound. A few integer ops per byte: bound by the bytes moved. At the main
// shape (R, C, NR, G, W) = (2, 2, 3, 25000, 32), with every input read
// once: per grid cell 18 B (p2a, p2b in and out at 2 B, two uint8 masks,
// two int32 latencies), per replica cell 8 B, per slot 21 B: about 117 B
// per ring slot, ~94 MB a launch, ~28 us at 3.35 TB/s.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kProposed = 1;
constexpr int kChosen = 2;

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/compartmentalized.py, _PTR_SLOTS).
enum Slot {
  P2A, P2B, REP, STATUS, LS, REP_EXEC, HEAD, NEXT,
  ALIVE, P2B_DEL, RETRY_DEL, P2B_LAT, RETRY_LAT, REP_LAT,
  O_P2A, O_P2B, O_REP, O_STATUS, O_LS, O_REP_EXEC,
  O_NEWLY, O_TIMED, O_VOTES, O_DROPPED,
  NUM_SLOTS
};

struct Args {
  void* p[NUM_SLOTS];
  int R, C, NR, G, W, t, retry_timeout, gpb;
};

// Typed views of a pointer slot (of Args, or of the six passes' UfArgs).
template <typename T, typename A>
__device__ __forceinline__ const T* in(const A& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T, typename A>
__device__ __forceinline__ T* out(const A& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// One ring slot (g, w): aging, votes, the choose, the commit broadcast,
// the retry. `valid` is false for the threads past the grid's edge (or the
// ring's, in the general kernel): they still take part in the per-replica
// gap reduction, with the neutral value W. s_gap points at the group's
// first gap slot; replica n's is s_gap[n * stride].
__device__ __forceinline__ void grid_vote_slot(const Args& a, int g, int w,
                                               bool valid, int* s_gap,
                                               int stride, bool aligned) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t gw = static_cast<size_t>(g) * a.W + w;
  int head = 0, next = 0, ls = 0;
  int8_t status = 0;
  bool alive = false, quorum = true;
  int votes = 0, dropped = 0;
  if (valid) {
    head = in<int>(a, HEAD)[g];
    next = in<int>(a, NEXT)[g];
    status = in<int8_t>(a, STATUS)[gw];
    ls = in<int>(a, LS)[gw];
    alive = in<uint8_t>(a, ALIVE)[gw] != 0;
    // Aging, votes and the every-row quorum, cell by cell.
    for (int r = 0; r < a.R; ++r) {
      bool row_any = false;
      for (int c = 0; c < a.C; ++c) {
        const size_t i = static_cast<size_t>(r * a.C + c) * GW + gw;
        const int16_t p2a = age_clock(in<int16_t>(a, P2A)[i]);
        int16_t p2b = age_clock(in<int16_t>(a, P2B)[i]);
        if (p2a == 0) {
          ++votes;
          if (in<uint8_t>(a, P2B_DEL)[i]) {
            const int16_t lat = static_cast<int16_t>(in<int>(a, P2B_LAT)[i]);
            if (lat < p2b) p2b = lat;
          } else {
            ++dropped;
          }
        }
        row_any = row_any || p2b <= 0;
        out<int16_t>(a, O_P2A)[i] = p2a;
        out<int16_t>(a, O_P2B)[i] = p2b;
      }
      quorum = quorum && row_any;
    }
  }
  const bool newly = valid && status == kProposed && quorum && alive;
  if (newly) status = kChosen;
  const bool chosen = status == kChosen;

  // Commit broadcast and the per-replica first gap of the arrived prefix.
  const int ord = floor_mod(wsub(w, head), a.W);
  const bool live = w < wsub(next, head);
  for (int n = 0; n < a.NR; ++n) {
    int gap = a.W;
    if (valid) {
      const size_t i = static_cast<size_t>(n) * GW + gw;
      int16_t rep = age_clock(in<int16_t>(a, REP)[i]);
      if (newly) rep = static_cast<int16_t>(in<int>(a, REP_LAT)[i]);
      out<int16_t>(a, O_REP)[i] = rep;
      gap = (chosen && rep <= 0 && live) ? a.W : ord;
    }
    group_min(&s_gap[n * stride], gap, aligned);
  }

  // Retry: a timed-out PROPOSED slot re-sends Phase2a to the full grid.
  const bool timed = valid && status == kProposed &&
                     wsub(a.t, ls) >= a.retry_timeout && alive;
  if (timed) {
    for (int rc = 0; rc < a.R * a.C; ++rc) {
      const size_t i = static_cast<size_t>(rc) * GW + gw;
      if (in<uint8_t>(a, RETRY_DEL)[i]) {
        out<int16_t>(a, O_P2A)[i] = static_cast<int16_t>(in<int>(a, RETRY_LAT)[i]);
      }
    }
    ls = a.t;
  }
  if (valid) {
    out<int8_t>(a, O_STATUS)[gw] = status;
    out<int>(a, O_LS)[gw] = ls;
    out<uint8_t>(a, O_NEWLY)[gw] = newly;
    out<uint8_t>(a, O_TIMED)[gw] = timed;
    out<int>(a, O_VOTES)[gw] = votes;
    out<int>(a, O_DROPPED)[gw] = dropped;
  }
}

// Each replica's executed watermark of group g, after the barrier.
__device__ __forceinline__ void store_watermarks(const Args& a, int g,
                                                 const int* s_gap,
                                                 int stride) {
  const int head = in<int>(a, HEAD)[g];
  for (int n = 0; n < a.NR; ++n) {
    const size_t ng = static_cast<size_t>(n) * a.G + g;
    const int mark = wadd(head, s_gap[n * stride]);
    const int old = in<int>(a, REP_EXEC)[ng];
    out<int>(a, O_REP_EXEC)[ng] = old > mark ? old : mark;
  }
}

// Shared memory: the first gap of each (replica, group), [NR][gpb].
__global__ void grid_vote_kernel(const Args a) {
  extern __shared__ int s_gap[];
  const int w = threadIdx.x;
  const int gi = threadIdx.y;
  const int g = blockIdx.x * a.gpb + gi;
  const bool valid = g < a.G;
  if (w == 0) {
    for (int n = 0; n < a.NR; ++n) s_gap[n * a.gpb + gi] = INT_MAX;
  }
  __syncthreads();
  grid_vote_slot(a, g, w, valid, s_gap + gi, a.gpb, (a.W & 31) == 0);
  __syncthreads();
  if (valid && w == 0) store_watermarks(a, g, s_gap + gi, a.gpb);
}

// The general instantiation, for W > 1024: one CTA per group, a
// block-stride loop over its W slots. Every thread runs the same number of
// steps, so each step's gap reduction is a full-warp one (the block is a
// multiple of 32 threads inside one group); a min does not depend on the
// order of the steps.
__global__ void grid_vote_any(const Args a) {
  extern __shared__ int s_gap[];
  const int g = blockIdx.x;
  for (int n = threadIdx.x; n < a.NR; n += blockDim.x) s_gap[n] = INT_MAX;
  __syncthreads();
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    grid_vote_slot(a, g, w, w < a.W, s_gap, 1, true);
  }
  __syncthreads();
  if (threadIdx.x == 0) store_watermarks(a, g, s_gap, 1);
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_cz_num_slots() { return NUM_SLOTS; }

// Launch the grid-vote kernel. ptrs holds NUM_SLOTS device pointers;
// ints = {R, C, NR, G, W, t, retry_timeout, gpb}. W * gpb <= 1024 runs one
// thread per slot, any larger W the general kernel (one CTA per group).
// Returns the CUDA error of the launch (0 = launched). Does not
// synchronise.
int fpx_cz_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.R = ints[0];
  a.C = ints[1];
  a.NR = ints[2];
  a.G = ints[3];
  a.W = ints[4];
  a.t = ints[5];
  a.retry_timeout = ints[6];
  a.gpb = ints[7];
  if (a.G <= 0) return 0;
  if (a.R <= 0 || a.C <= 0 || a.NR <= 0 || a.W <= 0 || a.gpb <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shmem = sizeof(int) * static_cast<size_t>(a.NR) * a.gpb;
  if (static_cast<long long>(a.W) * a.gpb <= 1024 && shmem <= 48 * 1024) {
    const dim3 block(a.W, a.gpb);
    const dim3 grid((a.G + a.gpb - 1) / a.gpb);
    grid_vote_kernel<<<grid, block, shmem, st>>>(a);
  } else {
    const size_t shmem_any = sizeof(int) * static_cast<size_t>(a.NR);
    if (shmem_any > 48 * 1024) return cudaErrorInvalidValue;
    int threads = ((a.W + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    grid_vote_any<<<a.G, threads, shmem_any, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The six-pass twin.
//
//   fpx_czu_launch  replaces unfused_grid_vote
//                   (frankenpaxos_tpu/ops/compartmentalized.py:497,
//                   pallas_calls at :528, :545, :558, :574, :589, :605):
//                   the work of fpx_cz_grid_vote in six kernels, launched
//                   in order by the wrapper (unfused_grid_vote in
//                   frankenpaxos_tpu_torch/ops/compartmentalized.py):
//     pass (which)  does
//     1 age (0)     the three clock planes, aged into a_p2a, a_p2b, a_rep;
//     2 vote (1)    the Phase2b min-write on the aged planes -> o_p2b;
//     3 counts (2)  the vote mask read again: votes cast and dropped;
//     4 choose (3)  every row voted and a live proxy -> o_status, o_newly;
//     5 replica (4) the commit broadcast and each replica's watermark;
//     6 retry (5)   the re-send on the AGED p2a, with the chosen status.
//
// Each pass computes what the plain pass of the same name computes
// (_uf_age ... _uf_retry), bit for bit. It reads its inputs from device
// memory and writes its outputs there, and keeps nothing across passes:
// the kernel exists to be raced against the fused one, whose gain is the
// round trips of the [R,C,G,W] planes that these passes make.
//
// Design. One thread per (g, w) ring slot, looping over the R x C cells or
// the NR replicas as the Pallas pass bodies do. Passes 1-4 and 6 are
// elementwise over the slots: a flat grid of 256-thread CTAs over G * W,
// any W. The replica pass needs each replica's first gap, a minimum over a
// group's W slots: it runs as the fused kernel's watermark does, gpb whole
// groups per CTA with a warp or shared-atomic minimum (W <= 1024), or one
// CTA per group with a block-stride loop over W (W > 1024). Masks and
// latencies are read only where used, as in the fused kernel.
//
// Bound. Bytes: every pass reads and writes its planes once. At the main
// shape (R, C, NR, G, W) = (2, 2, 3, 25000, 32), with every byte counted:
// age 35.2 MB, vote 35.2, counts 16.0, choose 9.6, replica 21.6, retry
// 37.6: ~155 MB, against the fused kernel's ~94 MB. Without the bytes the
// passes skip (the masks and latencies above, a row's cells after its
// first vote in the choose pass), the seeded inputs of chip_smoke.py need
// ~113 MB, ~34 us at 3.35 TB/s, against the fused kernel's ~58 MB.

namespace {

// Pointer slots of UfArgs. The Python wrapper fills the same order
// (_UF_PTR_SLOTS): the inputs, the aged planes, the outputs.
enum UfSlot {
  U_P2A, U_P2B, U_REP, U_STATUS, U_LS, U_REP_EXEC, U_HEAD, U_NEXT,
  U_ALIVE, U_P2B_DEL, U_RETRY_DEL, U_P2B_LAT, U_RETRY_LAT, U_REP_LAT,
  U_A_P2A, U_A_P2B, U_A_REP,
  U_O_P2A, U_O_P2B, U_O_REP, U_O_STATUS, U_O_LS, U_O_REP_EXEC,
  U_O_NEWLY, U_O_TIMED, U_O_VOTES, U_O_DROPPED,
  UF_NUM_SLOTS
};

struct UfArgs {
  void* p[UF_NUM_SLOTS];
  int R, C, NR, G, W, t, retry_timeout, gpb;
};

constexpr int kUfThreads = 256;

__device__ __forceinline__ size_t uf_slots(const UfArgs& a) {
  return static_cast<size_t>(a.G) * a.W;
}
__device__ __forceinline__ size_t uf_slot() {
  return static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Pass 1, age: clock aging.
__global__ void uf_age(const UfArgs a) {
  const size_t GW = uf_slots(a), gw = uf_slot();
  if (gw >= GW) return;
  for (int rc = 0; rc < a.R * a.C; ++rc) {
    const size_t i = static_cast<size_t>(rc) * GW + gw;
    out<int16_t>(a, U_A_P2A)[i] = age_clock(in<int16_t>(a, U_P2A)[i]);
    out<int16_t>(a, U_A_P2B)[i] = age_clock(in<int16_t>(a, U_P2B)[i]);
  }
  for (int n = 0; n < a.NR; ++n) {
    const size_t i = static_cast<size_t>(n) * GW + gw;
    out<int16_t>(a, U_A_REP)[i] = age_clock(in<int16_t>(a, U_REP)[i]);
  }
}

// Pass 2, vote: acceptors whose aged Phase2a arrives now vote (min-write
// where the vote is delivered).
__global__ void uf_vote(const UfArgs a) {
  const size_t GW = uf_slots(a), gw = uf_slot();
  if (gw >= GW) return;
  for (int rc = 0; rc < a.R * a.C; ++rc) {
    const size_t i = static_cast<size_t>(rc) * GW + gw;
    int16_t p2b = in<int16_t>(a, U_A_P2B)[i];
    if (in<int16_t>(a, U_A_P2A)[i] == 0 && in<uint8_t>(a, U_P2B_DEL)[i]) {
      const int16_t lat = static_cast<int16_t>(in<int>(a, U_P2B_LAT)[i]);
      if (lat < p2b) p2b = lat;
    }
    out<int16_t>(a, U_O_P2B)[i] = p2b;
  }
}

// Pass 3, counts: votes cast and dropped per slot.
__global__ void uf_counts(const UfArgs a) {
  const size_t GW = uf_slots(a), gw = uf_slot();
  if (gw >= GW) return;
  int votes = 0, dropped = 0;
  for (int rc = 0; rc < a.R * a.C; ++rc) {
    const size_t i = static_cast<size_t>(rc) * GW + gw;
    if (in<int16_t>(a, U_A_P2A)[i] == 0) {
      ++votes;
      if (!in<uint8_t>(a, U_P2B_DEL)[i]) ++dropped;
    }
  }
  out<int>(a, U_O_VOTES)[gw] = votes;
  out<int>(a, U_O_DROPPED)[gw] = dropped;
}

// Pass 4, choose: chosen when every row has a vote in, collected by a
// live proxy.
__global__ void uf_choose(const UfArgs a) {
  const size_t GW = uf_slots(a), gw = uf_slot();
  if (gw >= GW) return;
  bool quorum = true;
  for (int r = 0; r < a.R; ++r) {
    bool row_any = false;
    for (int c = 0; c < a.C; ++c) {
      const size_t i = static_cast<size_t>(r * a.C + c) * GW + gw;
      row_any = row_any || in<int16_t>(a, U_O_P2B)[i] <= 0;
    }
    quorum = quorum && row_any;
  }
  const int8_t status = in<int8_t>(a, U_STATUS)[gw];
  const bool newly =
      status == kProposed && quorum && in<uint8_t>(a, U_ALIVE)[gw] != 0;
  out<int8_t>(a, U_O_STATUS)[gw] = newly ? static_cast<int8_t>(kChosen) : status;
  out<uint8_t>(a, U_O_NEWLY)[gw] = newly;
}

// Pass 5, replica, one slot: arm the commit broadcast at a newly-chosen
// slot and fold the slot into each replica's first gap (as grid_vote_slot
// does).
__device__ __forceinline__ void uf_replica_slot(const UfArgs& a, int g, int w,
                                                bool valid, int* s_gap,
                                                int stride, bool aligned) {
  const size_t GW = uf_slots(a);
  const size_t gw = static_cast<size_t>(g) * a.W + w;
  bool newly = false, chosen = false, live = false;
  int ord = 0;
  if (valid) {
    const int head = in<int>(a, U_HEAD)[g];
    newly = in<uint8_t>(a, U_O_NEWLY)[gw] != 0;
    chosen = in<int8_t>(a, U_O_STATUS)[gw] == kChosen;
    ord = floor_mod(wsub(w, head), a.W);
    live = w < wsub(in<int>(a, U_NEXT)[g], head);
  }
  for (int n = 0; n < a.NR; ++n) {
    int gap = a.W;
    if (valid) {
      const size_t i = static_cast<size_t>(n) * GW + gw;
      int16_t rep = in<int16_t>(a, U_A_REP)[i];
      if (newly) rep = static_cast<int16_t>(in<int>(a, U_REP_LAT)[i]);
      out<int16_t>(a, U_O_REP)[i] = rep;
      gap = (chosen && rep <= 0 && live) ? a.W : ord;
    }
    group_min(&s_gap[n * stride], gap, aligned);
  }
}

__device__ __forceinline__ void uf_store_watermarks(const UfArgs& a, int g,
                                                    const int* s_gap,
                                                    int stride) {
  const int head = in<int>(a, U_HEAD)[g];
  for (int n = 0; n < a.NR; ++n) {
    const size_t ng = static_cast<size_t>(n) * a.G + g;
    const int mark = wadd(head, s_gap[n * stride]);
    const int old = in<int>(a, U_REP_EXEC)[ng];
    out<int>(a, U_O_REP_EXEC)[ng] = old > mark ? old : mark;
  }
}

// Pass 5, W <= 1024: blockDim = (W, gpb), gpb whole groups per CTA.
__global__ void uf_replica(const UfArgs a) {
  extern __shared__ int s_gap[];
  const int w = threadIdx.x;
  const int gi = threadIdx.y;
  const int g = blockIdx.x * a.gpb + gi;
  const bool valid = g < a.G;
  if (w == 0) {
    for (int n = 0; n < a.NR; ++n) s_gap[n * a.gpb + gi] = INT_MAX;
  }
  __syncthreads();
  uf_replica_slot(a, g, w, valid, s_gap + gi, a.gpb, (a.W & 31) == 0);
  __syncthreads();
  if (valid && w == 0) uf_store_watermarks(a, g, s_gap + gi, a.gpb);
}

// Pass 5, W > 1024: one CTA per group, a block-stride loop over W (every
// thread runs the same steps, so each step's minimum is a full-warp one).
__global__ void uf_replica_any(const UfArgs a) {
  extern __shared__ int s_gap[];
  const int g = blockIdx.x;
  for (int n = threadIdx.x; n < a.NR; n += blockDim.x) s_gap[n] = INT_MAX;
  __syncthreads();
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    uf_replica_slot(a, g, w, w < a.W, s_gap, 1, true);
  }
  __syncthreads();
  if (threadIdx.x == 0) uf_store_watermarks(a, g, s_gap, 1);
}

// Pass 6, retry: a timed-out PROPOSED slot re-sends Phase2a to the full
// grid, overwriting the aged clock where the re-send is delivered.
__global__ void uf_retry(const UfArgs a) {
  const size_t GW = uf_slots(a), gw = uf_slot();
  if (gw >= GW) return;
  const int ls = in<int>(a, U_LS)[gw];
  const bool timed = in<int8_t>(a, U_O_STATUS)[gw] == kProposed &&
                     wsub(a.t, ls) >= a.retry_timeout &&
                     in<uint8_t>(a, U_ALIVE)[gw] != 0;
  for (int rc = 0; rc < a.R * a.C; ++rc) {
    const size_t i = static_cast<size_t>(rc) * GW + gw;
    int16_t p2a = in<int16_t>(a, U_A_P2A)[i];
    if (timed && in<uint8_t>(a, U_RETRY_DEL)[i]) {
      p2a = static_cast<int16_t>(in<int>(a, U_RETRY_LAT)[i]);
    }
    out<int16_t>(a, U_O_P2A)[i] = p2a;
  }
  out<int>(a, U_O_LS)[gw] = timed ? a.t : ls;
  out<uint8_t>(a, U_O_TIMED)[gw] = timed;
}

}  // namespace

extern "C" {

// Number of pointer slots of the six passes (a layout check).
int fpx_czu_num_slots() { return UF_NUM_SLOTS; }

// Launch pass `which` (0 age, 1 vote, 2 counts, 3 choose, 4 replica,
// 5 retry) of the six-pass grid vote. ptrs holds UF_NUM_SLOTS device
// pointers; ints = {R, C, NR, G, W, t, retry_timeout, gpb}, gpb the groups
// per CTA of the replica pass. Returns the CUDA error of the launch (0 =
// launched). Does not synchronise.
int fpx_czu_launch(int which, void* const* ptrs, const int* ints,
                   void* stream) {
  UfArgs a;
  for (int i = 0; i < UF_NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.R = ints[0];
  a.C = ints[1];
  a.NR = ints[2];
  a.G = ints[3];
  a.W = ints[4];
  a.t = ints[5];
  a.retry_timeout = ints[6];
  a.gpb = ints[7];
  if (which < 0 || which > 5) return cudaErrorInvalidValue;
  if (a.G <= 0) return 0;
  if (a.R <= 0 || a.C <= 0 || a.NR <= 0 || a.W <= 0 || a.gpb <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t slots = static_cast<size_t>(a.G) * a.W;
  const size_t ctas = (slots + kUfThreads - 1) / kUfThreads;
  if (ctas > static_cast<size_t>(INT_MAX)) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(ctas));
  switch (which) {
    case 0: uf_age<<<grid, kUfThreads, 0, st>>>(a); break;
    case 1: uf_vote<<<grid, kUfThreads, 0, st>>>(a); break;
    case 2: uf_counts<<<grid, kUfThreads, 0, st>>>(a); break;
    case 3: uf_choose<<<grid, kUfThreads, 0, st>>>(a); break;
    case 4: {
      const size_t shmem = sizeof(int) * static_cast<size_t>(a.NR) * a.gpb;
      if (static_cast<long long>(a.W) * a.gpb <= 1024 && shmem <= 48 * 1024) {
        const dim3 block(a.W, a.gpb);
        uf_replica<<<(a.G + a.gpb - 1) / a.gpb, block, shmem, st>>>(a);
      } else {
        const size_t shmem_any = sizeof(int) * static_cast<size_t>(a.NR);
        if (shmem_any > 48 * 1024) return cudaErrorInvalidValue;
        int threads = ((a.W + 31) / 32) * 32;
        if (threads > 256) threads = 256;
        uf_replica_any<<<a.G, threads, shmem_any, st>>>(a);
      }
      break;
    }
    default: uf_retry<<<grid, kUfThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // extern "C"
