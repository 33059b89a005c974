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
// full-warp reduction at every step, exact in any order. Where its route
// function allows (ops/compartmentalized.py grid_vote_route), the wrapper
// takes the vector route instead (grid_vote_vec, below: 8 slots a thread,
// 16-byte loads, five trips to memory); these two kernels are the scalar
// and general routes.
//
// Bound. A few integer ops per byte: bound by the bytes moved. At the main
// shape (R, C, NR, G, W) = (2, 2, 3, 25000, 32), with every input read
// once: per grid cell 18 B (p2a, p2b in and out at 2 B, two uint8 masks,
// two int32 latencies), per replica cell 8 B, per slot 21 B: about 117 B
// per ring slot, ~94 MB a launch, ~28 us at 3.35 TB/s; the masks and
// latencies are needed only where used (57.7 MB on the random inputs of
// chip_smoke.py, ~17 us: ops/compartmentalized.py grid_vote_needed_bytes).

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

// ---------------------------------------------------------------------------
// The vector route (W % 8 == 0, W <= 1024, R * C <= 4, NR <= 4, every
// plane 16-byte aligned). A thread owns 8 consecutive slots of one group:
// blockDim = (W / 8, gpb). Its memory traffic goes in a few trips, each a
// batch of independent loads that overlap:
//   1. unconditional: its clocks of every grid cell (16 bytes each), its
//      send ticks, 8 bytes of status and of proxy liveness, the group's
//      ring bounds;
//   2. p2b_del at the cells where one of its slots votes;
//   3. p2b_lat where a vote is delivered;
//   4. its replica clocks, rep_lat where a slot is newly chosen, retry_del
//      where one times out;
//   5. only where a re-send lands: retry_lat, and the aged p2a row it
//      overwrites (stored after trip 1, read back).
// A sparse read takes the thread's 8-lane row of its plane (a latency row
// is one 32-byte sector: two 16-byte loads, either half read only where a
// lane of it needs the value): the same sectors from device memory as a
// load per lane, a few instructions instead of eight. The lane work runs
// two int16 lanes a 32-bit word with per-halfword SIMD ops, lane masks in
// the same layout (0xffff where set). The per-replica first gap is the
// thread's min over its 8 slots, then (kShfl: W / 8 a power of two that
// divides 32, the block's warps full) a shuffle-min over the group's W / 8
// lanes, else one shared atomic per thread and a barrier.
// ---------------------------------------------------------------------------

// Grid cells, and replicas, whose rows a thread holds (the route's limit).
constexpr int kMaxRows = 4;

template <bool kShfl>
__global__ void __launch_bounds__(256, 2) grid_vote_vec(const Args a) {
  extern __shared__ int s_gap[];  // [NR][gpb], without kShfl only
  const int per_group = a.W / 8;
  const int x = threadIdx.x;
  const int gi = threadIdx.y;
  const int g = blockIdx.x * a.gpb + gi;
  const bool valid = g < a.G;
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const int w0 = x * 8;
  const size_t gw = static_cast<size_t>(g) * a.W + w0;
  const int RC = a.R * a.C;
  if (!kShfl) {
    if (x == 0) {
      for (int n = 0; n < a.NR; ++n) s_gap[n * a.gpb + gi] = INT_MAX;
    }
    __syncthreads();
  }

  // Trip 1; the aged p2a is stored at once.
  int head = 0, next = 0;
  V8 st, alive;
  st.u = alive.u = make_uint2(0, 0);
  V16 ls[2], pa[kMaxRows], pb[kMaxRows];
  ls[0].u = ls[1].u = make_uint4(0, 0, 0, 0);
  if (valid) {
    head = in<int>(a, HEAD)[g];
    next = in<int>(a, NEXT)[g];
    st = ld8(in<int8_t>(a, STATUS) + gw);
    alive = ld8(in<uint8_t>(a, ALIVE) + gw);
    ls[0] = ld16(in<int>(a, LS) + gw);
    ls[1] = ld16(in<int>(a, LS) + gw + 4);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < RC) {
        pa[j] = ld16(in<int16_t>(a, P2A) + j * GW + gw);
        pb[j] = ld16(in<int16_t>(a, P2B) + j * GW + gw);
      }
    }
  }
  unsigned prop[4], live_proxy[4], due[4];
  {
    V8 p;
    p.u.x = __vcmpeq4(st.u.x, 0x01010101u);  // kProposed
    p.u.y = __vcmpeq4(st.u.y, 0x01010101u);
    byte_masks(prop, p);
    byte_masks(live_proxy, alive);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool d0 = wsub(a.t, lane32(ls, 2 * k)) >= a.retry_timeout;
    const bool d1 = wsub(a.t, lane32(ls, 2 * k + 1)) >= a.retry_timeout;
    due[k] = (d0 ? 0x0000ffffu : 0u) | (d1 ? 0xffff0000u : 0u);
    due[k] &= prop[k] & live_proxy[k];
    if (!valid) due[k] = 0;
  }
  bool vote_any[kMaxRows];
  unsigned votes[4] = {0, 0, 0, 0}, dropped[4] = {0, 0, 0, 0};
  unsigned vote[kMaxRows][4];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    vote_any[j] = false;
    if (!valid || j >= RC) continue;
    unsigned o = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pa[j].w[k] = age2(pa[j].w[k]);
      pb[j].w[k] = age2(pb[j].w[k]);
      vote[j][k] = __vcmpeq2(pa[j].w[k], 0u);
      votes[k] += vote[j][k] & 0x00010001u;
      o |= vote[j][k];
    }
    vote_any[j] = o != 0;
    st16(out<int16_t>(a, O_P2A) + j * GW + gw, pa[j]);
  }

  // Trip 2: p2b_del where a slot votes, a byte at each voting slot (one
  // 8-byte load of the cell's 8 bytes lost to it on the card, PERF.md).
  unsigned del[kMaxRows][4];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) del[j][k] = 0;
    if (!valid || j >= RC) continue;
    const size_t i = j * GW + gw;
    if (vote_any[j]) {
      V8 d;
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        d.ub[l] = (vote[j][l >> 1] >> (16 * (l & 1)) & 1u)
                      ? in<uint8_t>(a, P2B_DEL)[i + l] : 0;
      }
      byte_masks(del[j], d);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (!valid || j >= RC) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      del[j][k] &= vote[j][k];
      dropped[k] += (vote[j][k] & ~del[j][k]) & 0x00010001u;
    }
  }

  // Trip 3: Phase2b min-writes, the vote counts, the every-row quorum.
  unsigned quorum[4] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
  {
    V16 lat[kMaxRows][2];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (valid && j < RC) load_masked(lat[j], in<int>(a, P2B_LAT) + j * GW + gw, del[j]);
    }
    unsigned row_any[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (!valid || j >= RC) continue;
      const int c = j % a.C;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c == 0) row_any[k] = 0;
        const unsigned b = pb[j].w[k];
        pb[j].w[k] = sel2(del[j][k], __vmins2(b, low_halves(lat[j], k)), b);
        row_any[k] |= __vcmples2(pb[j].w[k], 0u);
        if (c == a.C - 1) quorum[k] &= row_any[k];
      }
      st16(out<int16_t>(a, O_P2B) + j * GW + gw, pb[j]);
    }
  }

  // Chosen: PROPOSED, every row voted, the proxy alive. A slot that may
  // retry and is not chosen times out.
  unsigned newly[4], chosen[4], timed[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    newly[k] = valid ? prop[k] & quorum[k] & live_proxy[k] : 0u;
    timed[k] = due[k] & ~newly[k];
  }
  {
    const V8 nb = mask_bytes(newly);
    st.u.x = (st.u.x & ~(nb.u.x * 0xffu)) | (nb.u.x * kChosen);
    st.u.y = (st.u.y & ~(nb.u.y * 0xffu)) | (nb.u.y * kChosen);
    V8 c;
    c.u.x = __vcmpeq4(st.u.x, 0x02020202u);  // kChosen
    c.u.y = __vcmpeq4(st.u.y, 0x02020202u);
    byte_masks(chosen, c);
  }

  // Trip 4: the replica clocks, rep_lat where a slot is newly chosen,
  // retry_del where one times out. The commit broadcast and each
  // replica's first gap of the arrived prefix (the live range tests the
  // ring position, as in JAX).
  const bool timed_any = any_lane(timed, 0, 4);
  V8 rdel[kMaxRows];
  {
    V16 rp[kMaxRows], rl[kMaxRows][2];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      rdel[j].u = make_uint2(0, 0);
      if (!valid) continue;
      if (j < a.NR) {
        rp[j] = ld16(in<int16_t>(a, REP) + j * GW + gw);
        load_masked(rl[j], in<int>(a, REP_LAT) + j * GW + gw, newly);
      }
      if (timed_any && j < RC) rdel[j] = ld8(in<uint8_t>(a, RETRY_DEL) + j * GW + gw);
    }
    // Per lane pair: the ring ordinal, and whether the position is live.
    const int span = wsub(next, head);
    const int ord0 = floor_mod(wsub(w0, head), a.W);
    unsigned ord[4], live[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int o0 = ord0 + 2 * k, o1 = o0 + 1;
      o0 = o0 < a.W ? o0 : o0 - a.W;
      o1 = o1 < a.W ? o1 : o1 - a.W;
      ord[k] = static_cast<unsigned>(o0) | (static_cast<unsigned>(o1) << 16);
      live[k] = (w0 + 2 * k < span ? 0x0000ffffu : 0u) |
                (w0 + 2 * k + 1 < span ? 0xffff0000u : 0u);
    }
    const unsigned wide = static_cast<unsigned>(a.W) * 0x00010001u;
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (j >= a.NR) continue;
      int gap = a.W;
      if (valid) {
        unsigned m = 0xffffffffu;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned r = sel2(newly[k], low_halves(rl[j], k), age2(rp[j].w[k]));
          rp[j].w[k] = r;
          const unsigned ready = chosen[k] & __vcmples2(r, 0u) & live[k];
          m = __vminu2(m, sel2(ready, wide, ord[k]));
        }
        const int lo = static_cast<int>(m & 0xffffu), hi = static_cast<int>(m >> 16);
        gap = lo < hi ? lo : hi;
        st16(out<int16_t>(a, O_REP) + j * GW + gw, rp[j]);
      }
      if (kShfl) {
        for (int off = per_group >> 1; off > 0; off >>= 1) {
          const int o = __shfl_xor_sync(0xffffffffu, gap, off);
          gap = o < gap ? o : gap;
        }
        if (valid && x == 0) {
          const size_t ng = static_cast<size_t>(j) * a.G + g;
          const int mark = wadd(head, gap);
          const int old = in<int>(a, REP_EXEC)[ng];
          out<int>(a, O_REP_EXEC)[ng] = old > mark ? old : mark;
        }
      } else {
        atomicMin(&s_gap[j * a.gpb + gi], gap);
      }
    }
  }

  // Trip 5: a timed-out slot's re-send overwrites the aged p2a where it
  // lands (the row stored after trip 1, read back), with retry_lat.
  if (timed_any) {
    V16 cur[kMaxRows], tl[kMaxRows][2];
    unsigned resend[kMaxRows][4];
    bool hit[kMaxRows];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      hit[j] = false;
      if (j >= RC) continue;
      byte_masks(resend[j], rdel[j]);
#pragma unroll
      for (int k = 0; k < 4; ++k) resend[j][k] &= timed[k];
      hit[j] = any_lane(resend[j], 0, 4);
      if (!hit[j]) continue;
      cur[j] = ld16(out<int16_t>(a, O_P2A) + j * GW + gw);
      load_masked(tl[j], in<int>(a, RETRY_LAT) + j * GW + gw, resend[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (!hit[j]) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cur[j].w[k] = sel2(resend[j][k], low_halves(tl[j], k), cur[j].w[k]);
      }
      st16(out<int16_t>(a, O_P2A) + j * GW + gw, cur[j]);
    }
  }

  if (valid) {
    V16 vo[2], dr[2];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int sh = 16 * (l & 1);
      if (timed[l >> 1] >> sh & 1u) lane32(ls, l) = a.t;
      lane32(vo, l) = static_cast<int>(votes[l >> 1] >> sh & 0xffffu);
      lane32(dr, l) = static_cast<int>(dropped[l >> 1] >> sh & 0xffffu);
    }
    st8(out<int8_t>(a, O_STATUS) + gw, st);
    st16(out<int>(a, O_LS) + gw, ls[0]);
    st16(out<int>(a, O_LS) + gw + 4, ls[1]);
    st8(out<uint8_t>(a, O_NEWLY) + gw, mask_bytes(newly));
    st8(out<uint8_t>(a, O_TIMED) + gw, mask_bytes(timed));
    st16(out<int>(a, O_VOTES) + gw, vo[0]);
    st16(out<int>(a, O_VOTES) + gw + 4, vo[1]);
    st16(out<int>(a, O_DROPPED) + gw, dr[0]);
    st16(out<int>(a, O_DROPPED) + gw + 4, dr[1]);
  }
  if (!kShfl) {
    __syncthreads();
    if (valid && x == 0) store_watermarks(a, g, s_gap + gi, a.gpb);
  }
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_cz_num_slots() { return NUM_SLOTS; }

// Launch the grid-vote kernel. ptrs holds NUM_SLOTS device pointers;
// ints = {R, C, NR, G, W, t, retry_timeout, gpb, route}, the route the
// wrapper chose (ops/compartmentalized.py grid_vote_route): 0 scalar (one
// thread per slot, W * gpb <= 1024), 1 general (one CTA per group, any W),
// 2 vector (8 slots a thread, gpb groups of W / 8 threads a CTA, at most
// 256 threads). Checked again here, and refused where its conditions do
// not hold (the vector route: W % 8 == 0, R * C and NR at most kMaxRows,
// every pointer 16-byte aligned). Returns the CUDA error of the launch (0
// = launched). Does not synchronise.
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
  const dim3 grid((a.G + a.gpb - 1) / a.gpb);
  switch (ints[8]) {
    case 0: {
      if (static_cast<long long>(a.W) * a.gpb > 1024 || shmem > 48 * 1024) {
        return cudaErrorInvalidValue;
      }
      grid_vote_kernel<<<grid, dim3(a.W, a.gpb), shmem, st>>>(a);
      break;
    }
    case 1: {
      const size_t shmem_any = sizeof(int) * static_cast<size_t>(a.NR);
      if (shmem_any > 48 * 1024) return cudaErrorInvalidValue;
      int threads = ((a.W + 31) / 32) * 32;
      if (threads > 256) threads = 256;
      grid_vote_any<<<a.G, threads, shmem_any, st>>>(a);
      break;
    }
    case 2: {
      const int per_group = a.W / 8;
      const int threads = per_group * a.gpb;
      if (a.W % 8 != 0 || a.W > 1024 || threads > 256 ||
          a.R * a.C > kMaxRows || a.NR > kMaxRows ||
          !all_aligned16(a.p, NUM_SLOTS)) {
        return cudaErrorInvalidValue;
      }
      const bool shfl = (per_group & (per_group - 1)) == 0 &&
                        per_group <= 32 && threads % 32 == 0;
      const dim3 block(per_group, a.gpb);
      if (shfl) {
        grid_vote_vec<true><<<grid, block, 0, st>>>(a);
      } else {
        if (shmem > 48 * 1024) return cudaErrorInvalidValue;
        grid_vote_vec<false><<<grid, block, shmem, st>>>(a);
      }
      break;
    }
    default:
      return cudaErrorInvalidValue;
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
