// Hand-written Hopper (sm_90a) kernels for the batched MultiPaxos tick.
//
// Four kernels; the first three share one body (vote_step / dispatch_pre /
// dispatch_post / the per-acceptor writes), as in the Pallas module they
// replace, frankenpaxos_tpu/ops/multipaxos.py:
//
//   fpx_mp_fused_tick   replaces fused_tick        (ops/multipaxos.py:1029,
//                       pallas_call at :1127): offset-clock aging ->
//                       vote/quorum -> dispatch (choose, commit watermark,
//                       retire-clears, propose, retry) in one pass.
//   fpx_mp_vote_quorum  replaces fused_vote_quorum (ops/multipaxos.py:216,
//                       pallas_call at :278).
//   fpx_mp_dispatch     replaces fused_mp_dispatch (ops/multipaxos.py:738,
//                       pallas_call at :820).
//   fpx_mp_p1_promise   replaces fused_p1_promise  (ops/multipaxos.py:385,
//                       pallas_call at :447): phase-1 safe values and the
//                       full-group re-send for elections, reconfiguration
//                       installs and host leader changes. Bound by bytes
//                       (33.6 MB needed at the flagship shape on random
//                       inputs, ~10 us; 55.5 MB if every input is read).
//                       Two routes (the wrapper's choice, checked here):
//                       the vector route (p1_promise_vec: 8 slots a
//                       thread, the group's mask read once, 16-byte
//                       loads) and the general kernel (p1_promise_any: a
//                       thread a slot, any A and W).
//
// Each computes exactly what its plain PyTorch twin in
// frankenpaxos_tpu_torch/ops/multipaxos.py computes, bit for bit (it is
// all integer work; common.cuh lists where C++ and the array libraries
// part ways). Besides the helpers there, the fresh value
// ((next+delta)*G + g) & 0x7FFFFFFF is computed in uint32.
//
// Design. One thread per ring slot w; blockDim = (W, gpb) holds gpb whole
// groups (gpb = max(1, 256 / W) unless the caller asks for a block), so a
// group's W threads are contiguous and, when W % 32 == 0, each warp lies
// inside one group. The A = 2f+1 acceptors are a register loop (A is a
// template parameter). Reductions over W (min for n_retire, max for
// acc_round' and max_ord) are a warp __reduce_*_sync plus one shared-memory
// atomic per warp when warps are group-aligned, else one shared atomic per
// thread. The grid's ragged edge (G = 3334 is not a multiple of gpb) is
// masked per thread; masked threads still reach every barrier.
//
// General instantiation. The templated kernels serve A in {3, 5, 7, 9}
// (f <= 4) and W <= 1024; every other shape the JAX kernels run (any
// f >= 1, any W) goes to the *_any kernels: one CTA per group, a
// block-stride loop over its W ring slots, A a runtime loop. The per-group
// reductions over W stay exact: every thread of the block runs the same
// number of loop steps (slots past W give the reduction's neutral value),
// each step is a full-warp __reduce_*_sync plus one shared atomic per warp,
// and min / max do not depend on the order. Per-acceptor values a thread
// must carry past the n_retire barrier (its slots' aged clocks and votes,
// the slot state after the choose) go through the kernel's own output
// planes: the same thread writes them before the barrier and reads them
// back after it.
//
// Bound. The work is a few integer ops per byte; every kernel is bound by
// the bytes it must move. fpx_mp_fused_tick at the flagship shape (A=3,
// G=3334, W=256) reads 19 B per acceptor-slot ([A,G,W]: p2a, p2b, vote
// round (int16), vote value (int32), p2b/p2a/retry latencies (int16), three
// uint8 masks = 2+2+2+4+2+2+2+3 = 19) and writes 10 B per acceptor-slot
// (p2a, p2b, vote round, vote value), reads 31 B and writes 39 B per slot
// ([G,W]), about 157 B per ring slot: ~134 MB a tick, ~40 us at
// 3.35 TB/s. The megakernel keeps the vote half's per-acceptor outputs in
// registers for the dispatch half: the [A,G,W] HBM round trip between the
// two per-plane kernels is the traffic it deletes.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kEmpty = 0;
constexpr int kProposed = 1;
constexpr int kChosen = 2;
constexpr int kNoValue = -1;
constexpr int kNoopValue = -2;
constexpr int kInf = 1 << 30;
constexpr int kAmsFloor = -(1 << 14);

// Pointer slots of Args. The Python wrappers fill the same order
// (frankenpaxos_tpu_torch/ops/multipaxos.py, _PTR_SLOTS).
enum Slot {
  P2A, ACCR, LR, SV, VR, VV, P2B, P2B_LAT, DELIV, HEAD,
  STATUS, PT, LS, CT, CR, CV, RA, NEXT, CAP, ROK, GIDS,
  SOK, RDEL, P2A_LAT, RETRY_LAT, REP_LAT, NVOTES_IN,
  O_STATUS, O_SV, O_PT, O_LS, O_CT, O_CR, O_CV, O_RA,
  O_P2A, O_P2B, O_VR, O_VV,
  O_HEAD, O_NEXT, O_COUNT, O_NRET,
  O_NEWLY, O_RETIRE, O_ISNEW, O_TIMED, O_LAT,
  O_ACCR, O_NVOTES, O_NSENDS, O_MAXORD,
  MASK, LEARNED, P1_LAT,
  NUM_SLOTS
};

struct Args {
  void* p[NUM_SLOTS];
  int G, W, t, f, retry_timeout, num_groups, age, gpb;
  int A;  // runtime acceptor count (the *_any kernels)
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// One acceptor's vote step on one slot (ops/multipaxos.py _vote_step).
struct Vote {
  int16_t vr, p2b;
  int vv;
  bool may_vote, sends, votes_in;
};

__device__ __forceinline__ Vote vote_step(int16_t lr, int sv, int16_t accr,
                                          int16_t p2a, int16_t vr, int vv,
                                          int16_t p2b, int16_t lat,
                                          bool deliv) {
  Vote o;
  o.may_vote = (p2a == 0) && (lr >= accr);
  o.vr = o.may_vote ? lr : vr;
  o.vv = o.may_vote ? sv : vv;
  o.sends = o.may_vote && deliv;
  o.p2b = o.sends ? (p2b < lat ? p2b : lat) : p2b;
  o.votes_in = (o.p2b <= 0) && (o.vr == lr);
  return o;
}

// The dispatch plane's slot state (ops/multipaxos.py _dispatch_slots).
struct SlotState {
  int8_t status;
  int sv, pt, ls, ct, cv, ra;
  int16_t cr;
  bool newly, retire, is_new, timed;
  int latency;
};

// Quorum -> Chosen; returns the slot's contribution to the n_retire min.
__device__ __forceinline__ int dispatch_pre(SlotState& s, const Args& a,
                                            int nvotes, int16_t lr,
                                            int rep_lat, int ord, int head,
                                            int next) {
  const int t = a.t;
  s.newly = (s.status == kProposed) && (nvotes >= a.f + 1);
  if (s.newly) {
    s.ct = t;
    s.cr = lr;
    s.cv = s.sv;
    s.ra = wadd(t, rep_lat);
    s.status = kChosen;
    s.latency = wsub(t, s.pt);
  } else {
    s.latency = 0;
  }
  const bool executable =
      (s.status == kChosen) && (s.ra <= t) && (ord < wsub(next, head));
  return executable ? a.W : ord;
}

// The per-group count of new proposals: the cap, bounded by the window's
// free space once n_retire slots retire.
__device__ __forceinline__ int propose_count(const Args& a, int n_retire,
                                             int head, int next, int cap) {
  const int new_head = wadd(head, n_retire);
  const int space = wsub(a.W, wsub(next, new_head));
  return cap < space ? cap : space;
}

// Watermark retire-clears, proposals into the freed window, retries.
// Returns the per-group count of new proposals.
__device__ __forceinline__ int dispatch_post(SlotState& s, const Args& a,
                                             int n_retire, int ord, int w,
                                             int head, int next, int cap,
                                             bool rok, int gid) {
  const int t = a.t;
  s.retire = ord < n_retire;
  if (s.retire) {
    s.status = kEmpty;
    s.sv = kNoValue;
    s.ct = kInf;
    s.cr = -1;
    s.cv = kNoValue;
    s.ra = kInf;
    s.pt = kInf;
    s.ls = kInf;
  }
  const int count = propose_count(a, n_retire, head, next, cap);
  const int delta = floor_mod(wsub(w, next), a.W);
  s.is_new = delta < count;
  if (s.is_new) {
    s.status = kProposed;
    const unsigned v = (static_cast<unsigned>(next) + static_cast<unsigned>(delta)) *
                           static_cast<unsigned>(a.num_groups) +
                       static_cast<unsigned>(gid);
    s.sv = static_cast<int>(v & 0x7FFFFFFFu);
    s.pt = t;
    s.ls = t;
  }
  s.timed = (s.status == kProposed) && (wsub(t, s.ls) >= a.retry_timeout) && rok;
  if (s.timed) s.ls = t;
  return count;
}

__device__ __forceinline__ void store_slots(const Args& a, size_t gw,
                                            const SlotState& s) {
  out<int8_t>(a, O_STATUS)[gw] = s.status;
  out<int>(a, O_SV)[gw] = s.sv;
  out<int>(a, O_PT)[gw] = s.pt;
  out<int>(a, O_LS)[gw] = s.ls;
  out<int>(a, O_CT)[gw] = s.ct;
  out<int16_t>(a, O_CR)[gw] = s.cr;
  out<int>(a, O_CV)[gw] = s.cv;
  out<int>(a, O_RA)[gw] = s.ra;
  out<uint8_t>(a, O_NEWLY)[gw] = s.newly;
  out<uint8_t>(a, O_RETIRE)[gw] = s.retire;
  out<uint8_t>(a, O_ISNEW)[gw] = s.is_new;
  out<uint8_t>(a, O_TIMED)[gw] = s.timed;
  out<int>(a, O_LAT)[gw] = s.latency;
}

__device__ __forceinline__ SlotState load_slots(const Args& a, size_t gw,
                                                int sv) {
  SlotState s;
  s.status = in<int8_t>(a, STATUS)[gw];
  s.sv = sv;
  s.pt = in<int>(a, PT)[gw];
  s.ls = in<int>(a, LS)[gw];
  s.ct = in<int>(a, CT)[gw];
  s.cr = in<int16_t>(a, CR)[gw];
  s.cv = in<int>(a, CV)[gw];
  s.ra = in<int>(a, RA)[gw];
  return s;
}

// One acceptor's dispatch-plane writes (ops/multipaxos.py
// _dispatch_acceptor): retire-clears, the Phase2a fan-out of fresh
// proposals and timeout resends.
__device__ __forceinline__ void dispatch_acceptor(const Args& a, size_t agw,
                                                  const SlotState& s,
                                                  int16_t p2a, int16_t p2b,
                                                  int16_t vr, int vv) {
  if (s.retire) p2a = kInf16;
  if (s.is_new && in<uint8_t>(a, SOK)[agw]) p2a = in<int16_t>(a, P2A_LAT)[agw];
  if (s.timed && in<uint8_t>(a, RDEL)[agw]) p2a = in<int16_t>(a, RETRY_LAT)[agw];
  out<int16_t>(a, O_P2A)[agw] = p2a;
  out<int16_t>(a, O_P2B)[agw] = s.retire ? static_cast<int16_t>(kInf16) : p2b;
  out<int16_t>(a, O_VR)[agw] = s.retire ? static_cast<int16_t>(-1) : vr;
  out<int>(a, O_VV)[agw] = s.retire ? kNoValue : vv;
}

struct Thread {
  int w, gi, g;
  bool valid, aligned;
  size_t gw;
};

__device__ __forceinline__ Thread thread_of(const Args& a) {
  Thread th;
  th.w = threadIdx.x;
  th.gi = threadIdx.y;
  th.g = blockIdx.x * a.gpb + th.gi;
  th.valid = th.g < a.G;
  th.aligned = (a.W & 31) == 0;
  th.gw = static_cast<size_t>(th.g) * a.W + th.w;
  return th;
}

__device__ __forceinline__ size_t agw_of(const Args& a, int k, const Thread& th) {
  return (static_cast<size_t>(k) * a.G + th.g) * a.W + th.w;
}

// Shared memory: n_retire [gpb], then acc_round' and max_ord [A][gpb].
template <int A>
__device__ __forceinline__ void init_shared(int* smem, const Args& a,
                                            const Thread& th) {
  if (th.w == 0) {
    smem[th.gi] = INT_MAX;
    for (int k = 0; k < 2 * A; ++k) smem[a.gpb + k * a.gpb + th.gi] = INT_MIN;
  }
}

// Writes acc_round' and max_ord for group th.g (one thread per group).
template <int A>
__device__ __forceinline__ void store_vote_reductions(const int* smem,
                                                      const Args& a,
                                                      const Thread& th) {
  if (!th.valid || th.w != 0) return;
  const int* s_accr = smem + a.gpb;
  const int* s_mord = s_accr + A * a.gpb;
  for (int k = 0; k < A; ++k) {
    const size_t ag = static_cast<size_t>(k) * a.G + th.g;
    const int accr = in<int16_t>(a, ACCR)[ag];
    const int red = s_accr[k * a.gpb + th.gi];
    out<int16_t>(a, O_ACCR)[ag] = static_cast<int16_t>(accr > red ? accr : red);
    out<int>(a, O_MAXORD)[ag] = s_mord[k * a.gpb + th.gi];
  }
}

template <int A, bool kFused>
__device__ __forceinline__ void vote_half(
    int* smem, const Args& a, const Thread& th, int16_t lr, int sv, int ord,
    int16_t (&p2a_r)[A], int16_t (&p2b_r)[A], int16_t (&vr_r)[A],
    int (&vv_r)[A], int& nvotes, int& nsends) {
  int* s_accr = smem + a.gpb;
  int* s_mord = s_accr + A * a.gpb;
  nvotes = 0;
  nsends = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    int16_t p2a = kInf16, p2b = kInf16, vr = -1, lat = 0, accr = 0;
    int vv = kNoValue;
    bool deliv = false;
    if (th.valid) {
      const size_t agw = agw_of(a, k, th);
      p2a = in<int16_t>(a, P2A)[agw];
      p2b = in<int16_t>(a, P2B)[agw];
      vr = in<int16_t>(a, VR)[agw];
      vv = in<int>(a, VV)[agw];
      lat = in<int16_t>(a, P2B_LAT)[agw];
      deliv = in<uint8_t>(a, DELIV)[agw] != 0;
      accr = in<int16_t>(a, ACCR)[static_cast<size_t>(k) * a.G + th.g];
    }
    if (kFused && a.age) {
      p2a = age_clock(p2a);
      p2b = age_clock(p2b);
    }
    const Vote v = vote_step(lr, sv, accr, p2a, vr, vv, p2b, lat, deliv);
    group_max(&s_accr[k * a.gpb + th.gi], v.may_vote ? static_cast<int>(lr) : -1,
              th.aligned);
    group_max(&s_mord[k * a.gpb + th.gi], v.may_vote ? ord : kAmsFloor,
              th.aligned);
    nvotes += v.votes_in;
    nsends += v.sends;
    p2a_r[k] = p2a;
    p2b_r[k] = v.p2b;
    vr_r[k] = v.vr;
    vv_r[k] = v.vv;
  }
}

// ---------------------------------------------------------------------------
// fpx_mp_fused_tick: the whole tick in one pass.
// ---------------------------------------------------------------------------
template <int A>
__global__ void fused_tick_kernel(const Args a) {
  extern __shared__ int smem[];
  const Thread th = thread_of(a);
  init_shared<A>(smem, a, th);
  __syncthreads();

  int16_t lr = 0;
  int sv = 0, head = 0, next = 0, cap = 0, gid = 0, rep_lat = 0;
  bool rok = false;
  if (th.valid) {
    lr = in<int16_t>(a, LR)[th.g];
    head = in<int>(a, HEAD)[th.g];
    next = in<int>(a, NEXT)[th.g];
    cap = in<int>(a, CAP)[th.g];
    rok = in<uint8_t>(a, ROK)[th.g] != 0;
    gid = in<int>(a, GIDS)[th.g];
    sv = in<int>(a, SV)[th.gw];
    rep_lat = in<int>(a, REP_LAT)[th.gw];
  }
  const int ord = floor_mod(wsub(th.w, head), a.W);

  int16_t p2a_r[A], p2b_r[A], vr_r[A];
  int vv_r[A];
  int nvotes, nsends;
  vote_half<A, true>(smem, a, th, lr, sv, ord, p2a_r, p2b_r, vr_r, vv_r,
                     nvotes, nsends);

  SlotState s;
  if (th.valid) {
    s = load_slots(a, th.gw, sv);
  } else {
    s = SlotState{};
    s.status = kEmpty;
  }
  const int blocked = dispatch_pre(s, a, nvotes, lr, rep_lat, ord, head, next);
  group_min(&smem[th.gi], blocked, th.aligned);
  __syncthreads();

  store_vote_reductions<A>(smem, a, th);
  if (!th.valid) return;  // no barrier follows
  const int n_retire = smem[th.gi];
  const int count = dispatch_post(s, a, n_retire, ord, th.w, head, next, cap,
                                  rok, gid);
  store_slots(a, th.gw, s);
  out<int>(a, O_NSENDS)[th.gw] = nsends;
  if (th.w == 0) {
    out<int>(a, O_HEAD)[th.g] = wadd(head, n_retire);
    out<int>(a, O_NEXT)[th.g] = wadd(next, count);
    out<int>(a, O_COUNT)[th.g] = count;
    out<int>(a, O_NRET)[th.g] = n_retire;
  }
#pragma unroll
  for (int k = 0; k < A; ++k) {
    dispatch_acceptor(a, agw_of(a, k, th), s, p2a_r[k], p2b_r[k], vr_r[k],
                      vv_r[k]);
  }
}

// ---------------------------------------------------------------------------
// fpx_mp_vote_quorum: tick steps 1-2 (clocks arrive aged).
// ---------------------------------------------------------------------------
template <int A>
__global__ void vote_quorum_kernel(const Args a) {
  extern __shared__ int smem[];
  const Thread th = thread_of(a);
  init_shared<A>(smem, a, th);
  __syncthreads();

  int16_t lr = 0;
  int sv = 0, head = 0;
  if (th.valid) {
    lr = in<int16_t>(a, LR)[th.g];
    head = in<int>(a, HEAD)[th.g];
    sv = in<int>(a, SV)[th.gw];
  }
  const int ord = floor_mod(wsub(th.w, head), a.W);
  int16_t p2a_r[A], p2b_r[A], vr_r[A];
  int vv_r[A];
  int nvotes, nsends;
  vote_half<A, false>(smem, a, th, lr, sv, ord, p2a_r, p2b_r, vr_r, vv_r,
                      nvotes, nsends);
  __syncthreads();

  store_vote_reductions<A>(smem, a, th);
  if (!th.valid) return;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const size_t agw = agw_of(a, k, th);
    out<int16_t>(a, O_VR)[agw] = vr_r[k];
    out<int>(a, O_VV)[agw] = vv_r[k];
    out<int16_t>(a, O_P2B)[agw] = p2b_r[k];
  }
  out<int>(a, O_NVOTES)[th.gw] = nvotes;
  out<int>(a, O_NSENDS)[th.gw] = nsends;
}

// ---------------------------------------------------------------------------
// fpx_mp_dispatch: tick steps 2-5 from the vote plane's outputs.
// ---------------------------------------------------------------------------
template <int A>
__global__ void dispatch_kernel(const Args a) {
  extern __shared__ int smem[];
  const Thread th = thread_of(a);
  if (th.w == 0) smem[th.gi] = INT_MAX;
  __syncthreads();

  int16_t lr = 0;
  int sv = 0, head = 0, next = 0, cap = 0, gid = 0, rep_lat = 0, nvotes = 0;
  bool rok = false;
  SlotState s = SlotState{};
  s.status = kEmpty;
  if (th.valid) {
    lr = in<int16_t>(a, LR)[th.g];
    head = in<int>(a, HEAD)[th.g];
    next = in<int>(a, NEXT)[th.g];
    cap = in<int>(a, CAP)[th.g];
    rok = in<uint8_t>(a, ROK)[th.g] != 0;
    gid = in<int>(a, GIDS)[th.g];
    sv = in<int>(a, SV)[th.gw];
    rep_lat = in<int>(a, REP_LAT)[th.gw];
    nvotes = in<int>(a, NVOTES_IN)[th.gw];
    s = load_slots(a, th.gw, sv);
  }
  const int ord = floor_mod(wsub(th.w, head), a.W);
  const int blocked = dispatch_pre(s, a, nvotes, lr, rep_lat, ord, head, next);
  group_min(&smem[th.gi], blocked, th.aligned);
  __syncthreads();

  if (!th.valid) return;
  const int n_retire = smem[th.gi];
  const int count = dispatch_post(s, a, n_retire, ord, th.w, head, next, cap,
                                  rok, gid);
  store_slots(a, th.gw, s);
  if (th.w == 0) {
    out<int>(a, O_HEAD)[th.g] = wadd(head, n_retire);
    out<int>(a, O_NEXT)[th.g] = wadd(next, count);
    out<int>(a, O_COUNT)[th.g] = count;
    out<int>(a, O_NRET)[th.g] = n_retire;
  }
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const size_t agw = agw_of(a, k, th);
    dispatch_acceptor(a, agw, s, in<int16_t>(a, P2A)[agw],
                      in<int16_t>(a, P2B)[agw], in<int16_t>(a, VR)[agw],
                      in<int>(a, VV)[agw]);
  }
}

// ---------------------------------------------------------------------------
// fpx_mp_p1_promise: phase-1 safe values and the full-group re-send.
// An in-flight slot (PROPOSED, its group masked) adopts the value of the
// max-round vote among the learned acceptors (strict > keeps the first
// maximum, argmax's tie-break) or a noop, and re-sends to every acceptor;
// every other slot copies through. Each branch reads only what it writes
// from: the votes, learned bits and latencies for in-flight slots, the
// carried slot value, send tick and clocks for the rest.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void p1_slot(const Args& a, int g, size_t gw) {
  const int A = a.A;
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const bool in_flight = in<int8_t>(a, STATUS)[gw] == kProposed &&
                         in<uint8_t>(a, MASK)[g] != 0;
  if (in_flight) {
    int best_r = -1, best_v = 0;
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const size_t agw = k * GW + gw;
      if (in<uint8_t>(a, LEARNED)[static_cast<size_t>(k) * a.G + g]) {
        const int r = in<int16_t>(a, VR)[agw];
        if (r > best_r) {
          best_r = r;
          best_v = in<int>(a, VV)[agw];
        }
      }
      out<int16_t>(a, O_P2A)[agw] = in<int16_t>(a, P1_LAT)[agw];
      out<int16_t>(a, O_P2B)[agw] = static_cast<int16_t>(kInf16);
    }
    out<int>(a, O_SV)[gw] = best_r >= 0 ? best_v : kNoopValue;
    out<int>(a, O_LS)[gw] = a.t;
  } else {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const size_t agw = k * GW + gw;
      out<int16_t>(a, O_P2A)[agw] = in<int16_t>(a, P2A)[agw];
      out<int16_t>(a, O_P2B)[agw] = in<int16_t>(a, P2B)[agw];
    }
    out<int>(a, O_SV)[gw] = in<int>(a, SV)[gw];
    out<int>(a, O_LS)[gw] = in<int>(a, LS)[gw];
  }
}

// The vector route (W % 8 == 0, every plane 16-byte aligned): a thread
// owns 8 consecutive slots of one group and reads its mask once, so the
// branch is the same for the whole group. The acceptor rows go in
// batches of kP1Batch, every load of a batch issued before its first use.
constexpr int kP1Batch = 3;

// An unmasked group copies through: 16-byte loads and stores of its
// clocks (8 int16 a row), slot values and send ticks (8 int32); it never
// reads the status.
__device__ __forceinline__ void p1_copy_chunk(const Args& a, size_t GW,
                                              size_t gw) {
  const V16 sv0 = ld16(in<int>(a, SV) + gw), sv1 = ld16(in<int>(a, SV) + gw + 4);
  const V16 ls0 = ld16(in<int>(a, LS) + gw), ls1 = ld16(in<int>(a, LS) + gw + 4);
  for (int k0 = 0; k0 < a.A; k0 += kP1Batch) {
    V16 pa[kP1Batch], pb[kP1Batch];
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
      if (k0 + j < a.A) {
        const size_t i = (k0 + j) * GW + gw;
        pa[j] = ld16(in<int16_t>(a, P2A) + i);
        pb[j] = ld16(in<int16_t>(a, P2B) + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
      if (k0 + j < a.A) {
        const size_t i = (k0 + j) * GW + gw;
        st16(out<int16_t>(a, O_P2A) + i, pa[j]);
        st16(out<int16_t>(a, O_P2B) + i, pb[j]);
      }
    }
  }
  st16(out<int>(a, O_SV) + gw, sv0);
  st16(out<int>(a, O_SV) + gw + 4, sv1);
  st16(out<int>(a, O_LS) + gw, ls0);
  st16(out<int>(a, O_LS) + gw + 4, ls1);
}

// A masked group: the per-slot logic of p1_slot on 8 slots at once, two
// int16 lanes a word with per-halfword SIMD ops (common.cuh). Its rows are
// read unconditionally, each batch in one go with the status, so that a
// batch costs one trip to memory: the carried clocks, values and send
// ticks, the re-send latencies and the vote rounds. The winning vote's
// value is then read only from the rows of acceptors that win a slot, only
// the 16-byte half that holds a winning lane.
__device__ __forceinline__ void p1_repair_chunk(const Args& a, size_t GW,
                                                int g, size_t gw) {
  const V8 st = ld8(in<int8_t>(a, STATUS) + gw);
  V16 sv[2], ls[2];
  sv[0] = ld16(in<int>(a, SV) + gw);
  sv[1] = ld16(in<int>(a, SV) + gw + 4);
  ls[0] = ld16(in<int>(a, LS) + gw);
  ls[1] = ld16(in<int>(a, LS) + gw + 4);
  // The first maximum of the learned acceptors' vote rounds (strict >)
  // and its acceptor, a lane pair a word.
  unsigned fly[4], best_r[4], best_k[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    best_r[k] = 0xffffffffu;  // -1, -1
    best_k[k] = 0;
  }
  for (int k0 = 0; k0 < a.A; k0 += kP1Batch) {
    V16 pa[kP1Batch], pb[kP1Batch], lt[kP1Batch], vr[kP1Batch];
    bool use[kP1Batch];
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
      const int k = k0 + j;
      use[j] = false;
      if (k < a.A) {
        const size_t i = k * GW + gw;
        pa[j] = ld16(in<int16_t>(a, P2A) + i);
        pb[j] = ld16(in<int16_t>(a, P2B) + i);
        lt[j] = ld16(in<int16_t>(a, P1_LAT) + i);
        vr[j] = ld16(in<int16_t>(a, VR) + i);
        use[j] = in<uint8_t>(a, LEARNED)[static_cast<size_t>(k) * a.G + g] != 0;
      }
    }
    V8 p;
    p.u.x = __vcmpeq4(st.u.x, 0x01010101u);  // kProposed
    p.u.y = __vcmpeq4(st.u.y, 0x01010101u);
    byte_masks(fly, p);
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
      if (k0 + j >= a.A) continue;
      const unsigned kj = static_cast<unsigned>(k0 + j) * 0x00010001u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (use[j]) {
          const unsigned up = __vcmpgts2(vr[j].w[k], best_r[k]);
          best_r[k] = sel2(up, vr[j].w[k], best_r[k]);
          best_k[k] = sel2(up, kj, best_k[k]);
        }
        // The re-send: a fresh latency, the pending Phase2b cleared.
        pa[j].w[k] = sel2(fly[k], lt[j].w[k], pa[j].w[k]);
        pb[j].w[k] = sel2(fly[k], 0x7fff7fffu, pb[j].w[k]);  // INF16
      }
      const size_t i = (k0 + j) * GW + gw;
      st16(out<int16_t>(a, O_P2A) + i, pa[j]);
      st16(out<int16_t>(a, O_P2B) + i, pb[j]);
    }
  }
  // Safe values: the winner's vote value, or a noop where no learned
  // acceptor voted.
  unsigned voted[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) voted[k] = fly[k] & __vcmpges2(best_r[k], 0u);
  for (int k0 = 0; k0 < a.A; k0 += kP1Batch) {
    unsigned win[kP1Batch][4];
    V16 vv[kP1Batch][2];
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
      const unsigned kj = static_cast<unsigned>(k0 + j) * 0x00010001u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        win[j][k] = k0 + j < a.A ? voted[k] & __vcmpeq2(best_k[k], kj) : 0u;
      }
      load_masked(vv[j], in<int>(a, VV) + (k0 + j) * GW + gw, win[j]);
    }
#pragma unroll
    for (int j = 0; j < kP1Batch; ++j) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const unsigned m = lane_mask32(win[j][l >> 1], l);
        lane32(sv, l) = static_cast<int>(
            (static_cast<unsigned>(lane32(vv[j], l)) & m) |
            (static_cast<unsigned>(lane32(sv, l)) & ~m));
      }
    }
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (fly[l >> 1] >> (16 * (l & 1)) & 1u) {
      if (!(voted[l >> 1] >> (16 * (l & 1)) & 1u)) lane32(sv, l) = kNoopValue;
      lane32(ls, l) = a.t;
    }
  }
  st16(out<int>(a, O_SV) + gw, sv[0]);
  st16(out<int>(a, O_SV) + gw + 4, sv[1]);
  st16(out<int>(a, O_LS) + gw, ls[0]);
  st16(out<int>(a, O_LS) + gw + 4, ls[1]);
}

// A flat grid over the G * W / 8 chunks of 8 slots (a grid-stride loop
// in size_t, so G * W past 2^31 slots is safe).
__global__ void __launch_bounds__(256, 2) p1_promise_vec(const Args a) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t chunks = GW / 8;
  const int per_group = a.W / 8;
  for (size_t c = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < chunks; c += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(c / per_group);
    if (in<uint8_t>(a, MASK)[g]) {
      p1_repair_chunk(a, GW, g, c * 8);
    } else {
      p1_copy_chunk(a, GW, c * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// The general instantiation (runtime A, any W): one CTA per group, a
// block-stride loop over its ring slots (note at the top of the file).
// ---------------------------------------------------------------------------

// One loop step of a block-stride walk over a group's W slots.
struct Step {
  int w;
  bool in_ring;
  size_t gw;
};

__device__ __forceinline__ Step step_of(const Args& a, int w0) {
  Step st;
  st.w = w0 + threadIdx.x;
  st.in_ring = st.w < a.W;
  st.gw = static_cast<size_t>(blockIdx.x) * a.W + st.w;
  return st;
}

__device__ __forceinline__ size_t agw_any(const Args& a, int k, size_t gw) {
  return static_cast<size_t>(k) * a.G * a.W + gw;
}

// Shared memory: n_retire [1], then acc_round' and max_ord [A] each.
__device__ __forceinline__ void init_shared_any(int* smem, const Args& a) {
  for (int i = threadIdx.x; i < 1 + 2 * a.A; i += blockDim.x) {
    smem[i] = i == 0 ? INT_MAX : INT_MIN;
  }
}

__device__ __forceinline__ void store_vote_reductions_any(const int* smem,
                                                          const Args& a) {
  const int g = blockIdx.x;
  for (int k = threadIdx.x; k < a.A; k += blockDim.x) {
    const size_t ag = static_cast<size_t>(k) * a.G + g;
    const int accr = in<int16_t>(a, ACCR)[ag];
    const int red = smem[1 + k];
    out<int16_t>(a, O_ACCR)[ag] = static_cast<int16_t>(accr > red ? accr : red);
    out<int>(a, O_MAXORD)[ag] = smem[1 + a.A + k];
  }
}

// The vote half of one slot over the A acceptors, with the per-acceptor
// results written to the output planes (the fused tick's dispatch half
// reads them back after the barrier). Returns nvotes; adds to nsends.
template <bool kFused>
__device__ __forceinline__ int vote_slot_any(int* smem, const Args& a,
                                             const Step& st, int16_t lr,
                                             int sv, int ord, int& nsends) {
  int* s_accr = smem + 1;
  int* s_mord = s_accr + a.A;
  const int g = blockIdx.x;
  int nvotes = 0;
  nsends = 0;
  for (int k = 0; k < a.A; ++k) {
    const size_t agw = agw_any(a, k, st.gw);
    int16_t p2a = kInf16, p2b = kInf16, vr = -1, lat = 0, accr = 0;
    int vv = kNoValue;
    bool deliv = false;
    if (st.in_ring) {
      p2a = in<int16_t>(a, P2A)[agw];
      p2b = in<int16_t>(a, P2B)[agw];
      vr = in<int16_t>(a, VR)[agw];
      vv = in<int>(a, VV)[agw];
      lat = in<int16_t>(a, P2B_LAT)[agw];
      deliv = in<uint8_t>(a, DELIV)[agw] != 0;
      accr = in<int16_t>(a, ACCR)[static_cast<size_t>(k) * a.G + g];
    }
    if (kFused && a.age) {
      p2a = age_clock(p2a);
      p2b = age_clock(p2b);
    }
    const Vote v = vote_step(lr, sv, accr, p2a, vr, vv, p2b, lat, deliv);
    group_max(&s_accr[k], v.may_vote ? static_cast<int>(lr) : -1, true);
    group_max(&s_mord[k], v.may_vote ? ord : kAmsFloor, true);
    nvotes += v.votes_in;
    nsends += v.sends;
    if (st.in_ring) {
      if (kFused) out<int16_t>(a, O_P2A)[agw] = p2a;
      out<int16_t>(a, O_P2B)[agw] = v.p2b;
      out<int16_t>(a, O_VR)[agw] = v.vr;
      out<int>(a, O_VV)[agw] = v.vv;
    }
  }
  return nvotes;
}

// The slot state after the choose, read back from the output planes.
__device__ __forceinline__ SlotState load_slots_out(const Args& a, size_t gw) {
  SlotState s;
  s.status = out<int8_t>(a, O_STATUS)[gw];
  s.sv = out<int>(a, O_SV)[gw];
  s.pt = out<int>(a, O_PT)[gw];
  s.ls = out<int>(a, O_LS)[gw];
  s.ct = out<int>(a, O_CT)[gw];
  s.cr = out<int16_t>(a, O_CR)[gw];
  s.cv = out<int>(a, O_CV)[gw];
  s.ra = out<int>(a, O_RA)[gw];
  s.newly = out<uint8_t>(a, O_NEWLY)[gw] != 0;
  s.latency = out<int>(a, O_LAT)[gw];
  return s;
}

// The choose of one slot (dispatch_pre) with its contribution to the
// n_retire min (W, the neutral value, past the ring); the slot state goes
// to the output planes.
__device__ __forceinline__ void choose_slot_any(int* smem, const Args& a,
                                                const Step& st, int nvotes,
                                                int16_t lr, int sv, int ord,
                                                int head, int next) {
  SlotState s = SlotState{};
  s.status = kEmpty;
  int rep_lat = 0;
  if (st.in_ring) {
    s = load_slots(a, st.gw, sv);
    s.retire = s.is_new = s.timed = false;  // set after the barrier
    rep_lat = in<int>(a, REP_LAT)[st.gw];
  }
  const int blocked = dispatch_pre(s, a, nvotes, lr, rep_lat, ord, head, next);
  group_min(smem, st.in_ring ? blocked : a.W, true);
  if (st.in_ring) store_slots(a, st.gw, s);
}

// After the barrier: retire-clears, proposals and retries of every slot,
// and the group's scalars. kFused: the per-acceptor clocks and votes come
// from the output planes (the vote half's), else from the inputs.
template <bool kFused>
__device__ __forceinline__ void dispatch_group_any(const int* smem,
                                                   const Args& a, int head,
                                                   int next, int cap, bool rok,
                                                   int gid) {
  const int g = blockIdx.x;
  const int n_retire = smem[0];
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const Step st = step_of(a, w0);
    if (!st.in_ring) continue;
    SlotState s = load_slots_out(a, st.gw);
    dispatch_post(s, a, n_retire, floor_mod(wsub(st.w, head), a.W), st.w,
                  head, next, cap, rok, gid);
    store_slots(a, st.gw, s);
    for (int k = 0; k < a.A; ++k) {
      const size_t agw = agw_any(a, k, st.gw);
      if (kFused) {
        dispatch_acceptor(a, agw, s, out<int16_t>(a, O_P2A)[agw],
                          out<int16_t>(a, O_P2B)[agw],
                          out<int16_t>(a, O_VR)[agw], out<int>(a, O_VV)[agw]);
      } else {
        dispatch_acceptor(a, agw, s, in<int16_t>(a, P2A)[agw],
                          in<int16_t>(a, P2B)[agw], in<int16_t>(a, VR)[agw],
                          in<int>(a, VV)[agw]);
      }
    }
  }
  if (threadIdx.x == 0) {
    const int count = propose_count(a, n_retire, head, next, cap);
    out<int>(a, O_HEAD)[g] = wadd(head, n_retire);
    out<int>(a, O_NEXT)[g] = wadd(next, count);
    out<int>(a, O_COUNT)[g] = count;
    out<int>(a, O_NRET)[g] = n_retire;
  }
}

__global__ void fused_tick_any(const Args a) {
  extern __shared__ int smem[];
  init_shared_any(smem, a);
  __syncthreads();
  const int g = blockIdx.x;
  const int16_t lr = in<int16_t>(a, LR)[g];
  const int head = in<int>(a, HEAD)[g];
  const int next = in<int>(a, NEXT)[g];
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const Step st = step_of(a, w0);
    const int sv = st.in_ring ? in<int>(a, SV)[st.gw] : 0;
    const int ord = floor_mod(wsub(st.w, head), a.W);
    int nsends;
    const int nvotes = vote_slot_any<true>(smem, a, st, lr, sv, ord, nsends);
    choose_slot_any(smem, a, st, nvotes, lr, sv, ord, head, next);
    if (st.in_ring) out<int>(a, O_NSENDS)[st.gw] = nsends;
  }
  __syncthreads();
  store_vote_reductions_any(smem, a);
  dispatch_group_any<true>(smem, a, head, next, in<int>(a, CAP)[g],
                           in<uint8_t>(a, ROK)[g] != 0, in<int>(a, GIDS)[g]);
}

__global__ void vote_quorum_any(const Args a) {
  extern __shared__ int smem[];
  init_shared_any(smem, a);
  __syncthreads();
  const int g = blockIdx.x;
  const int16_t lr = in<int16_t>(a, LR)[g];
  const int head = in<int>(a, HEAD)[g];
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const Step st = step_of(a, w0);
    const int sv = st.in_ring ? in<int>(a, SV)[st.gw] : 0;
    const int ord = floor_mod(wsub(st.w, head), a.W);
    int nsends;
    const int nvotes = vote_slot_any<false>(smem, a, st, lr, sv, ord, nsends);
    if (st.in_ring) {
      out<int>(a, O_NVOTES)[st.gw] = nvotes;
      out<int>(a, O_NSENDS)[st.gw] = nsends;
    }
  }
  __syncthreads();
  store_vote_reductions_any(smem, a);
}

__global__ void dispatch_any(const Args a) {
  extern __shared__ int smem[];
  if (threadIdx.x == 0) smem[0] = INT_MAX;
  __syncthreads();
  const int g = blockIdx.x;
  const int16_t lr = in<int16_t>(a, LR)[g];
  const int head = in<int>(a, HEAD)[g];
  const int next = in<int>(a, NEXT)[g];
  for (int w0 = 0; w0 < a.W; w0 += blockDim.x) {
    const Step st = step_of(a, w0);
    int sv = 0, nvotes = 0;
    if (st.in_ring) {
      sv = in<int>(a, SV)[st.gw];
      nvotes = in<int>(a, NVOTES_IN)[st.gw];
    }
    choose_slot_any(smem, a, st, nvotes, lr, sv,
                    floor_mod(wsub(st.w, head), a.W), head, next);
  }
  __syncthreads();
  dispatch_group_any<false>(smem, a, head, next, in<int>(a, CAP)[g],
                            in<uint8_t>(a, ROK)[g] != 0, in<int>(a, GIDS)[g]);
}

__global__ void p1_promise_any(const Args a) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < GW; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    p1_slot(a, static_cast<int>(i / a.W), i);
  }
}

enum Which { kFusedTick = 0, kVoteQuorum = 1, kDispatch = 2, kP1Promise = 3 };
// Routes of the phase-1 kernel, as the wrapper names them
// (ops/multipaxos.py p1_promise_route; codes of ops/registry.py ROUTES).
enum Route { kGeneral = 1, kVector = 2 };

cudaError_t launch_p1_vector(const Args& a, cudaStream_t stream) {
  size_t blocks = (static_cast<size_t>(a.G) * a.W / 8 + 255) / 256;
  if (blocks > 0x7fffffffu) blocks = 0x7fffffffu;
  p1_promise_vec<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int A>
cudaError_t launch_a(int which, const Args& a, cudaStream_t stream) {
  const dim3 block(a.W, a.gpb);
  const dim3 grid((a.G + a.gpb - 1) / a.gpb);
  const size_t shmem = sizeof(int) * a.gpb * (1 + 2 * A);
  switch (which) {
    case kFusedTick:
      fused_tick_kernel<A><<<grid, block, shmem, stream>>>(a);
      break;
    case kVoteQuorum:
      vote_quorum_kernel<A><<<grid, block, shmem, stream>>>(a);
      break;
    case kDispatch:
      dispatch_kernel<A><<<grid, block, shmem, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The general instantiation: one CTA of up to 256 threads per group (a
// multiple of 32, so every warp lies inside the group).
cudaError_t launch_any(int which, const Args& a, cudaStream_t stream) {
  int threads = ((a.W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t shmem = sizeof(int) * (1 + 2 * static_cast<size_t>(a.A));
  if (shmem > 227 * 1024) return cudaErrorInvalidValue;
  switch (which) {
    case kP1Promise: {
      const size_t GW = static_cast<size_t>(a.G) * a.W;
      size_t blocks = (GW + 255) / 256;
      if (blocks > 0x7fffffffu) blocks = 0x7fffffffu;
      p1_promise_any<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a);
      break;
    }
    case kFusedTick:
      if (shmem > 48 * 1024) {
        cudaFuncSetAttribute(fused_tick_any,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
      }
      fused_tick_any<<<a.G, threads, shmem, stream>>>(a);
      break;
    case kVoteQuorum:
      if (shmem > 48 * 1024) {
        cudaFuncSetAttribute(vote_quorum_any,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
      }
      vote_quorum_any<<<a.G, threads, shmem, stream>>>(a);
      break;
    case kDispatch:
      dispatch_any<<<a.G, threads, sizeof(int), stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_mp_num_slots() { return NUM_SLOTS; }

// Launch one kernel. ptrs holds NUM_SLOTS device pointers (NULL where a
// kernel does not use the slot); ints = {G, W, t, f, retry_timeout,
// num_groups, age, gpb, route}. A in {3, 5, 7, 9} with W * gpb <= 1024
// runs the templated kernel, any other A >= 1 and W >= 1 the general one.
// The phase-1 kernel takes the route its wrapper chose instead (`Route`)
// and refuses the vector route unless W % 8 == 0 and every pointer is
// 16-byte aligned. Returns the CUDA error of the launch (0 = launched).
// Does not synchronise.
int fpx_mp_launch(int which, int A, void* const* ptrs, const int* ints,
                  void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.G = ints[0];
  a.W = ints[1];
  a.t = ints[2];
  a.f = ints[3];
  a.retry_timeout = ints[4];
  a.num_groups = ints[5];
  a.age = ints[6];
  a.gpb = ints[7];
  a.A = A;
  if (a.G <= 0) return 0;
  if (a.W <= 0 || A <= 0 || a.gpb <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == kP1Promise) {
    switch (ints[8]) {
      case kVector:
        if (a.W % 8 != 0 || !all_aligned16(a.p, NUM_SLOTS)) {
          return cudaErrorMisalignedAddress;
        }
        return launch_p1_vector(a, s);
      case kGeneral:
        return launch_any(which, a, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (static_cast<long long>(a.W) * a.gpb <= 1024) {
    switch (A) {
      case 3: return launch_a<3>(which, a, s);
      case 5: return launch_a<5>(which, a, s);
      case 7: return launch_a<7>(which, a, s);
      case 9: return launch_a<9>(which, a, s);
      default: break;
    }
  }
  return launch_any(which, a, s);
}

const char* fpx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
