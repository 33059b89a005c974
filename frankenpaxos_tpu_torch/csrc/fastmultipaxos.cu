// Hand-written Hopper (sm_90a) kernels for the Fast MultiPaxos vote plane.
//
//   fpx_fmp_vote  replaces fused_fmp_vote
//                 (frankenpaxos_tpu/ops/fastmultipaxos.py:266, pallas_call
//                 at :339): per slot, the leader's vote census (visible
//                 votes, pairwise same-value counts, the first-max value
//                 among visible votes and among all votes), the
//                 fast-committed ledger, the fast choose or the start of
//                 classic recovery, the classic round's votes and f+1
//                 quorum, the chosen stamps and the safety ledger.
//
// It computes exactly what reference_fmp_vote in
// frankenpaxos_tpu_torch/ops/fastmultipaxos.py computes, bit for bit:
//   * the first maximum of jnp.argmax, by strict-> scans from a -1 floor,
//     so acceptor 0's value seeds both scans even when its count is 0 (a
//     recovery started from an all-distinct census proposes acceptor 0's
//     value, and rv_value shows it);
//   * the != NO_VALUE test is on the second vote of a pair (vv[y]);
//   * value_now reads the PRE-update rv_value;
//   * a slot that starts recovery has its classic Phase2a arrival set to
//     t + rv_lat BEFORE the == t test, so it votes this tick only if
//     rv_lat == 0;
//   * ticks are added and subtracted in wrapping int32 (INF is 2^30, so
//     t - open_tick is negative for an unopened slot).
//
// Design. The [A, G, W] planes are acceptor-major: for each acceptor,
// neighbouring slots are neighbouring cells. A in {3, 5, 7, 9} (f <= 4) is
// a template parameter, so a slot's A votes and seen ticks sit in
// registers and the A x A pairwise counts are unrolled; any other A (f >=
// 5, as the JAX config accepts) runs the general kernel's instantiation
// with A at run time. Two routes, the wrapper's choice
// (ops/fastmultipaxos.py fmp_vote_route: scalar for every A in {3, 5, 7,
// 9}), checked here:
//
//   * scalar (fmp_vote_scalar): a thread a slot, A in {3, 5, 7, 9}. One
//     trip loads every dense field of all A acceptors before any store:
//     the votes, seen ticks, classic Phase2a and Phase2b ticks and classic
//     vote bits, and the slot's status, open tick, fast-committed value,
//     classic value, chosen value and replica arrival. A second trip loads
//     the sparse fields: the classic latency where recovery starts or a
//     classic Phase2a arrives now, and the reply latency where the slot is
//     chosen this tick whatever that latency is (fast, or by votes already
//     in). A third trip, for a slot chosen only through a Phase2b that
//     lands this tick (a classic latency <= 0; none on the main path),
//     loads its reply latency. Threads past the last slot are masked, not
//     returned. A chip race (harness/chain_race.py) chose one slot a
//     thread over 2 and 4 consecutive slots a thread in 8- and 16-byte
//     vectors, which were slower at the main path's shapes, and over
//     reading the classic Phase2a rows in the second trip (PERF.md).
//   * general (fmp_vote_kernel, the kernel the route was first written
//     as, its pointers __restrict__): one thread per (g, w) slot, reading
//     a classic Phase2a arrival only where recovery does not overwrite it,
//     the classic latency only where recovery starts or a classic Phase2a
//     arrives now, the carried Phase2b cell only where nothing arrives
//     now, the carried chosen stamps only where the slot is not chosen
//     now, the reply latency only where it is. Its instantiations for A in
//     {3, 5, 7, 9} are reached only through the route code (the chip race
//     times them beside the scalar route).
//
// Bound. A few dozen integer ops per slot against ~120 bytes: bound by the
// bytes moved. The bytes the function needs (ops/fastmultipaxos.py
// fmp_vote_needed_bytes: what the general route reads, and every output)
// are 13.0 MB at (A, G, W) = (3, 3334, 32) on the kernels line's inputs,
// 3.9 us at 3.35 TB/s; the scalar route moves 13.4 MB
// (fmp_vote_route_bytes), every input and output once is 14.1 MB.

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 30;
constexpr int kNoValue = -1;
constexpr int kOpen = 0;
constexpr int kRecover = 1;
constexpr int kChosen = 2;

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/fastmultipaxos.py, _PTR_SLOTS).
enum Slot {
  VV, VS, STATUS, OT, FC, RVV, RP2A, RP2B, RVOTED, CV, RA, RVLAT, REPLYLAT,
  O_STATUS, O_OT, O_FC, O_RVV, O_RP2A, O_RP2B, O_RVOTED, O_CV, O_RA,
  O_NEWLY, O_FAST, O_REC, O_SAFETY,
  NUM_SLOTS
};

// Routes, as the wrapper names them (ops/fastmultipaxos.py
// fmp_vote_route; codes of ops/registry.py ROUTES).
enum Route { kScalar = 0, kGeneral = 1 };

struct Args {
  void* p[NUM_SLOTS];
  int G, W, t, fq, f, recovery_timeout;
  int A;  // acceptors (read at run time by the general instantiation)
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// ---------------------------------------------------------------------------
// The per-slot steps, shared by both routes. vote(k) and seen(k) give
// acceptor k's fast-round vote and whether the leader sees it by t.
// ---------------------------------------------------------------------------

// 2. The census of the slot's column and the leader's decisions.
struct Census {
  int8_t status;  // after the start of recovery
  int open_tick, fc, best_value;
  bool fast_ok, start_rec;
};

template <int AT, typename Vote, typename Seen>
__device__ __forceinline__ Census census(const Args& a, int8_t status,
                                         int open_tick, int fc, Vote vote,
                                         Seen seen) {
  const int t = a.t;
  const int A = AT > 0 ? AT : a.A;
  int n_visible = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) n_visible += seen(k) ? 1 : 0;
  if (open_tick == kInf && n_visible > 0 && status == kOpen) open_tick = t;

  int best_count = -1, best_value = vote(0);
  int full_count = -1, full_value = vote(0);
#pragma unroll
  for (int x = 0; x < A; ++x) {
    const int vx = vote(x);
    const bool sx = seen(x);
    int cnt = 0, cnt_all = 0;
#pragma unroll
    for (int y = 0; y < A; ++y) {
      const int vy = vote(y);
      const bool pair = vx == vy && vy != kNoValue;
      cnt_all += pair ? 1 : 0;
      cnt += (pair && sx && seen(y)) ? 1 : 0;
    }
    if (cnt > best_count) {
      best_count = cnt;
      best_value = vx;
    }
    if (cnt_all > full_count) {
      full_count = cnt_all;
      full_value = vx;
    }
  }
  Census c;
  c.fc = (fc == kNoValue && full_count >= a.fq) ? full_value : fc;
  c.fast_ok = status == kOpen && best_count >= a.fq;
  const bool census_full = n_visible >= A;
  const bool timed_out = open_tick < kInf &&
                         wsub(t, open_tick) >= a.recovery_timeout &&
                         n_visible >= A - a.f;
  c.start_rec = status == kOpen && !c.fast_ok && (census_full || timed_out);
  c.status = c.start_rec ? static_cast<int8_t>(kRecover) : status;
  c.open_tick = open_tick;
  c.best_value = best_value;
  return c;
}

// 3. One acceptor's classic round: r is its classic Phase2a arrival (the
// recovery's t + rv_lat where it starts now), t_lat = t + rv_lat.
// voted_in() and p2b_in() are called only where nothing arrives now.
struct RvCell {
  int p2a_out, p2b;
  bool voted;
};

template <typename Voted, typename P2b>
__device__ __forceinline__ RvCell rv_cell(int t, int r, int t_lat,
                                          Voted voted_in, P2b p2b_in) {
  RvCell c;
  const bool now = r == t;
  c.voted = now ? true : voted_in();
  c.p2b = now ? t_lat : p2b_in();
  c.p2a_out = now ? kInf : r;
  return c;
}

__device__ __forceinline__ bool rv_counts(const RvCell& c, int t) {
  return c.voted && c.p2b <= t;
}

// The choose, the stamps and the ledger check. cv_in() and ra_in() are
// called only where the slot is not chosen now, reply_lat() only where it
// is.
struct SlotOut {
  int8_t status;
  int rvv, cv, ra;
  bool newly, safety;
};

template <typename Cv, typename Ra, typename ReplyLat>
__device__ __forceinline__ SlotOut choose(const Args& a, const Census& c,
                                          int rv_old, bool newly, Cv cv_in,
                                          Ra ra_in, ReplyLat reply_lat) {
  SlotOut o;
  const int value_now = c.fast_ok ? c.best_value : rv_old;
  o.newly = newly;
  o.rvv = c.start_rec ? c.best_value : rv_old;
  o.cv = newly ? value_now : cv_in();
  o.ra = newly ? wadd(a.t, reply_lat()) : ra_in();
  o.status = newly ? static_cast<int8_t>(kChosen) : c.status;
  o.safety = newly && c.fc != kNoValue && value_now != c.fc;
  return o;
}

__device__ __forceinline__ bool chosen(const Args& a, const Census& c,
                                       int n_rv) {
  return c.fast_ok || (c.status == kRecover && n_rv >= a.f + 1);
}

// ---------------------------------------------------------------------------
// General route: any W, any alignment.
// ---------------------------------------------------------------------------

// AT > 0: the templated kernel, A = AT, the slot's column in registers.
// AT == 0: the general instantiation, A = a.A at run time; the column is
// read from global memory where the templated kernel reads its registers
// (the A x A census then re-reads the A votes, from L1).
template <int AT>
__global__ void fmp_vote_kernel(const Args a) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t s = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= GW) return;
  const int* __restrict__ vv_in = in<int>(a, VV);
  const int* __restrict__ vs_in = in<int>(a, VS);
  const int8_t* __restrict__ status_in = in<int8_t>(a, STATUS);
  const int* __restrict__ ot_in = in<int>(a, OT);
  const int* __restrict__ fc_in = in<int>(a, FC);
  const int* __restrict__ rvv_in = in<int>(a, RVV);
  const int* __restrict__ rp2a_in = in<int>(a, RP2A);
  const int* __restrict__ rp2b_in = in<int>(a, RP2B);
  const uint8_t* __restrict__ rvoted_in = in<uint8_t>(a, RVOTED);
  const int* __restrict__ cv_in = in<int>(a, CV);
  const int* __restrict__ ra_in = in<int>(a, RA);
  const int* __restrict__ rvlat_in = in<int>(a, RVLAT);
  const int* __restrict__ replylat_in = in<int>(a, REPLYLAT);
  int8_t* __restrict__ o_status = out<int8_t>(a, O_STATUS);
  int* __restrict__ o_ot = out<int>(a, O_OT);
  int* __restrict__ o_fc = out<int>(a, O_FC);
  int* __restrict__ o_rvv = out<int>(a, O_RVV);
  int* __restrict__ o_rp2a = out<int>(a, O_RP2A);
  int* __restrict__ o_rp2b = out<int>(a, O_RP2B);
  uint8_t* __restrict__ o_rvoted = out<uint8_t>(a, O_RVOTED);
  int* __restrict__ o_cv = out<int>(a, O_CV);
  int* __restrict__ o_ra = out<int>(a, O_RA);
  uint8_t* __restrict__ o_newly = out<uint8_t>(a, O_NEWLY);
  uint8_t* __restrict__ o_fast = out<uint8_t>(a, O_FAST);
  uint8_t* __restrict__ o_rec = out<uint8_t>(a, O_REC);
  uint8_t* __restrict__ o_safety = out<uint8_t>(a, O_SAFETY);
  const int t = a.t;
  const int A = AT > 0 ? AT : a.A;
  constexpr int R = AT > 0 ? AT : 1;

  int vv_r[R];
  bool vis_r[R];
  if constexpr (AT > 0) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      vv_r[k] = vv_in[k * GW + s];
      vis_r[k] = vs_in[k * GW + s] <= t;
    }
  }
  const Census c = census<AT>(
      a, status_in[s], ot_in[s], fc_in[s],
      [&](int k) -> int {
        if constexpr (AT > 0) {
          return vv_r[k];
        } else {
          return vv_in[k * GW + s];
        }
      },
      [&](int k) -> bool {
        if constexpr (AT > 0) {
          return vis_r[k];
        } else {
          return vs_in[k * GW + s] <= t;
        }
      });
  const int rv_old = rvv_in[s];

  // The classic Phase2a arrival of acceptor k: the recovery's when it
  // starts now, else the carried one.
  int t_lat = c.start_rec ? wadd(t, rvlat_in[s]) : 0;
  int rp2a_r[R];
  bool any_now = false;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const int r = c.start_rec ? t_lat : rp2a_in[k * GW + s];
    if constexpr (AT > 0) rp2a_r[k] = r;
    any_now = any_now || r == t;
  }
  if (any_now && !c.start_rec) t_lat = wadd(t, rvlat_in[s]);
  int n_rv = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const size_t i = k * GW + s;
    int r;
    if constexpr (AT > 0) {
      r = rp2a_r[k];
    } else {
      r = c.start_rec ? t_lat : rp2a_in[i];
    }
    const RvCell cell = rv_cell(
        t, r, t_lat, [&] { return rvoted_in[i] != 0; },
        [&] { return rp2b_in[i]; });
    o_rp2a[i] = cell.p2a_out;
    o_rp2b[i] = cell.p2b;
    o_rvoted[i] = cell.voted;
    n_rv += rv_counts(cell, t) ? 1 : 0;
  }

  const SlotOut o = choose(
      a, c, rv_old, chosen(a, c, n_rv), [&] { return cv_in[s]; },
      [&] { return ra_in[s]; }, [&] { return replylat_in[s]; });
  o_rvv[s] = o.rvv;
  o_cv[s] = o.cv;
  o_ra[s] = o.ra;
  o_status[s] = o.status;
  o_ot[s] = c.open_tick;
  o_fc[s] = c.fc;
  o_newly[s] = o.newly;
  o_fast[s] = c.fast_ok;
  o_rec[s] = c.start_rec;
  o_safety[s] = o.safety;
}

// ---------------------------------------------------------------------------
// Scalar route (module comment): a thread a slot, every dense load before
// any store.
// ---------------------------------------------------------------------------

template <int A>
__global__ void __launch_bounds__(256) fmp_vote_scalar(const Args a) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t s = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = s < GW;
  const int t = a.t;

  // Trip 1: every dense field.
  int vv[A] = {}, vs[A] = {}, rp2a[A] = {}, rp2b[A] = {};
  bool rvoted[A] = {};
  int8_t status = 0;
  int ot = 0, fc = 0, rvv = 0, cv = 0, ra = 0;
  if (active) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const size_t i = k * GW + s;
      vv[k] = in<int>(a, VV)[i];
      vs[k] = in<int>(a, VS)[i];
      rp2a[k] = in<int>(a, RP2A)[i];
      rp2b[k] = in<int>(a, RP2B)[i];
      rvoted[k] = in<uint8_t>(a, RVOTED)[i] != 0;
    }
    status = in<int8_t>(a, STATUS)[s];
    ot = in<int>(a, OT)[s];
    fc = in<int>(a, FC)[s];
    rvv = in<int>(a, RVV)[s];
    cv = in<int>(a, CV)[s];
    ra = in<int>(a, RA)[s];
  }
  const Census c = census<A>(
      a, status, ot, fc, [&](int k) { return vv[k]; },
      [&](int k) { return vs[k] <= t; });

  // Whether the slot needs its classic latency (recovery starts, or a
  // carried classic Phase2a arrives now), and whether it is chosen
  // whatever that latency is.
  bool any_now = false;
  int n_sure = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const bool now = !c.start_rec && rp2a[k] == t;
    any_now |= now;
    n_sure += (!now && rvoted[k] && rp2b[k] <= t) ? 1 : 0;
  }
  const bool sure = chosen(a, c, n_sure);
  // Trip 2: the sparse latencies.
  const int rv_lat =
      (active && (c.start_rec || any_now)) ? in<int>(a, RVLAT)[s] : 0;
  int reply = (active && sure) ? in<int>(a, REPLYLAT)[s] : 0;

  // The classic round.
  const int t_lat = wadd(t, rv_lat);
  RvCell cell[A];
  int n_rv = 0;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    cell[k] = rv_cell(
        t, c.start_rec ? t_lat : rp2a[k], t_lat, [&] { return rvoted[k]; },
        [&] { return rp2b[k]; });
    n_rv += rv_counts(cell[k], t) ? 1 : 0;
  }
  const bool newly = chosen(a, c, n_rv);
  // Trip 3 (a Phase2b that lands this tick chose the slot).
  if (active && newly && !sure) reply = in<int>(a, REPLYLAT)[s];
  const SlotOut o = choose(
      a, c, rvv, newly, [&] { return cv; }, [&] { return ra; },
      [&] { return reply; });
  if (!active) return;
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const size_t i = k * GW + s;
    out<int>(a, O_RP2A)[i] = cell[k].p2a_out;
    out<int>(a, O_RP2B)[i] = cell[k].p2b;
    out<uint8_t>(a, O_RVOTED)[i] = cell[k].voted;
  }
  out<int8_t>(a, O_STATUS)[s] = o.status;
  out<int>(a, O_OT)[s] = c.open_tick;
  out<int>(a, O_FC)[s] = c.fc;
  out<int>(a, O_RVV)[s] = o.rvv;
  out<int>(a, O_CV)[s] = o.cv;
  out<int>(a, O_RA)[s] = o.ra;
  out<uint8_t>(a, O_NEWLY)[s] = o.newly;
  out<uint8_t>(a, O_FAST)[s] = c.fast_ok;
  out<uint8_t>(a, O_REC)[s] = c.start_rec;
  out<uint8_t>(a, O_SAFETY)[s] = o.safety;
}

template <int A>
void launch_scalar(size_t GW, int threads, cudaStream_t st, const Args& a) {
  const unsigned grid = static_cast<unsigned>((GW + threads - 1) / threads);
  fmp_vote_scalar<A><<<grid, threads, 0, st>>>(a);
}

template <int AT>
void launch_general(size_t GW, int threads, cudaStream_t st, const Args& a) {
  const unsigned grid = static_cast<unsigned>((GW + threads - 1) / threads);
  fmp_vote_kernel<AT><<<grid, threads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_fmp_num_slots() { return NUM_SLOTS; }

// Launch the vote kernel. ptrs holds NUM_SLOTS device pointers;
// ints = {A, G, W, t, fq, f, recovery_timeout, threads per block, route
// (`Route`)}. The scalar route is refused unless A is in {3, 5, 7, 9} and
// threads is a multiple of 32 up to 256; the general route runs A in {3,
// 5, 7, 9} templated and any other A >= 1 at run time. Returns the CUDA
// error of the launch (0 = launched). Does not synchronise.
int fpx_fmp_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  const int A = ints[0];
  a.A = A;
  a.G = ints[1];
  a.W = ints[2];
  a.t = ints[3];
  a.fq = ints[4];
  a.f = ints[5];
  a.recovery_timeout = ints[6];
  const int threads = ints[7];
  const int route = ints[8];
  if (a.G <= 0 || a.W <= 0) return 0;
  if (A <= 0 || threads < 32 || threads > 1024) return cudaErrorInvalidValue;
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  if ((GW + threads - 1) / threads > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kScalar) {
    if (threads > 256 || threads % 32) return cudaErrorInvalidValue;
    switch (A) {
      case 3: launch_scalar<3>(GW, threads, st, a); break;
      case 5: launch_scalar<5>(GW, threads, st, a); break;
      case 7: launch_scalar<7>(GW, threads, st, a); break;
      case 9: launch_scalar<9>(GW, threads, st, a); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (route == kGeneral) {
    switch (A) {
      case 3: launch_general<3>(GW, threads, st, a); break;
      case 5: launch_general<5>(GW, threads, st, a); break;
      case 7: launch_general<7>(GW, threads, st, a); break;
      case 9: launch_general<9>(GW, threads, st, a); break;
      default: launch_general<0>(GW, threads, st, a); break;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
