// Hand-written Hopper (sm_90a) kernels for the Horizontal MultiPaxos vote
// plane.
//
//   fpx_horizontal_vote  replaces fused_horizontal_vote
//                        (frankenpaxos_tpu/ops/horizontal.py:154,
//                        pallas_call at :212): the acceptors of the slot's
//                        bank vote on the Phase2a messages that arrive now,
//                        schedule their Phase2b replies, the in-bank quorum
//                        count chooses, and the bank-isolation ledger counts
//                        the votes in the wrong bank.
//
// It computes exactly what reference_horizontal_vote in
// frankenpaxos_tpu_torch/ops/horizontal.py computes, bit for bit:
//   * the slot's bank is the FLOOR mod of its int16 epoch, so an empty
//     slot's -1 maps to bank 1 (C's % would give -1);
//   * a vote lands wherever a Phase2a arrives now in the slot's bank of a
//     PROPOSED slot, even where its Phase2b reply is dropped; the reply
//     tick t + lat is added in wrapping int32;
//   * the quorum counts the in-bank rows that voted and whose Phase2b has
//     arrived (p2b <= t), against the status BEFORE the update;
//   * the ledger counts votes outside the bank only of stamped slots
//     (epoch >= 0).
//
// Design. The slots are independent (the quorum and the ledger sum over
// the P = 2n pool rows of one slot), and the pool planes are row-major
// [P, G, W]: for a fixed row, neighbouring slots are neighbouring cells.
// The n = 3, 5, 7 banks (f = 1, 2, 3) are template parameters, so each
// row's bank is a compile-time constant, as in the Pallas kernel; any other
// n (f >= 4, as the JAX config accepts) runs the general instantiation of
// the same body, n read at run time. A null delivery pointer means every
// reply is delivered (the healthy tick passes no delivery plane). Two
// routes, the wrapper's choice (ops/horizontal.py horizontal_vote_route),
// checked here:
//
//   * vector (horizontal_vote_vec): two threads own kLanes = 4
//     consecutive slots (W % 4 == 0, so they lie in one group), one the
//     rows of bank 0 and the other those of bank 1; their quorum counts
//     and ledgers meet in a shuffle. Each moves its planes in vectors: 16
//     bytes of an int32 row, 8 of an int16 row, 4 of a byte row. It issues
//     the loads of all its bank's rows at once (up to kBatch; the vote, the
//     vote epoch and the Phase2b tick read whether or not a vote lands),
//     then the latencies of the rows where one of its slots gets a vote,
//     then computes and stores; the proposal ticks are read only where a
//     slot is newly chosen. Two or three trips to device memory a thread,
//     where the general kernel makes two a row. It takes 16-byte aligned
//     planes. Chip races (harness/chain_race.py) chose this over one
//     thread for both banks, over reading every latency and proposal tick
//     with the rest, over 2 or 8 slots a thread, and over an early return
//     of the threads past the last slot before their loads (about 40%
//     slower on the main inputs; the cause was not found).
//   * general (horizontal_vote_kernel, the kernel the route was first
//     written as, its pointers __restrict__): one thread per (g, w) slot
//     walks the 2n rows and reads a cell only where the function needs
//     it: the carried vote and vote epoch only where no vote lands now,
//     the latency and delivery bit only where one does, the carried
//     Phase2b tick only where no reply is scheduled, the proposal tick
//     only of a newly chosen slot.
//
// Bound. A few integer ops per byte: bound by the bytes moved. The bytes
// these inputs need (ops/horizontal.py horizontal_vote_needed_bytes) are
// 15.35 MB at (P, G, W) = (6, 3334, 32), 4.6 us at 3.35 TB/s; every input
// read once and every output written once is 18.46 MB (26 B per pool cell
// without a delivery plane, 17 B per slot); the vector route moves the
// needed bytes, every latency and proposal tick of a slot quad (16 bytes)
// of which one slot needs it, and the vote, vote epoch and Phase2b tick
// of every cell.

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 30;
constexpr int kProposed = 1;
constexpr int kChosen = 2;
// Consecutive slots a pair of threads of the vector route owns, and the
// pool rows of its bank a thread loads at once.
constexpr int kLanes = 4;
constexpr int kBatch = 6;

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/horizontal.py, _PTR_SLOTS).
enum Slot {
  SE, STATUS, PT, P2A, P2B, VOTED, VE, LAT, DELIV,
  O_STATUS, O_P2A, O_P2B, O_VOTED, O_VE, O_NEWLY, O_LAT, O_VIOL,
  NUM_SLOTS
};

// Routes, as the wrapper names them (ops/horizontal.py
// horizontal_vote_route; codes of ops/registry.py ROUTES).
enum Route { kGeneral = 1, kVector = 2 };

struct Args {
  void* p[NUM_SLOTS];
  int G, W, t, quorum;
  int n;  // bank size (read at run time by the general instantiation)
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// One pool cell after the vote: its Phase2a tick, Phase2b tick, vote and
// vote epoch. lat() and delivered() are called only where a vote lands,
// voted_in() and ve_in() only where none does, p2b_in() where none does
// or the reply is dropped (the general kernel loads a cell there).
struct Cell {
  int p2a_out, p2b;
  bool voted;
  int16_t ve;
};

template <typename Lat, typename Deliv, typename Voted, typename Ve,
          typename P2b>
__device__ __forceinline__ Cell vote_cell(
    int t, int p2a, bool row_matches, bool proposed, int16_t se, Lat lat,
    Deliv delivered, Voted voted_in, Ve ve_in, P2b p2b_in) {
  const bool p2a_now = p2a == t;
  const bool may_vote = p2a_now && row_matches && proposed;
  Cell c;
  c.p2a_out = p2a_now ? kInf : p2a;
  if (may_vote) {
    c.voted = true;
    c.ve = se;
    c.p2b = delivered() ? wadd(t, lat()) : p2b_in();
  } else {
    c.voted = voted_in();
    c.ve = ve_in();
    c.p2b = p2b_in();
  }
  return c;
}

// ---------------------------------------------------------------------------
// General route: any W, any alignment.
// ---------------------------------------------------------------------------

// N > 0: the templated kernel, n = N. N == 0: the general instantiation,
// n = a.n at run time (the same body, the row loop's bound a variable).
template <int N>
__device__ __forceinline__ void vote_general(
    const Args& a, const int16_t* __restrict__ se_in,
    const int8_t* __restrict__ status_in,
    const int* __restrict__ pt_in, const int* __restrict__ p2a_in,
    const int* __restrict__ p2b_in,
    const uint8_t* __restrict__ voted_in,
    const int16_t* __restrict__ ve_in,
    const int* __restrict__ lat_in,
    const uint8_t* __restrict__ deliv,
    int8_t* __restrict__ o_status, int* __restrict__ o_p2a,
    int* __restrict__ o_p2b, uint8_t* __restrict__ o_voted,
    int16_t* __restrict__ o_ve, uint8_t* __restrict__ o_newly,
    int* __restrict__ o_lat, int* __restrict__ o_viol) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t s = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= GW) return;
  const int t = a.t;
  const int16_t se = se_in[s];
  const int8_t status = status_in[s];
  const int slot_bank = floor_mod(se, 2);
  const bool proposed = status == kProposed;
  const bool epoch_set = se >= 0;
  const int n = N > 0 ? N : a.n;

  int votes_in = 0;
  int viol = 0;
#pragma unroll
  for (int p = 0; p < 2 * n; ++p) {
    const size_t i = p * GW + s;
    const bool row_matches = slot_bank == (p >= n ? 1 : 0);
    const Cell c = vote_cell(
        t, p2a_in[i], row_matches, proposed, se, [&] { return lat_in[i]; },
        [&] { return deliv == nullptr || deliv[i] != 0; },
        [&] { return voted_in[i] != 0; }, [&] { return ve_in[i]; },
        [&] { return p2b_in[i]; });
    o_p2a[i] = c.p2a_out;
    o_p2b[i] = c.p2b;
    o_voted[i] = c.voted;
    o_ve[i] = c.ve;
    votes_in += (c.p2b <= t && c.voted && row_matches) ? 1 : 0;
    viol += (c.voted && !row_matches && epoch_set) ? 1 : 0;
  }
  const bool newly = proposed && votes_in >= a.quorum;
  o_status[s] = newly ? static_cast<int8_t>(kChosen) : status;
  o_lat[s] = newly ? wsub(t, pt_in[s]) : 0;
  o_newly[s] = newly;
  o_viol[s] = viol;
}

template <int N>
__global__ void horizontal_vote_kernel(const Args a) {
  vote_general<N>(
      a, in<int16_t>(a, SE), in<int8_t>(a, STATUS), in<int>(a, PT),
      in<int>(a, P2A), in<int>(a, P2B), in<uint8_t>(a, VOTED),
      in<int16_t>(a, VE), in<int>(a, LAT), in<uint8_t>(a, DELIV),
      out<int8_t>(a, O_STATUS), out<int>(a, O_P2A), out<int>(a, O_P2B),
      out<uint8_t>(a, O_VOTED), out<int16_t>(a, O_VE),
      out<uint8_t>(a, O_NEWLY), out<int>(a, O_LAT), out<int>(a, O_VIOL));
}

// ---------------------------------------------------------------------------
// Vector route (module comment): kLanes slots a thread, rows in batches of
// kBatch, every load of a batch before its stores.
// ---------------------------------------------------------------------------

template <int B> struct VecOf;
template <> struct VecOf<4> { using T = unsigned; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<16> { using T = uint4; };

// kLanes values of E (one per slot of the thread), moved in vectors of at
// most 16 bytes.
template <typename E>
struct Lanes {
  static constexpr int kBytes = static_cast<int>(sizeof(E)) * kLanes;
  static constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  using Piece = typename VecOf<kPiece>::T;
  union {
    E e[kLanes];
    Piece v[kBytes / kPiece];
  };
  __device__ __forceinline__ void load(const E* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kPiece; ++i) {
      v[i] = reinterpret_cast<const Piece*>(p)[i];
    }
  }
  __device__ __forceinline__ void store(E* p) const {
#pragma unroll
    for (int i = 0; i < kBytes / kPiece; ++i) {
      reinterpret_cast<Piece*>(p)[i] = v[i];
    }
  }
};

template <int N>
__global__ void __launch_bounds__(256) horizontal_vote_vec(const Args a) {
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Threads 2k and 2k + 1 own the same kLanes slots; each takes the rows
  // of one bank, and their counts meet in a shuffle. A thread past the
  // last slot runs on to the shuffle with its loads and stores masked.
  const int bank = static_cast<int>(tid & 1);
  const size_t s = (tid >> 1) * kLanes;
  const bool active = s < GW;
  const int t = a.t;
  const int n = N > 0 ? N : a.n;
  const int p_end = (bank + 1) * n;
  const int* __restrict__ p2a_in = in<int>(a, P2A);
  const int* __restrict__ p2b_in = in<int>(a, P2B);
  const uint8_t* __restrict__ voted_in = in<uint8_t>(a, VOTED);
  const int16_t* __restrict__ ve_in = in<int16_t>(a, VE);
  const int* __restrict__ lat_in = in<int>(a, LAT);
  const uint8_t* __restrict__ deliv_in = in<uint8_t>(a, DELIV);

  Lanes<int16_t> se;
  Lanes<int8_t> status;
  if (active) {
    se.load(in<int16_t>(a, SE) + s);
    status.load(in<int8_t>(a, STATUS) + s);
  }
  int votes_in[kLanes] = {};
  int viol[kLanes] = {};

  for (int p0 = bank * n; p0 < p_end; p0 += kBatch) {
    // Every plane's loads of the batch's rows but the latencies.
    Lanes<int> p2a[kBatch], p2b[kBatch], lat[kBatch];
    Lanes<uint8_t> voted[kBatch], deliv[kBatch];
    Lanes<int16_t> ve[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const size_t i = (p0 + b) * GW + s;
      if (active && p0 + b < p_end) {
        p2a[b].load(p2a_in + i);
        p2b[b].load(p2b_in + i);
        voted[b].load(voted_in + i);
        ve[b].load(ve_in + i);
        if (deliv_in != nullptr) deliv[b].load(deliv_in + i);
      }
    }
    // The latencies of the rows where a vote lands.
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      bool any = false;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        any |= p2a[b].e[l] == t && status.e[l] == kProposed &&
               floor_mod(se.e[l], 2) == bank;
      }
      if (active && p0 + b < p_end && any) {
        lat[b].load(lat_in + (p0 + b) * GW + s);
      }
    }
    // The votes, then the batch's stores.
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = p0 + b;
      if (!active || p >= p_end) continue;
      const size_t i = p * GW + s;
      Lanes<int> o_p2a, o_p2b;
      Lanes<uint8_t> o_voted;
      Lanes<int16_t> o_ve;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const bool row_matches = floor_mod(se.e[l], 2) == bank;
        const Cell c = vote_cell(
            t, p2a[b].e[l], row_matches, status.e[l] == kProposed, se.e[l],
            [&] { return lat[b].e[l]; },
            [&] { return deliv_in == nullptr || deliv[b].e[l] != 0; },
            [&] { return voted[b].e[l] != 0; }, [&] { return ve[b].e[l]; },
            [&] { return p2b[b].e[l]; });
        o_p2a.e[l] = c.p2a_out;
        o_p2b.e[l] = c.p2b;
        o_voted.e[l] = c.voted;
        o_ve.e[l] = c.ve;
        votes_in[l] += (c.p2b <= t && c.voted && row_matches) ? 1 : 0;
        viol[l] += (c.voted && !row_matches && se.e[l] >= 0) ? 1 : 0;
      }
      o_p2a.store(out<int>(a, O_P2A) + i);
      o_p2b.store(out<int>(a, O_P2B) + i);
      o_voted.store(out<uint8_t>(a, O_VOTED) + i);
      o_ve.store(out<int16_t>(a, O_VE) + i);
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    votes_in[l] += __shfl_xor_sync(0xffffffffu, votes_in[l], 1);
    viol[l] += __shfl_xor_sync(0xffffffffu, viol[l], 1);
  }
  if (!active || bank != 0) return;

  // The slots' outputs, the proposal ticks read only where one is newly
  // chosen.
  bool newly[kLanes];
  bool any = false;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    newly[l] = status.e[l] == kProposed && votes_in[l] >= a.quorum;
    any |= newly[l];
  }
  Lanes<int> pt;
  if (any) pt.load(in<int>(a, PT) + s);
  Lanes<int8_t> o_status;
  Lanes<uint8_t> o_newly;
  Lanes<int> o_lat, o_viol;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    o_status.e[l] = newly[l] ? static_cast<int8_t>(kChosen) : status.e[l];
    o_lat.e[l] = newly[l] ? wsub(t, pt.e[l]) : 0;
    o_newly.e[l] = newly[l];
    o_viol.e[l] = viol[l];
  }
  o_status.store(out<int8_t>(a, O_STATUS) + s);
  o_newly.store(out<uint8_t>(a, O_NEWLY) + s);
  o_lat.store(out<int>(a, O_LAT) + s);
  o_viol.store(out<int>(a, O_VIOL) + s);
}

template <int N>
void launch_route(int route, size_t GW, int threads, cudaStream_t st,
                  const Args& a) {
  if (route == kVector) {
    const size_t groups = GW / kLanes * 2;  // two threads a slot group
    const unsigned grid =
        static_cast<unsigned>((groups + threads - 1) / threads);
    horizontal_vote_vec<N><<<grid, threads, 0, st>>>(a);
  } else {
    const unsigned grid = static_cast<unsigned>((GW + threads - 1) / threads);
    horizontal_vote_kernel<N><<<grid, threads, 0, st>>>(a);
  }
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_horizontal_num_slots() { return NUM_SLOTS; }

// Launch the vote kernel. ptrs holds NUM_SLOTS device pointers (DELIV may
// be null: every reply delivered); ints = {n, G, W, t, quorum, threads per
// block, route (`Route`)}; the pool has 2n rows. n in {3, 5, 7} runs a
// templated kernel, any other n >= 1 the general one. The vector route is
// refused unless W % kLanes == 0, threads is a multiple of 32 up to 256
// (a warp's shuffles pair its threads) and every pointer is 16-byte
// aligned. Returns the CUDA error of the launch (0 = launched).
// Does not synchronise.
int fpx_horizontal_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  const int n = ints[0];
  a.n = n;
  a.G = ints[1];
  a.W = ints[2];
  a.t = ints[3];
  a.quorum = ints[4];
  const int threads = ints[5];
  const int route = ints[6];
  if (a.G <= 0 || a.W <= 0) return 0;
  if (n <= 0 || threads < 32 || threads > 1024) return cudaErrorInvalidValue;
  if (route == kVector) {
    if (a.W % kLanes || threads > 256 || threads % 32 ||
        !all_aligned16(a.p, NUM_SLOTS)) {
      return cudaErrorInvalidValue;
    }
  } else if (route != kGeneral) {
    return cudaErrorInvalidValue;
  }
  const size_t GW = static_cast<size_t>(a.G) * a.W;
  if ((GW + threads - 1) / threads > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3: launch_route<3>(route, GW, threads, st, a); break;
    case 5: launch_route<5>(route, GW, threads, st, a); break;
    case 7: launch_route<7>(route, GW, threads, st, a); break;
    default: launch_route<0>(route, GW, threads, st, a); break;
  }
  return cudaGetLastError();
}

}  // extern "C"
