// Hand-written Hopper (sm_90a) kernels for the CRAQ chain plane.
//
//   fpx_craq_chain  replaces fused_craq_chain
//                   (frankenpaxos_tpu/ops/craq.py:252, pallas_call at :309):
//                   DOWN writes join the pending sets of mid-chain nodes and
//                   forward, the tail applies and starts the ack, UP acks
//                   apply, leave the pending set and propagate, the head's
//                   ack retires the ring slot; hops into a cut-side node
//                   while a partition is live wait for its heal tick.
//
// It computes exactly what reference_craq_chain in
// frankenpaxos_tpu_torch/ops/craq.py computes, bit for bit:
//   * per write slot, in the reference's order: the DOWN add of at_mid at
//     wslot = node * KV + key with the node BEFORE the advance, the tail's
//     version max at the same column, wlat = t + lat - issue, the advance
//     (mid: node + 1; tail: tail - 1 and status UP), the new arrival through
//     the hop deferral; then UP arrivals judged on the post-DOWN status and
//     arrival at uslot = node' * KV + key (version max, dirty - 1), and
//     retirement at node 0 (status EMPTY, arrival INF = 2^30) or the next
//     hop toward the head;
//   * a node-slot column outside [0, L*KV) is dropped, as a JAX scatter
//     drops an out-of-range index, and never written;
//   * ticks and columns are int32 arithmetic that wraps (common.cuh).
//
// Design. The Pallas kernel's [BN, L*KV] one-hot accumulation over all W
// ring slots is a TPU device to avoid scatters; here every write slot
// updates its own node columns directly. The slots are independent: within
// a chain the node planes are written but never read for a decision, so a
// slot's DOWN step and then its UP step depend on that slot alone, and the
// only shared effects are int32 adds (dirty) and maxes (version) into the
// chain's own row, which commute: integer atomics give the same sum and
// max in any order, so the result does not depend on the schedule. The
// caller's node planes are never written: the State a tick starts from
// stays as it was. Under a live partition the side bits come as an [L]
// int8 device array (chain_len is unbounded), heal as a runtime int (INF
// when the cut never heals). Two routes, the wrapper's choice
// (ops/craq.py craq_chain_route), checked here:
//
//   * vector (craq_chain_vec): a CTA takes `cpb` whole chains (the
//     wrapper's choice from W and L*KV, ops/craq.py chain_launch_shape: at
//     the main shape 2 chains a CTA of 32 threads, four 16-byte vectors of
//     each row a thread, which chip races chose over 1, 4 and 8 chains and
//     32-128 threads). Every thread first issues all its loads: up to
//     kRowVecs 16-byte vectors of each node row and, for a thread with a
//     write slot, all seven of the slot's fields, read whether or not the
//     slot arrives. No store comes before them, so every load of a CTA is
//     in flight at once. The rows go to shared memory, the slots apply
//     their adds and maxes there with shared atomics, and the rows stream
//     out in 16-byte stores. Two trips to device memory a thread, where
//     the general kernel makes about seven (its copy loop cannot move a
//     load above the store before it without __restrict__, and the slot
//     fields load behind one another), and the atomics never touch device
//     memory. It takes L*KV % 4 == 0, W <= 1024 (one slot a thread),
//     8 * cpb * L*KV bytes of shared memory up to 48 KB (L*KV <= 6144) and
//     16-byte aligned node planes.
//   * general (craq_chain_kernel, the kernel the route was first written
//     as, its pointers __restrict__): any shape. Its threads copy the
//     chains' two node rows to the output planes (16-byte vectors where
//     the rows allow it), then, after one barrier, run one thread per
//     write slot and apply the adds and maxes with atomics on the output
//     rows in device memory.
//
// Bound. Bytes: the two node planes in and out (16 B a node slot) and
// what the slots need (ops/craq.py craq_chain_needed_bytes: 4 x 13 B a
// slot always, its key, version and issue tick only where used, 14 B
// out). At the main shape (N, W, L*KV) = (2500, 16, 256) 11.37 of the
// 11.8 MB all inputs and outputs hold on the seed-7 inputs, 3.4 us at
// 3.35 TB/s. The copy of the node planes is most of it; the atomics touch
// a few columns a chain.

#include "common.cuh"

namespace {

constexpr int kInf = 1 << 30;
constexpr int kEmpty = 0;
constexpr int kDown = 1;
constexpr int kUp = 2;
// 16-byte vectors of each node plane a thread of the vector route holds.
constexpr int kRowVecs = 4;
// Shared memory of the vector route's CTA (its two node rows) at most.
constexpr int kVecSharedBytes = 48 * 1024;

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/craq.py, _PTR_SLOTS). SIDE is null unless a
// partition is live this tick.
enum Slot {
  WS, WK, WV, WN, WA, WI, DIRTY, VER, LAT, SIDE,
  O_WS, O_WN, O_WA, O_DIRTY, O_VER, O_AT_TAIL, O_WLAT,
  NUM_SLOTS
};

// Routes, as the wrapper names them (ops/craq.py craq_chain_route; codes
// of ops/registry.py ROUTES).
enum Route { kGeneral = 1, kVector = 2 };

struct Args {
  void* p[NUM_SLOTS];
  int N, W, LKV, KV, tail, t, num_sides, heal, cpb;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// faults.defer_to_heal of a hop into `node` (a target outside [0, L) is
// never on the cut side).
__device__ __forceinline__ int hop(const Args& a, int arrival, int node) {
  if (a.num_sides == 0 || node < 0 || node >= a.num_sides) return arrival;
  if (in<int8_t>(a, SIDE)[node] != 1) return arrival;
  return arrival > a.heal ? arrival : a.heal;
}

__device__ __forceinline__ bool in_row(const Args& a, int col) {
  return col >= 0 && col < a.LKV;
}

// A write slot after the tick's DOWN and UP steps.
struct SlotOut {
  int8_t ws;
  int wn, wa, wlat;
  bool at_tail;
};

// One write slot's DOWN step and then its UP step, in the reference's
// order, with the adds and maxes applied to the chain's rows `dirty` and
// `ver` (device or shared memory) by atomics. The slot's key, version and
// issue tick come from key(), version() and issue(): the general kernel
// loads them only where the slot uses them, the vector route has them.
template <typename Key, typename Version, typename Issue>
__device__ __forceinline__ SlotOut slot_step(
    const Args& a, int8_t ws, int wa, int wn, int lat, Key key,
    Version version, Issue issue, int* dirty, int* ver) {
  const int t = a.t;
  const int tail = a.tail;
  const int t_lat = wadd(t, lat);

  // DOWN arrivals.
  const bool arrive_down = ws == kDown && wa == t;
  const bool at_mid = arrive_down && wn < tail;
  const bool at_tail = arrive_down && wn == tail;
  int wk = 0, wv = 0, wlat = 0;
  if (arrive_down) {
    wk = key();
    const int wslot = wadd(static_cast<int>(static_cast<unsigned>(wn) *
                                            static_cast<unsigned>(a.KV)),
                           wk);
    if (at_mid && in_row(a, wslot)) atomicAdd(&dirty[wslot], 1);
    if (at_tail) {
      wv = version();
      if (in_row(a, wslot)) atomicMax(&ver[wslot], wv);
      wlat = wsub(t_lat, issue());
    }
  }
  int wn1 = wn;
  if (at_mid) wn1 = wadd(wn, 1);
  if (at_tail) wn1 = tail - 1;
  const int8_t ws1 = at_tail ? static_cast<int8_t>(kUp) : ws;
  const int wa1 = arrive_down ? hop(a, t_lat, wn1) : wa;

  // UP (ack) arrivals, on the post-DOWN status and arrival.
  const bool arrive_up = ws1 == kUp && wa1 == t;
  SlotOut o{ws1, wn1, wa1, wlat, at_tail};
  if (arrive_up) {
    if (!arrive_down) wk = key();
    if (!at_tail) wv = version();
    const int uslot = wadd(static_cast<int>(static_cast<unsigned>(wn1) *
                                            static_cast<unsigned>(a.KV)),
                           wk);
    if (in_row(a, uslot)) {
      atomicMax(&ver[uslot], wv);
      atomicAdd(&dirty[uslot], -1);
    }
    if (wn1 == 0) {
      o.ws = static_cast<int8_t>(kEmpty);
      o.wa = kInf;
    } else {
      o.wn = wsub(wn1, 1);
      o.wa = hop(a, t_lat, o.wn);
    }
  }
  return o;
}

// ---------------------------------------------------------------------------
// General route: any shape.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void copy_rows(
    const int* __restrict__ dirty, const int* __restrict__ ver,
    int* __restrict__ o_dirty, int* __restrict__ o_ver,
    size_t count) {
  const bool vec = count % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dirty) |
                     reinterpret_cast<uintptr_t>(ver) |
                     reinterpret_cast<uintptr_t>(o_dirty) |
                     reinterpret_cast<uintptr_t>(o_ver)) & 15) == 0;
  if (vec) {
    const int4* d4 = reinterpret_cast<const int4*>(dirty);
    const int4* v4 = reinterpret_cast<const int4*>(ver);
    int4* od4 = reinterpret_cast<int4*>(o_dirty);
    int4* ov4 = reinterpret_cast<int4*>(o_ver);
    for (size_t i = threadIdx.x; i < count / 4; i += blockDim.x) {
      od4[i] = d4[i];
      ov4[i] = v4[i];
    }
  } else {
    for (size_t i = threadIdx.x; i < count; i += blockDim.x) {
      o_dirty[i] = dirty[i];
      o_ver[i] = ver[i];
    }
  }
}

__device__ __forceinline__ void chain_general(
    const Args& a, const int8_t* __restrict__ ws_in,
    const int* __restrict__ wk_in, const int* __restrict__ wv_in,
    const int* __restrict__ wn_in, const int* __restrict__ wa_in,
    const int* __restrict__ wi_in, const int* __restrict__ dirty_in,
    const int* __restrict__ ver_in, const int* __restrict__ lat_in,
    int8_t* __restrict__ o_ws, int* __restrict__ o_wn,
    int* __restrict__ o_wa, int* __restrict__ o_dirty,
    int* __restrict__ o_ver, uint8_t* __restrict__ o_at_tail,
    int* __restrict__ o_wlat) {
  const int n0 = blockIdx.x * a.cpb;
  const int nc = a.N - n0 < a.cpb ? a.N - n0 : a.cpb;
  const size_t row0 = static_cast<size_t>(n0) * a.LKV;
  copy_rows(dirty_in + row0, ver_in + row0, o_dirty + row0, o_ver + row0,
            static_cast<size_t>(nc) * a.LKV);
  __syncthreads();

  for (int j = threadIdx.x; j < nc * a.W; j += blockDim.x) {
    const int n = n0 + j / a.W;
    const size_t s = static_cast<size_t>(n0) * a.W + j;
    const size_t row = static_cast<size_t>(n) * a.LKV;
    const SlotOut o = slot_step(
        a, ws_in[s], wa_in[s], wn_in[s], lat_in[s],
        [&] { return wk_in[s]; }, [&] { return wv_in[s]; },
        [&] { return wi_in[s]; }, o_dirty + row, o_ver + row);
    o_ws[s] = o.ws;
    o_wn[s] = o.wn;
    o_wa[s] = o.wa;
    o_at_tail[s] = o.at_tail;
    o_wlat[s] = o.wlat;
  }
}

__global__ void craq_chain_kernel(const Args a) {
  chain_general(a, in<int8_t>(a, WS), in<int>(a, WK), in<int>(a, WV),
                in<int>(a, WN), in<int>(a, WA), in<int>(a, WI),
                in<int>(a, DIRTY), in<int>(a, VER), in<int>(a, LAT),
                out<int8_t>(a, O_WS), out<int>(a, O_WN), out<int>(a, O_WA),
                out<int>(a, O_DIRTY), out<int>(a, O_VER),
                out<uint8_t>(a, O_AT_TAIL), out<int>(a, O_WLAT));
}

// ---------------------------------------------------------------------------
// Vector route (module comment): every load first, the rows' updates in
// shared memory, 16-byte rows in and out.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) craq_chain_vec(const Args a) {
  extern __shared__ int4 rows[];  // [2][cpb * L*KV / 4]: dirty, then version
  const int n0 = blockIdx.x * a.cpb;
  const int nc = a.N - n0 < a.cpb ? a.N - n0 : a.cpb;
  const int row_vecs = a.LKV / 4;
  const int nvec = nc * row_vecs;
  const size_t v0 = static_cast<size_t>(n0) * row_vecs;
  const int4* __restrict__ dirty_in = in<int4>(a, DIRTY) + v0;
  const int4* __restrict__ ver_in = in<int4>(a, VER) + v0;

  // 1. Every load of the thread: its vectors of the chains' rows, then its
  // write slot's fields, whether or not the slot arrives.
  int4 d[kRowVecs], v[kRowVecs];
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      d[k] = dirty_in[i];
      v[k] = ver_in[i];
    }
  }
  const int j = threadIdx.x;
  const bool has_slot = j < nc * a.W;
  const size_t s = static_cast<size_t>(n0) * a.W + j;
  int8_t ws = 0;
  int wa = 0, wn = 0, lat = 0, wk = 0, wv = 0, wi = 0;
  if (has_slot) {
    ws = in<int8_t>(a, WS)[s];
    wa = in<int>(a, WA)[s];
    wn = in<int>(a, WN)[s];
    lat = in<int>(a, LAT)[s];
    wk = in<int>(a, WK)[s];
    wv = in<int>(a, WV)[s];
    wi = in<int>(a, WI)[s];
  }

  // 2. The rows into shared memory.
  int4* sh_dirty = rows;
  int4* sh_ver = rows + a.cpb * row_vecs;
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      sh_dirty[i] = d[k];
      sh_ver[i] = v[k];
    }
  }
  __syncthreads();

  // 3. The slots' steps, their adds and maxes on the shared rows.
  if (has_slot) {
    const int c = j / a.W;
    int* dirty = reinterpret_cast<int*>(sh_dirty) + c * a.LKV;
    int* ver = reinterpret_cast<int*>(sh_ver) + c * a.LKV;
    const SlotOut o = slot_step(
        a, ws, wa, wn, lat, [&] { return wk; }, [&] { return wv; },
        [&] { return wi; }, dirty, ver);
    out<int8_t>(a, O_WS)[s] = o.ws;
    out<int>(a, O_WN)[s] = o.wn;
    out<int>(a, O_WA)[s] = o.wa;
    out<uint8_t>(a, O_AT_TAIL)[s] = o.at_tail;
    out<int>(a, O_WLAT)[s] = o.wlat;
  }
  __syncthreads();

  // 4. The rows out, in 16-byte stores.
  int4* __restrict__ o_dirty = out<int4>(a, O_DIRTY) + v0;
  int4* __restrict__ o_ver = out<int4>(a, O_VER) + v0;
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      o_dirty[i] = sh_dirty[i];
      o_ver[i] = sh_ver[i];
    }
  }
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_craq_num_slots() { return NUM_SLOTS; }

// Launch the chain kernel. ptrs holds NUM_SLOTS device pointers (SIDE null
// when no partition is live); ints = {N, W, L*KV, KV, tail, t, number of
// side bits (0 = no live partition), heal tick, threads per block, route
// (`Route`), chains per block of the vector route}. The general route
// takes any shape (cpb = max(1, threads / W)); the vector route is refused
// unless L*KV % 4 == 0, cpb * W <= threads, cpb * L*KV / 4 <= threads *
// kRowVecs, 8 * cpb * L*KV <= kVecSharedBytes and the node planes are
// 16-byte aligned. Returns the CUDA error of the launch (0 = launched).
// Does not synchronise.
int fpx_craq_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.N = ints[0];
  a.W = ints[1];
  a.LKV = ints[2];
  a.KV = ints[3];
  a.tail = ints[4];
  a.t = ints[5];
  a.num_sides = ints[6];
  a.heal = ints[7];
  const int threads = ints[8];
  const int route = ints[9];
  if (a.N <= 0 || a.W <= 0) return 0;
  if (a.LKV < 0 || a.KV <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 || (a.num_sides > 0 && a.p[SIDE] == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t shared = 0;
  if (route == kVector) {
    a.cpb = ints[10];
    void* const vec_ptrs[] = {a.p[DIRTY], a.p[VER], a.p[O_DIRTY], a.p[O_VER]};
    shared = 8 * static_cast<size_t>(a.cpb) * a.LKV;
    if (a.cpb < 1 || a.LKV % 4 || a.cpb * a.W > threads ||
        a.cpb * (a.LKV / 4) > threads * kRowVecs ||
        shared > kVecSharedBytes || !all_aligned16(vec_ptrs, 4)) {
      return cudaErrorInvalidValue;
    }
  } else if (route == kGeneral) {
    a.cpb = threads / a.W > 0 ? threads / a.W : 1;
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t blocks = (static_cast<size_t>(a.N) + a.cpb - 1) / a.cpb;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (route == kVector) {
    craq_chain_vec<<<grid, threads, shared, st>>>(a);
  } else {
    craq_chain_kernel<<<grid, threads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
