// Hand-written Hopper (sm_90a) kernel for the dependency-graph execute
// plane.
//
//   fpx_depgraph_execute  replaces fused_depgraph_execute
//                         (frankenpaxos_tpu/ops/depgraph.py:282, pallas_call
//                         at :316): for each graph of a [B, V, VW] batch of
//                         packed adjacency rows, the transitive closure of
//                         the active subgraph, eligibility (no active
//                         uncommitted vertex in the closure), the SCC root
//                         (least mutually reachable id) and the dense
//                         execution rank by (closure size, id).
//
// It computes exactly what reference_depgraph_execute in
// frankenpaxos_tpu_torch/ops/depgraph.py computes, bit for bit: the
// outputs depend only on the closure of the active subgraph (edges
// restricted to active x active; lanes past V inactive, so garbage bits in
// the padding lanes never count), and both compute that closure exactly
// with word-wise ORs.
//
// Bound. On the main path's inputs (V = 320 or 1280, about 130 active
// vertices in 5 to 11 active words a graph) the function needs thousands
// of word operations a graph (chip_smoke.py dg_needed_ops: a sequential
// walk ORs one finished row per active edge), nanoseconds of the card's
// integer rate, and the inputs are tens of KB. The schedule below does
// more (0.1-0.3M a graph by the host model chip_smoke.py dg_schedule_ops),
// and what bounds a launch in practice is its rounds, one after the
// other: each lasts as long as its longest walk over a row's set bits (a
// chain of shared-memory loads, four in flight) and ends with a block
// barrier. B is the number of replicas (5 on the main path), so 5 of 132
// SMs work.
//
// Design. One CTA per graph; every loop index is 32-bit (the wrapper keeps
// B * working-set words below 2**31), and no loop divides.
//   1. Compaction. The block walks the vertices 32 at a time: a warp's
//      __ballot_sync of `active` is one active word, of `active and not
//      committed` one active-uncommitted word; a block prefix sum (warp
//      popcounts, __popc under a lane mask) writes the ordered list of the
//      active vertex ids. A second pass lists the active WORDS (words with
//      an active lane). Inactive vertices get their outputs (false, -1, -1)
//      here and are never touched again.
//   2. Seed. Only active rows, only active words: the adjacency word ANDed
//      with the active word, plus the self bit. Inactive rows and words of
//      the [V, VW] rows are never written or read.
//   3. Closure by repeated squaring, R <- R | R.R, in place, to a fixed
//      point. Thread (p, k) of a 2-D split of the block (the divide is made
//      once, before any loop) owns words aw[2k] and aw[2k + 1] of the p-th
//      active row i: it ORs those words of row j into its own for every
//      set bit j of row i, and writes a word once, if it changed (two
//      words a thread beat one and four on the BPaxos inputs, chip race in
//      PERF.md section 6). One writer per word; a round ends with one
//      __syncthreads_or(changed), and the first round that changes nothing
//      ends the loop. Rows only gain bits and never pass the closure, and
//      the closure is the unique fixed point, so reading a row another
//      thread is updating in the same round changes the number of rounds
//      at most, never the result. After r rounds a row holds every path of
//      length <= 2**r: the rounds, the last (unchanging) one included, are
//      at most ceil(log2(longest active path)) + 2 (4 on the main path's
//      inputs; the kernel writes its count to O_ROUNDS), in place of
//      Warshall's one barrier per active vertex. A thread walks the set
//      bits four at a time, so four loads are in flight, and stops once
//      its words hold every active lane of theirs. Rounds after the first
//      pull less: a row that was not written in the round before pulls
//      only the rows it reaches that were (a dirty mask of VW words a
//      round, set with atomicOr): every other row it reaches was pulled
//      after its last change, so the fixed point and the round bound stay
//      (5% faster at V = 1280, 1% slower at 320, in the same race).
//   4. The root, by (row, word) pairs: the least set bit j of the word,
//      at or below i, whose row j holds bit i (i itself does), walked four
//      at a time and min-reduced into the row's slot with atomicMin; words
//      past i's are skipped. Then per active row (one thread each): the
//      closure size (popcounts over the active words) and eligibility (the
//      row AND the active-uncommitted words).
//   5. The eligible vertices are compacted in place (stable, so in id
//      order) with their sizes, and each one's rank counts the eligible
//      list: O(eligible^2), not O(V^2).
// Tensor cores are not used: the Pallas kernel doubles a float 0/1 matrix
// on the TPU's matrix unit, but an int8 mma of the padded 320 x 320 matrix
// is about 65.5M operations a round, some 100x the bit-row work these
// graphs need, and it would still need a barrier per round.
//
// Memory. The working set (the rows; the active, active-uncommitted and
// active-word lists and three dirty masks, VW words each; the active list
// and the sizes, V words each; 32 warp counts) lives in dynamic shared
// memory up to the 232,448 bytes (58,112 words) a block may opt in to on
// Hopper: V <= 1314 (58,100 words at V = 1314, 58,144 at 1315; V = 1280
// takes 54,032 words, 216,128 bytes; V = 320 3,932 words, within the
// 48 KB default). The launcher raises the kernel's dynamic shared-memory
// limit for launches past the 48 KB default, and returns the error if it
// cannot. A larger window runs the same algorithm on a global scratch
// buffer of the wrapper's; nothing is refused. The adjacency may come with
// batch stride 0 (every replica's view of one shared graph): each CTA
// reads the same rows, and no copy is made.

#include "common.cuh"

namespace {

// Pointer slots of Args. The Python wrapper fills the same order
// (frankenpaxos_tpu_torch/ops/depgraph.py, _PTR_SLOTS). WORK is the global
// scratch (null when the working set fits in shared memory); O_ROUNDS gets
// each graph's rounds of squaring, the last (unchanging) one included.
enum Slot { ADJ, COM, ACT, WORK, O_ELIG, O_ORDER, O_ROOT, O_ROUNDS, NUM_SLOTS };

struct Args {
  void* p[NUM_SLOTS];
  int B, V, VW, adj_stride;
};

// Dynamic shared memory a block gets without opting in, and the most it
// may opt in to on Hopper (ops/depgraph.py SHARED_BYTES).
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kOptInSharedBytes = 232448;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
// Active words of a row a thread takes in the closure (a chip race in
// PERF.md section 6: on the BPaxos inputs two matched or beat one, four,
// and one to four picked by the pair count).
constexpr int kG = 2;

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return static_cast<const T*>(a.p[s]);
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// Words of the working set of one graph (ops/depgraph.py scratch_words).
__host__ __device__ __forceinline__ size_t work_words(int V, int VW) {
  return static_cast<size_t>(V) * VW + 6 * static_cast<size_t>(VW) +
         2 * static_cast<size_t>(V) + kMaxWarps;
}

// The position of this thread's `pred` among the true ones of the block,
// in thread order; *total gets the block's count. Every thread of the
// block calls it (two barriers; `wtot` holds the per-warp counts).
__device__ __forceinline__ int block_rank(bool pred, int* wtot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, pred);
  if (lane == 0) wtot[warp] = __popc(ballot);
  __syncthreads();
  const int c = lane < static_cast<int>(blockDim.x >> 5) ? wtot[lane] : 0;
  const int before = __reduce_add_sync(kFull, lane < warp ? c : 0);
  *total = __reduce_add_sync(kFull, c);
  __syncthreads();
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// The next four set lanes of `bits` (taken off it), lowest first; past
// the last set lane the first one repeats, so four loads can be in flight
// whatever is left.
__device__ __forceinline__ void next_four(unsigned& bits, int l[4]) {
  l[0] = __ffs(bits) - 1;
  bits &= bits - 1;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    l[k] = bits ? __ffs(bits) - 1 : l[0];
    bits &= bits - 1;
  }
}

__device__ __forceinline__ bool all_full(const unsigned (&acc)[kG],
                                         const unsigned (&full)[kG]) {
  bool done = true;
#pragma unroll
  for (int q = 0; q < kG; ++q) done = done && acc[q] == full[q];
  return done;
}

// acc[q] ORed with word wv[q] of every row j for the set bits j of `row`
// that are also set in `pull | pull_all`, over the active words, masked by
// full[q] (every active lane of the word; 0 for a slot past the thread's
// words); stops once every acc[q] is full.
__device__ __forceinline__ void or_reached(const unsigned* rows,
                                           const unsigned* row,
                                           const unsigned* pull,
                                           unsigned pull_all, const int* aw,
                                           int naw, int VW, const int (&wv)[kG],
                                           const unsigned (&full)[kG],
                                           unsigned (&acc)[kG]) {
  for (int m = 0; m < naw && !all_full(acc, full); ++m) {
    const int wm = aw[m];
    const unsigned* lane0 = rows + (wm << 5) * VW;  // row wm*32+l at l*VW
    unsigned bits = row[wm] & (pull[wm] | pull_all);
    while (bits && !all_full(acc, full)) {
      int l[4];
      next_four(bits, l);
      const unsigned* r0 = lane0 + l[0] * VW;
      const unsigned* r1 = lane0 + l[1] * VW;
      const unsigned* r2 = lane0 + l[2] * VW;
      const unsigned* r3 = lane0 + l[3] * VW;
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int w = wv[q];
        acc[q] |= (r0[w] | r1[w] | r2[w] | r3[w]) & full[q];
      }
    }
  }
}

// Step 3 of the kernel (the note at the top): the rows of alist squared in
// place to their closure. Returns the rounds it took (the same in every
// thread).
__device__ __forceinline__ int square_to_closure(unsigned* rows,
                                                  const unsigned* act_w,
                                                  unsigned* dirty,
                                                  const int* alist,
                                                  const int* aw, int n,
                                                  int naw, int VW) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // The 2-D split for (active row p, group kg of kG active words): cols
  // threads a row, rpp rows a pass; threads past rpp * cols sit out.
  const int groups = (naw + kG - 1) / kG;
  const int cols = groups < nthreads ? groups : nthreads;
  const int rpp = nthreads / cols;
  const int p0 = tid / cols;
  const int k0 = tid - p0 * cols;
  const bool mine = p0 < rpp;
  bool more = true;
  int rounds = 0;
  for (int r = 0; more; r = r == 2 ? 0 : r + 1, ++rounds) {
    const unsigned* prev = dirty + r * VW;
    unsigned* cur = dirty + (r == 2 ? 0 : r + 1) * VW;
    unsigned* next = dirty + (r == 0 ? 2 : r - 1) * VW;
    for (int w = tid; w < VW; w += nthreads) next[w] = 0u;
    bool changed = false;
    if (mine) {
      for (int p = p0; p < n; p += rpp) {
        const int i = alist[p];
        unsigned* row = rows + i * VW;
        const unsigned self = 1u << (i & 31);
        const unsigned pull_all = (prev[i >> 5] & self) ? kFull : 0u;
        bool wrote = false;
        for (int kg = k0; kg < groups; kg += cols) {
          int wv[kG];
          unsigned full[kG], old[kG], acc[kG];
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            const int k = kg * kG + q;
            const bool in = k < naw;
            wv[q] = aw[in ? k : kg * kG];
            full[q] = in ? act_w[wv[q]] : 0u;
            old[q] = in ? row[wv[q]] : 0u;
            acc[q] = old[q];
          }
          or_reached(rows, row, prev, pull_all, aw, naw, VW, wv, full, acc);
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            if (acc[q] != old[q]) {
              row[wv[q]] = acc[q];
              wrote = true;
            }
          }
        }
        if (wrote) atomicOr(&cur[i >> 5], self);
        changed = changed || wrote;
      }
    }
    more = __syncthreads_or(changed) != 0;
  }
  return rounds;
}

// The least j among the set lanes of word w of row i, at or below i, whose
// row j holds bit i; INT_MAX if none.
__device__ __forceinline__ int first_mutual(const unsigned* rows,
                                            unsigned bits, int w, int i,
                                            int VW) {
  if (w == (i >> 5)) bits &= 0xffffffffu >> (31 - (i & 31));
  const unsigned* col = rows + (w << 5) * VW + (i >> 5);
  const unsigned bit = 1u << (i & 31);
  while (bits) {
    int l[4];
    next_four(bits, l);
    const unsigned h[4] = {col[l[0] * VW], col[l[1] * VW], col[l[2] * VW],
                           col[l[3] * VW]};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (h[k] & bit) return (w << 5) + l[k];
    }
  }
  return 0x7fffffff;
}

template <bool kShared>
__global__ void __launch_bounds__(1024) depgraph_kernel(const Args a) {
  extern __shared__ unsigned smem[];
  const int b = blockIdx.x;
  const int V = a.V;
  const int VW = a.VW;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  unsigned* base =
      kShared ? smem
              : reinterpret_cast<unsigned*>(out<int>(a, WORK)) +
                    static_cast<size_t>(b) * work_words(V, VW);
  unsigned* rows = base;                                  // [V, VW]
  unsigned* act_w = rows + static_cast<size_t>(V) * VW;   // [VW]
  unsigned* unc_w = act_w + VW;                           // [VW]
  unsigned* dirty = unc_w + VW;                           // [3, VW]
  int* aw = reinterpret_cast<int*>(dirty + 3 * VW);       // [VW] active words
  int* alist = aw + VW;                                   // [V] active ids
  int* szp = alist + V;                                   // [V] sizes
  int* wtot = szp + V;                                    // [32]
  const unsigned* adj = reinterpret_cast<const unsigned*>(in<int>(a, ADJ)) +
                        static_cast<size_t>(b) * a.adj_stride;
  const uint8_t* com = in<uint8_t>(a, COM) + static_cast<size_t>(b) * V;
  const uint8_t* act = in<uint8_t>(a, ACT) + static_cast<size_t>(b) * V;
  uint8_t* o_elig = out<uint8_t>(a, O_ELIG) + static_cast<size_t>(b) * V;
  int* o_order = out<int>(a, O_ORDER) + static_cast<size_t>(b) * V;
  int* o_root = out<int>(a, O_ROOT) + static_cast<size_t>(b) * V;

  // 1. The active and active-uncommitted words (a warp's ballots over 32
  // consecutive vertices; padding lanes 0), the ordered active list, and
  // the outputs of the inactive vertices.
  int n = 0;
  for (int v0 = 0; v0 < VW * 32; v0 += nthreads) {
    const int v = v0 + tid;
    const bool on = v < V && act[v];
    const bool unc = on && !com[v];
    const unsigned aw_bits = __ballot_sync(kFull, on);
    const unsigned uw_bits = __ballot_sync(kFull, unc);
    if ((tid & 31) == 0 && v < VW * 32) {
      act_w[v >> 5] = aw_bits;
      unc_w[v >> 5] = uw_bits;
      dirty[v >> 5] = aw_bits;  // round 0 pulls every row
      dirty[VW + (v >> 5)] = 0u;
    }
    int total;
    const int pos = block_rank(on, wtot, &total);
    if (on) {
      alist[n + pos] = v;
    } else if (v < V) {
      o_elig[v] = 0;
      o_order[v] = -1;
      o_root[v] = -1;
    }
    n += total;
  }
  __syncthreads();
  if (n == 0) {  // uniform: n is the block's count
    if (tid == 0) out<int>(a, O_ROUNDS)[b] = 0;
    return;
  }

  // The active words, in order.
  int naw = 0;
  for (int w0 = 0; w0 < VW; w0 += nthreads) {
    const int w = w0 + tid;
    const bool on = w < VW && act_w[w] != 0u;
    int total;
    const int pos = block_rank(on, wtot, &total);
    if (on) aw[naw + pos] = w;
    naw += total;
  }
  for (int p = tid; p < n; p += nthreads) szp[p] = 0x7fffffff;  // root slots
  __syncthreads();

  // The 2-D split for (active row p, active word k): cols threads a row,
  // rpp rows a pass. Threads past rpp * cols sit out the pair loops.
  const int cols = naw < nthreads ? naw : nthreads;
  const int rpp = nthreads / cols;
  const int p0 = tid / cols;
  const int k0 = tid - p0 * cols;
  const bool pairs = p0 < rpp;

  // 2. The seed: active rows on active words, restricted to active
  // columns, plus the self bit.
  if (pairs) {
    for (int p = p0; p < n; p += rpp) {
      const int i = alist[p];
      for (int k = k0; k < naw; k += cols) {
        const int w = aw[k];
        unsigned r = adj[i * VW + w] & act_w[w];
        if (w == (i >> 5)) r |= 1u << (i & 31);
        rows[i * VW + w] = r;
      }
    }
  }
  __syncthreads();

  // 3. Squaring in place to the fixed point: one barrier a round. Round r
  // marks the rows it writes in cur (atomicOr) and clears the buffer of
  // round r + 1; a row pulls from every row it reaches if it was itself
  // written in round r - 1 (prev), else only from the reached rows that
  // were (the others were pulled since they last changed).
  const int rounds = square_to_closure(rows, act_w, dirty, alist, aw, n, naw, VW);
  if (tid == 0) out<int>(a, O_ROUNDS)[b] = rounds;

  // 4. The root: each pair's least mutually reachable j in its word, at or
  // below i (i itself qualifies), min-reduced into the row's slot.
  if (pairs) {
    for (int p = p0; p < n; p += rpp) {
      const int i = alist[p];
      const unsigned* row = rows + i * VW;
      for (int k = k0; k < naw; k += cols) {
        const int w = aw[k];
        if (w > (i >> 5)) break;  // aw ascends
        const int j = first_mutual(rows, row[w], w, i, VW);
        if (j < szp[p]) atomicMin(&szp[p], j);
      }
    }
  }
  __syncthreads();
  // Per active row: size and eligibility; ineligible rows' order.
  for (int p = tid; p < n; p += nthreads) {
    const int i = alist[p];
    const unsigned* row = rows + i * VW;
    int size = 0;
    bool bad = false;
    for (int m = 0; m < naw; ++m) {
      const int w = aw[m];
      const unsigned bits = row[w];
      size += __popc(bits);
      bad = bad || (bits & unc_w[w]) != 0u;
    }
    o_elig[i] = !bad;
    o_root[i] = szp[p];
    if (bad) o_order[i] = -1;
    szp[p] = bad ? -1 : size;
  }
  __syncthreads();

  // 5. The eligible rows, compacted in place (a write lands at or below
  // the position it was read from, after the tile's reads), then ranked
  // by (size, id) over the eligible list.
  int ne = 0;
  for (int t0 = 0; t0 < n; t0 += nthreads) {
    const int p = t0 + tid;
    int i = 0, s = -1;
    if (p < n) {
      i = alist[p];
      s = szp[p];
    }
    int total;
    const int pos = block_rank(s >= 0, wtot, &total);
    if (s >= 0) {
      alist[ne + pos] = i;
      szp[ne + pos] = s;
    }
    ne += total;
  }
  __syncthreads();
  for (int q = tid; q < ne; q += nthreads) {
    const int s = szp[q];
    int rank = 0;
    for (int r = 0; r < ne; ++r) {
      const int sr = szp[r];
      rank += (sr < s) || (sr == s && r < q);
    }
    o_order[alist[q]] = rank;
  }
}

}  // namespace

extern "C" {

// Number of pointer slots the caller must pass (a layout check).
int fpx_depgraph_num_slots() { return NUM_SLOTS; }

// Launch the execute kernel. ptrs holds NUM_SLOTS device pointers (WORK
// null when shared); ints = {B, V, VW, adjacency batch stride in words (0 =
// one graph shared by the batch), shared (1: the working set in shared
// memory), threads per block}. Returns the CUDA error of the opt-in or the
// launch (0 = launched). Does not synchronise.
int fpx_depgraph_launch(void* const* ptrs, const int* ints, void* stream) {
  Args a;
  for (int i = 0; i < NUM_SLOTS; ++i) a.p[i] = ptrs[i];
  a.B = ints[0];
  a.V = ints[1];
  a.VW = ints[2];
  a.adj_stride = ints[3];
  const bool shared = ints[4] != 0;
  const int threads = ints[5];
  if (a.B <= 0 || a.V <= 0) return 0;
  if (a.VW != (a.V + 31) / 32 || a.adj_stride < 0 || threads < 32 ||
      threads > 1024 || threads % 32) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = sizeof(unsigned) * work_words(a.V, a.VW);
    if (bytes > kOptInSharedBytes) return cudaErrorInvalidValue;
    if (bytes > kDefaultSharedBytes) {
      // Always the same limit, so launches from several threads agree.
      const cudaError_t err = cudaFuncSetAttribute(
          depgraph_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kOptInSharedBytes));
      if (err != cudaSuccess) return err;
    }
    depgraph_kernel<true><<<a.B, threads, bytes, st>>>(a);
  } else {
    if (a.p[WORK] == nullptr) return cudaErrorInvalidValue;
    depgraph_kernel<false><<<a.B, threads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
