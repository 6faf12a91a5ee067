// One step of the graph beam (search/beam.py `_step`) as four kernels
// around the exact distances: the expansion and the merge one block per
// query, the pop and the gamma update one warp per query.
//
//   beam_pop_kernel     the step counter, the pop: top-E of the beam
//                       (stable), the DABS termination, the popped slots
//                       set to FLOAT_MAX, the lower-bound skip, the nodes to
//                       expand, the slack level and its count.
//   (torch)             the exact distance to each popped node,
//                       estimate.exact_l2_sq.
//   beam_expand_*       the E*R candidates of the popped nodes' fused rows:
//                       fastscan sums in int32, the estimate and its lower
//                       bound, the visited check, the intra-step dedup, the
//                       visited update (the hash table's last writer in row
//                       order, or the dense (Q, n + 1) bool rows), the
//                       gates, and the rw candidates to rerank.
//   (torch)             the exact distances of those candidates.
//   beam_merge_*        the result pushes, the stable top-k of the results,
//                       the DABS enqueue, the stable top beam_cap of the
//                       beam, and the per-candidate ratio of the gamma
//                       adaptation.
//   beam_gamma_kernel   the gamma adaptation: the sums of those ratios and
//                       of their squares, the count of contributing
//                       candidates in int32, and the update.
//
// No TPU kernel stands behind these: the JAX package's step runs as XLA
// ops, whose fusion made its Pallas step kernel slower and got it retired
// (PARITY.md:134-152).  In PyTorch each of the step's ~255 ops is a kernel
// of its own, each at its launch floor.
//
// Each kernel reproduces its torch segment bit for bit: float32 arithmetic
// in torch's order with one rounding per torch op (__fmul_rn and the like,
// never contracted into an FMA), NaN passing through the clamps as ATen's
// clamps let it, every stable sort as a sort of distinct 64-bit entries
// (the value's radix-sort bits above its index: the order of a stable
// sort on values without NaN and -0, which the step never makes), the
// fastscan sums in int32 (torch sums them exactly in float32).  The
// scalars come from the host as float32, rounded from doubles as ATen
// rounds a Python scalar.
//
// The expansion and the merge come in two variants (kernels/beam_step.py,
// launch_plan, picks one by shape):
//
//   generic (beam_expand_kernel, beam_merge_kernel) take every shape the
//   plain step takes.  Each block works in a workspace of its own: dynamic
//   shared memory where it fits (227 KB a block), else a slice of a global
//   scratch buffer that the host allocates (a beam of thousands of entries
//   at large k, or a wide query), laid out alike.  Sorts are block-wide
//   bitonic networks, a barrier a phase; a thread walks its candidates,
//   unpacking the fastscan sums dimension by dimension.
//
//   Hopper (beam_expand_bulk_kernel, beam_merge_rank_kernel) take E*R and
//   both merge sorts up to 1,024 entries, one thread an entry, with the
//   workspace in shared memory.
//
// What bounds them on an H100.  The bytes are few: ~8 MB a step for the
// expansion at the graph cell (R = 32, E = 4, 1 bit, P = 128, 1,024
// queries), 2.5 us at 3.35 TB/s; the merge ~5 MB.  One launch is one wave
// of 1,024 blocks, so its time is a block's dependent chain of memory
// round trips plus the SM's issue slots.  The generic kernels spend the
// slots on instructions (their SASS: beam_sass_report.py): per candidate
// 12.5 instructions a dimension at 1 bit and 18 at 2 and 4 (a run-time
// loop over P dimensions, 4 unrolled a trip), then two scans of every
// other candidate of 11-12 instructions a step (the first occurrence of an
// id, the hashed table's last writer): ~3,100 a candidate at the cell; and
// per sort a barrier and a shared round trip in each of 36 phases, half
// the threads idle.  The Hopper variants cut both:
//   * every global read that needs no row is issued at entry, before the
//     test of `active`;
//   * the popped rows come in by one bulk copy (TMA, 1-D, completing on an
//     mbarrier) each, issued as soon as the rows are known and in flight
//     while the block stages the query's levels;
//   * the query's 4-bit levels are split once into 4 bit planes a 32-dim
//     word (warp ballots), so a candidate's sum is
//     sum_b sum_j 2^(BITS-1-b+j) popc(code_b & level_j): 4 * BITS AND +
//     POPC + shift-adds a word, exact in int32;
//   * the first occurrence of an id and the last writer of a hash slot are
//     warp matches (__match_any_sync) and one atomicMin / atomicMax into a
//     shared open-addressed table;
//   * every sort ranks instead of exchanging (block_rank): the entries at
//     FLOAT_MAX, most of a step's, by counting; the rest compacted into
//     the first warps, each sorting its 32 in registers (shuffles) into a
//     run, an entry's rank its place in its run plus a binary search of
//     each other run; four barriers a sort in place of 36; its owner
//     writes each entry at its rank;
//   * the merge's "already held" test is a lookup in a shared set of the
//     result ids.
// What is left (phase stamps of a -DBEAM_STAMPS build,
// beam_kernel_compare.py --stamps): a chain of three dependent trips to
// device memory in the expansion (`active` and the popped nodes, their
// rows, the visited slots) and, in the merge, the two sorts' barriers.
// The pop and the gamma update are a warp per query, eight queries a
// block, with no shared memory and no barrier:
//   * the pop selects without a sort.  Lane l holds the sort entries of
//     the beam slots l, l + 32, l + 64, ... (in registers up to POP_KEEP of
//     them, read again from L1 beyond) and the smallest of them; each of E
//     rounds is a warp argmin (a xor butterfly of 64-bit shuffles), after
//     which only the lane that owned the winner moves on to its next entry
//     above it.  Lane e then reads and writes popped entry e (in turns of
//     32 when E > 32), the count expanded is a ballot, and after the last
//     round the slots at or below the E-th entry go to FLOAT_MAX.  It also
//     writes the step counter, steps + 1.  What bounds it is latency, not
//     its bytes (~0.35 MB a step at the graph cell): two dependent trips
//     to device memory (the beam, then the popped slots' ids and bounds)
//     around E rounds of ten shuffles.
//   * the gamma update sums its query's ratios and their squares itself,
//     in one fixed order: lane l adds the entries l, l + 32, l + 64, ... in
//     turn onto +0.0, then a xor butterfly over the lanes at 16, 8, 4, 2,
//     1, each product and sum one rounding (__fmul_rn, __fadd_rn).  The
//     plain segment (search/beam.py `_lane_sums`) takes the same order in
//     elementwise torch ops on rw zero-padded to a multiple of 32: a sum
//     that starts at +0.0 never becomes -0.0, so adding the +0.0 pads
//     changes no bit, and the two agree bit for bit.
//   * both launch with programmatic stream serialization
//     (launch_after_previous): their blocks may start while the kernel
//     before them ends and wait in wait_for_previous_grid before their
//     first read; the merge and the gamma update let the next kernel start
//     at their entry.  In a captured CUDA graph these are programmatic
//     edges.  (Kept on measurement: a profiled batch's device-busy time a
//     step fell, PERF.md.)
// A query already done returns at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float FLOAT_MAX = 3.402823466e+38f;
constexpr uint64_t SORT_PAD = ~0ull;
constexpr int MAX_BITS = 4;   // bit planes (kernels/beam_step.py)

extern __shared__ __align__(16) unsigned char smem_ws[];

// The order of cub's radix sort on float keys: ascending for every value
// but NaN, with -0 below +0.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A sort entry: the value's order above its index, so that the ascending
// order of entries is the stable order of the values.
__device__ __forceinline__ uint64_t sort_entry(float v, int i) {
  return ((uint64_t)order_key(v) << 32) | (uint32_t)i;
}

__device__ __forceinline__ int entry_index(uint64_t e) {
  return (int)(uint32_t)e;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Ascending bitonic sort of n entries (n a power of two) by the whole
// block; the entries must be visible to every thread on entry, and are on
// return.
__device__ void block_sort(uint64_t* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const uint64_t x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The block's workspace, carved in 16-byte aligned arrays in order
// (launch_plan sizes it by the same rule).
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(long long count) {
    T* out = reinterpret_cast<T*>(p);
    p += (count * (long long)sizeof(T) + 15) & ~15ll;
    return out;
  }
};

// kShared: the workspace is the dynamic shared memory, which the compiler
// then addresses as shared (a pointer chosen at run time would make every
// access a generic one); else the block's slice of the global scratch.
template <bool kShared>
__device__ __forceinline__ Carve workspace(unsigned char* scratch,
                                           long long ws_bytes) {
  if (kShared) return Carve{smem_ws};
  return Carve{scratch + (size_t)blockIdx.x * ws_bytes};
}

// Programmatic dependent launch: a kernel launched with programmatic
// stream serialization may start while the kernel before it on the stream
// runs; it waits here before its first read of memory that kernel (or any
// kernel before it) writes.  Without that launch attribute both are no-ops.
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
// Lets the next kernel on the stream, if it was launched that way, start
// its blocks now (they wait in wait_for_previous_grid until this grid has
// finished and its writes are visible).
__device__ __forceinline__ void let_next_grid_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ATen's clamp_min and clamp on CUDA: NaN passes, else ::max / ::min.
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_f(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// estimate.ip_from_fastscan: (A * inv_k) * fs + (B * inv_k) * wpc + C.
__device__ __forceinline__ float ip_from_fastscan(float ca_k, float cb_k,
                                                  float cc, int fs,
                                                  float wpc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ca_k, (float)fs), __fmul_rn(cb_k, wpc)),
                   cc);
}

struct Calib {
  float affine_a, affine_b, ip_qo_floor, eps_medium, eps_small;
};

// estimate.estimate_ip's ratio term under mask_good, then its affine.
__device__ __forceinline__ float ip_estimate(float ip_approx, float ip_cp,
                                             float denom, bool good,
                                             const Calib& cal) {
  const float ratio =
      good ? __fdiv_rn(__fsub_rn(ip_approx, ip_cp), denom) : 0.f;
  return __fadd_rn(__fmul_rn(ratio, cal.affine_a), cal.affine_b);
}

template <bool kShared>
__global__ void beam_expand_kernel(
    const int* __restrict__ fused, long long fused_stride,
    const int* __restrict__ q_u, const float* __restrict__ coeff_a,
    const float* __restrict__ coeff_b, const float* __restrict__ coeff_c,
    const float* __restrict__ res_d, const bool* __restrict__ active,
    const bool* __restrict__ expand_e, const int64_t* __restrict__ cur_safe,
    const float* __restrict__ dot_slack, const float* __restrict__ d_qp_sq,
    int* __restrict__ visited_hash, bool* __restrict__ visited_dense,
    int* __restrict__ nbr_ids_out, float* __restrict__ est_out,
    float* __restrict__ lower_out, bool* __restrict__ cand_ok_out,
    bool* __restrict__ rerank_out, int64_t* __restrict__ rr_node_out,
    bool* __restrict__ rr_ok_out, float* __restrict__ est_rr_out,
    int64_t* __restrict__ rr_slots_out, int k, int ew, int r, int words,
    int bits, int p, int rw, int h_size, long long n, Calib cal, float inv_k,
    float inv_k_msb, unsigned char* __restrict__ scratch,
    long long ws_bytes) {
  enum { VALID = 1, SEEN = 2, OK0 = 4 };
  const int er = ew * r;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t qc = (size_t)q * er;
  const size_t qr = (size_t)q * rw;
  const size_t hrow = (size_t)q * (h_size + 1);
  const size_t drow = (size_t)q * (n + 1);
  if (!active[q]) {
    // every candidate is invalid: the plain step sends each to the spare
    // visited slot and reranks node 0
    for (int c = tid; c < er; c += blockDim.x) {
      cand_ok_out[qc + c] = false;
      rerank_out[qc + c] = false;
    }
    for (int i = tid; i < rw; i += blockDim.x) {
      rr_node_out[qr + i] = 0;
      if (rw < er) rr_ok_out[qr + i] = false;   // else it is rerank_out
    }
    if (tid == 0) {
      if (h_size) visited_hash[hrow + h_size] = -1;
      else visited_dense[drow + n] = true;
    }
    return;
  }
  const bool capped = rw < er;
  Carve ws = workspace<kShared>(scratch, ws_bytes);
  const int pad = capped ? pow2_at_least(er) : 0;
  uint64_t* rr_key = ws.take<uint64_t>(pad);
  int* qs = ws.take<int>(p);
  int* nbr = ws.take<int>(er);
  int* safe = ws.take<int>(er);
  int* hslot = ws.take<int>(er);
  float* est_s = ws.take<float>(er);
  float* lower_s = ws.take<float>(er);
  unsigned char* flags = ws.take<unsigned char>(er);
  bool* rerank_s = ws.take<bool>(er);
  for (int d = tid; d < p; d += blockDim.x) qs[d] = q_u[(size_t)q * p + d];
  const float ca = coeff_a[q], cb = coeff_b[q], cc = coeff_c[q];
  const float ca_k = __fmul_rn(ca, inv_k), cb_k = __fmul_rn(cb, inv_k);
  const float ca_m = __fmul_rn(ca, inv_k_msb), cb_m = __fmul_rn(cb, inv_k_msb);
  const float d_k = res_d[(size_t)q * k + k - 1];
  const bool warmup = !(d_k < FLOAT_MAX);
  const float slack = dot_slack[q];
  __syncthreads();

  // scores and the visited check (every read of visited before any write)
  for (int c = tid; c < er; c += blockDim.x) {
    const int e = c / r, j = c - e * r;
    const int* row = fused + cur_safe[(size_t)q * ew + e] * fused_stride;
    const int id = row[j];
    const bool valid = id >= 0 && expand_e[(size_t)q * ew + e];
    const int sid = valid ? id : 0;
    const float nop = __int_as_float(row[r + j]);
    const float ip_qo = __int_as_float(row[2 * r + j]);
    const float ip_cp = __int_as_float(row[3 * r + j]);
    const float wpc = __int_as_float(row[4 * r + j]);
    const int* planes = row + 5 * r + j;
    int fs = 0, fs_msb = 0, wpc_msb = 0;
    for (int w = 0; w < words; ++w) {
      // unrolled to MAX_BITS so that the plane words stay in registers
      uint32_t pw[MAX_BITS];
#pragma unroll
      for (int b = 0; b < MAX_BITS; ++b)
        pw[b] = b < bits ? (uint32_t)planes[(size_t)(b * words + w) * r] : 0u;
      const int dims = min(32, p - w * 32);
      for (int d = 0; d < dims; ++d) {
        int u = 0;
#pragma unroll
        for (int b = 0; b < MAX_BITS; ++b)
          if (b < bits) u = (u << 1) | ((pw[b] >> d) & 1u);
        const int qd = qs[w * 32 + d];
        fs += u * qd;
        if (bits >= 2) {
          const int um = u >> (bits - 2);
          fs_msb += um * qd;
          wpc_msb += um;
        }
      }
    }
    const float ip_full = ip_from_fastscan(ca_k, cb_k, cc, fs, wpc);
    const float ip_bound =
        bits >= 2 ? ip_from_fastscan(ca_m, cb_m, cc, fs_msb, (float)wpc_msb)
                  : ip_full;
    // estimate.distances_with_bounds
    const float dqp = d_qp_sq[(size_t)q * ew + e];
    const float sqrt_dqp = __fsqrt_rn(clamp_min_f(dqp, 0.f));
    const float ip_qo_p = clamp_min_f(ip_qo, cal.ip_qo_floor);
    const bool good = ip_qo_p > cal.eps_medium;
    const float denom = clamp_min_f(ip_qo_p, cal.eps_medium);
    const float ip_est = ip_estimate(ip_full, ip_cp, denom, good, cal);
    const float base = __fadd_rn(__fmul_rn(nop, nop), dqp);
    const float two_nop = __fmul_rn(2.f, nop);
    float est = clamp_min_f(__fsub_rn(base, __fmul_rn(two_nop, ip_est)), 0.f);
    const float ip_est_b = ip_estimate(ip_bound, ip_cp, denom, good, cal);
    const float cos_upper = clamp_f(
        __fdiv_rn(__fadd_rn(ip_est_b, slack),
                  clamp_min_f(sqrt_dqp, cal.eps_medium)),
        -1.f, 1.f);
    float lower = clamp_min_f(
        __fsub_rn(base, __fmul_rn(__fmul_rn(two_nop, sqrt_dqp), cos_upper)),
        0.f);
    if (!good) lower = 0.f;
    if (dqp < cal.eps_small) {
      est = base;
      lower = 0.f;
    }
    bool seen;
    if (h_size) {
      hslot[c] = sid & (h_size - 1);
      seen = visited_hash[hrow + hslot[c]] == sid;
    } else {
      seen = visited_dense[drow + sid];
    }
    nbr[c] = id;
    safe[c] = sid;
    est_s[c] = est;
    lower_s[c] = lower;
    flags[c] = (valid ? VALID : 0) | (seen ? SEEN : 0);
    nbr_ids_out[qc + c] = id;
    est_out[qc + c] = est;
    lower_out[qc + c] = lower;
  }
  __syncthreads();

  // the first occurrence of a neighbour two popped nodes share
  for (int c = tid; c < er; c += blockDim.x) {
    bool dup = false;
    for (int c2 = 0; c2 < c && !dup; ++c2)
      dup = (flags[c2] & VALID) && nbr[c2] == nbr[c];
    const unsigned char f = flags[c];
    if ((f & VALID) && !(f & SEEN) && !dup) flags[c] = f | OK0;
  }
  __syncthreads();

  // the visited update, then the gates
  for (int c = tid; c < er; c += blockDim.x) {
    const unsigned char f = flags[c];
    const bool ok0 = f & OK0;
    if (h_size) {
      bool mark = ok0;
      for (int c2 = c + 1; c2 < er && mark; ++c2)
        mark = !((flags[c2] & OK0) && hslot[c2] == hslot[c]);
      if (mark) visited_hash[hrow + hslot[c]] = safe[c];
      else visited_hash[hrow + h_size] = -1;
    } else {
      visited_dense[drow + (ok0 ? safe[c] : n)] = true;
    }
    const bool ok = ok0 && (warmup || lower_s[c] < d_k);
    const bool rerank = ok && (warmup || est_s[c] < d_k);
    cand_ok_out[qc + c] = ok;
    rerank_out[qc + c] = rerank;
    rerank_s[c] = rerank;
  }
  if (!capped) {
    for (int c = tid; c < er; c += blockDim.x) rr_node_out[qr + c] = safe[c];
    return;
  }
  __syncthreads();
  // the rw best estimates among the reranked candidates, stable
  for (int c = tid; c < pad; c += blockDim.x)
    rr_key[c] = c < er ? sort_entry(rerank_s[c] ? est_s[c] : FLOAT_MAX, c)
                       : SORT_PAD;
  __syncthreads();
  block_sort(rr_key, pad);
  for (int i = tid; i < rw; i += blockDim.x) {
    const int c = entry_index(rr_key[i]);
    rr_slots_out[qr + i] = c;
    rr_ok_out[qr + i] = rerank_s[c];
    rr_node_out[qr + i] = safe[c];
    est_rr_out[qr + i] = est_s[c];
  }
}

template <bool kShared>
__global__ void beam_merge_kernel(
    int* __restrict__ res_ids, float* __restrict__ res_d,
    int* __restrict__ res_step, int* __restrict__ last_improve,
    float* __restrict__ beam_est, int* __restrict__ beam_ids,
    float* __restrict__ beam_lower, const float* __restrict__ gamma_q,
    const int* __restrict__ next_step, const bool* __restrict__ active,
    const bool* __restrict__ expand, const bool* __restrict__ expand_e,
    const int* __restrict__ pop_ids, const int64_t* __restrict__ cur_safe,
    const float* __restrict__ d_qp_sq, const int* __restrict__ nbr_ids,
    const float* __restrict__ est, const float* __restrict__ lower,
    const bool* __restrict__ cand_ok, const bool* __restrict__ rerank,
    const int64_t* __restrict__ rr_node, const bool* __restrict__ rr_ok,
    const float* __restrict__ est_rr, const int64_t* __restrict__ rr_slots,
    const float* __restrict__ exact_rr, float* __restrict__ ratio,
    bool* __restrict__ contrib, int beam_cap, int k, int ew, int er, int rw,
    float eps_small, unsigned char* __restrict__ scratch,
    long long ws_bytes) {
  __shared__ int improved;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t qr = (size_t)q * rw;
  let_next_grid_start();
  if (!active[q]) {
    for (int i = tid; i < rw; i += blockDim.x) {
      ratio[qr + i] = 0.f;
      contrib[qr + i] = false;
    }
    return;
  }
  const int m = k + rw + ew;          // results, reranked, popped
  const int nb = beam_cap + er;       // beam, candidates
  const int m_pad = pow2_at_least(m), nb_pad = pow2_at_least(nb);
  Carve ws = workspace<kShared>(scratch, ws_bytes);
  uint64_t* m_key = ws.take<uint64_t>(m_pad);
  uint64_t* b_key = ws.take<uint64_t>(nb_pad);
  int* m_id = ws.take<int>(m);
  float* m_d = ws.take<float>(m);
  int* m_step = ws.take<int>(m);
  float* b_val = ws.take<float>(nb);
  float* b_lower = ws.take<float>(nb);
  int* b_id = ws.take<int>(nb);
  float* enq_val = ws.take<float>(er);
  const size_t qk = (size_t)q * k, qe = (size_t)q * ew, qc = (size_t)q * er;
  const size_t qb = (size_t)q * beam_cap;
  const int step = *next_step;
  const bool warmup = !(res_d[qk + k - 1] < FLOAT_MAX);
  const bool expanding = expand[q];
  if (tid == 0) improved = 0;
  for (int j = tid; j < k; j += blockDim.x) {
    m_id[j] = res_ids[qk + j];
    m_d[j] = res_d[qk + j];
    m_step[j] = res_step[qk + j];
    m_key[j] = sort_entry(m_d[j], j);
  }
  for (int j = m + tid; j < m_pad; j += blockDim.x) m_key[j] = SORT_PAD;
  __syncthreads();

  // the pushes: reranked candidates, then popped nodes, none already held
  for (int i = tid; i < rw + ew; i += blockDim.x) {
    float d;
    int id;
    if (i < rw) {
      const int64_t node = rr_node[qr + i];
      const bool ok = rr_ok[qr + i];
      bool held = false;
      for (int j = 0; j < k && ok && !held; ++j) held = m_id[j] == node;
      id = (int)node;
      d = ok && !held ? exact_rr[qr + i] : FLOAT_MAX;
    } else {
      const int e = i - rw;
      const int pid = pop_ids[qe + e];
      bool held = false;
      for (int j = 0; j < k && pid >= 0 && !held; ++j) held = m_id[j] == pid;
      id = (int)cur_safe[qe + e];
      d = expand_e[qe + e] && !held ? d_qp_sq[qe + e] : FLOAT_MAX;
    }
    m_id[k + i] = id;
    m_d[k + i] = d;
    m_step[k + i] = step;
    m_key[k + i] = sort_entry(d, k + i);
  }
  __syncthreads();
  block_sort(m_key, m_pad);
  if (expanding) {
    for (int t = tid; t < k; t += blockDim.x) {
      const int s = entry_index(m_key[t]);
      if (m_d[s] != m_d[t]) improved = 1;
      res_ids[qk + t] = m_id[s];
      res_d[qk + t] = m_d[s];
      res_step[qk + t] = m_step[s];
    }
  }
  __syncthreads();
  if (tid == 0 && improved) last_improve[q] = step;

  // the DABS enqueue: reranked entries carry their exact distances
  const float d_k_new = expanding ? m_d[entry_index(m_key[k - 1])]
                                  : m_d[k - 1];
  const float thresh =
      d_k_new < FLOAT_MAX ? __fmul_rn(gamma_q[q], d_k_new) : FLOAT_MAX;
  for (int c = tid; c < er; c += blockDim.x)
    enq_val[c] = rw == er && rerank[qc + c] ? exact_rr[qr + c] : est[qc + c];
  if (rw < er) {
    __syncthreads();
    for (int i = tid; i < rw; i += blockDim.x)
      enq_val[rr_slots[qr + i]] = rr_ok[qr + i] ? exact_rr[qr + i]
                                                : est_rr[qr + i];
  }
  __syncthreads();
  for (int i = tid; i < nb_pad; i += blockDim.x) {
    if (i >= nb) {
      b_key[i] = SORT_PAD;
      continue;
    }
    float v, lo;
    int id;
    if (i < beam_cap) {
      v = beam_est[qb + i];
      lo = beam_lower[qb + i];
      id = beam_ids[qb + i];
    } else {
      const int c = i - beam_cap;
      const float ev = enq_val[c];
      const bool enq = cand_ok[qc + c] && ev < thresh;
      v = enq ? ev : FLOAT_MAX;
      lo = warmup ? ev : lower[qc + c];
      id = nbr_ids[qc + c];
    }
    b_val[i] = v;
    b_lower[i] = lo;
    b_id[i] = id;
    b_key[i] = sort_entry(v, i);
  }
  __syncthreads();
  block_sort(b_key, nb_pad);
  for (int t = tid; t < beam_cap; t += blockDim.x) {
    const int s = entry_index(b_key[t]);
    beam_est[qb + t] = b_val[s];
    beam_ids[qb + t] = b_id[s];
    beam_lower[qb + t] = b_lower[s];
  }

  // the gamma adaptation's ratio of each reranked candidate
  for (int i = tid; i < rw; i += blockDim.x) {
    const float x = exact_rr[qr + i];
    const bool c = rr_ok[qr + i] && !warmup && x > eps_small;
    ratio[qr + i] = c ? __fdiv_rn(est_rr[qr + i], clamp_min_f(x, eps_small))
                      : 0.f;
    contrib[qr + i] = c;
  }
}

// ------------------------------------------------------------------------
// The Hopper variants of the expansion and the merge.  Their workspace
// lives in dynamic shared memory only (launch_plan picks the generic
// kernels above where it does not fit), one thread per entry.

constexpr int LUT_PLANES = 4;   // query levels 0..15 (ops/quantize.py)
constexpr int NONE = -1;        // an empty key of the shared tables

// Phase stamps of the Hopper variants, in a measurement build only
// (-DBEAM_STAMPS; beam_kernel_compare.py --stamps): thread 0 of each of
// the first STAMP_BLOCKS blocks writes clock64() at each phase boundary
// and %globaltimer at entry and exit.
#ifdef BEAM_STAMPS
constexpr int STAMP_BLOCKS = 4096, STAMP_SLOTS = 10;
__device__ long long beam_stamps[2][STAMP_BLOCKS][STAMP_SLOTS];
__device__ __forceinline__ void stamp(int kernel, int slot, bool wall) {
  if (threadIdx.x != 0 || blockIdx.x >= STAMP_BLOCKS) return;
  long long t;
  if (wall) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  else t = clock64();
  beam_stamps[kernel][blockIdx.x][slot] = t;
}
#define STAMP(kernel, slot) stamp(kernel, slot, false)
#define WALL(kernel, slot) stamp(kernel, slot, true)
#else
#define STAMP(kernel, slot) ((void)0)
#define WALL(kernel, slot) ((void)0)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed; a wait past
// ~2^26 polls (a real one takes microseconds) traps, so that a fault
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u32 n;\n\tmov.u32 n, 0;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "add.u32 n, n, 1;\n\t"
      "setp.eq.u32 p, n, 0x4000000;\n\t"
      "@p trap;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A pad entry for slot t beyond the entries of a sort: above every entry
// of a value (its index lies past theirs) and distinct.
__device__ __forceinline__ uint64_t pad_entry(int t) {
  return (0xFFFFFFFFull << 32) | (uint32_t)t;
}

// Ascending bitonic sort of one entry per lane across the warp, in
// registers: lane l returns the l-th smallest of the warp's entries.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(0xffffffffu, x, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      x = (low == up) ? (x < y ? x : y) : (x < y ? y : x);
    }
  }
  return x;
}

// The count of the 32 ascending entries of `run` below x.
__device__ __forceinline__ int below_in_run(const uint64_t* run, uint64_t x) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (run[pos + s - 1] < x) pos += s;
  return pos + (run[pos] < x);
}

// The rank of each thread's entry among the block's entries, the place a
// full sort gives it (one entry a thread, all distinct, entry_index(entry)
// == threadIdx.x; a pad's rank is not computed).  Most entries of a step
// hold FLOAT_MAX: they are ranked by counting, after every entry below
// FLOAT_MAX and by index among themselves.  The rest are compacted into
// the first warps; each of those warps sorts its 32 in registers and
// stores them as a run, and an entry's rank among them is its place in
// its run plus a binary search of each other run.  Four block barriers
// (the counts, the compaction, the runs, the ranks), and work in
// proportion to the entries that are not FLOAT_MAX; `run` and `rank_of`
// hold blockDim.x entries and `counts` 96 ints, free again after the
// next barrier.
__device__ int block_rank(uint64_t entry, bool pad, uint64_t* run,
                          int* rank_of, int* counts) {
  const uint32_t max_key = order_key(FLOAT_MAX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const uint32_t key = (uint32_t)(entry >> 32);
  const bool at_max = !pad && key == max_key;
  const bool other = !pad && !at_max;
  const unsigned before_me = (1u << lane) - 1;
  const unsigned maxes = __ballot_sync(0xffffffffu, at_max);
  const unsigned others = __ballot_sync(0xffffffffu, other);
  const unsigned lows = __ballot_sync(0xffffffffu, other && key < max_key);
  if (lane == 0) {
    counts[warp] = __popc(maxes);
    counts[32 + warp] = __popc(others);
    counts[64 + warp] = __popc(lows);
  }
  __syncthreads();
  int max_before = __popc(maxes & before_me);
  int other_before = __popc(others & before_me);
  int n_max = 0, n_other = 0, n_low = 0;
  for (int w = 0; w < warps; ++w) {
    const int a = counts[w], b = counts[32 + w];
    if (w < warp) {
      max_before += a;
      other_before += b;
    }
    n_max += a;
    n_other += b;
    n_low += counts[64 + w];
  }
  if (other) run[other_before] = entry;
  __syncthreads();
  const int runs = (n_other + 31) >> 5;
  uint64_t x = 0;
  if (warp < runs) {
    const int t = threadIdx.x;
    x = warp_sort(t < n_other ? run[t] : pad_entry(blockDim.x + t));
    run[t] = x;
  }
  __syncthreads();
  if (warp < runs && entry_index(x) < (int)blockDim.x) {
    int rank = lane;
#pragma unroll 2
    for (int w = 0; w < runs; ++w)
      if (w != warp) rank += below_in_run(run + 32 * w, x);
    rank_of[entry_index(x)] =
        rank + ((uint32_t)(x >> 32) > max_key ? n_max : 0);
  }
  if (at_max) rank_of[threadIdx.x] = n_low + max_before;
  __syncthreads();
  return rank_of[threadIdx.x];
}

// Open-addressed tables of non-negative int keys in shared memory (size a
// power of two, 2^t_bits, at least twice the keys put), keys NONE when
// empty.
__device__ __forceinline__ int table_home(int key, int t_bits) {
  return (int)(((uint32_t)key * 0x9E3779B1u) >> (32 - t_bits));
}

// Puts key, folding `val` into its value by atomicMin (kMax: atomicMax);
// vals may be null (a set).
template <bool kMax>
__device__ void table_put(int* keys, int* vals, int t_bits, int key, int val) {
  const int mask = (1 << t_bits) - 1;
  for (int h = table_home(key, t_bits);; h = (h + 1) & mask) {
    const int prev = atomicCAS(&keys[h], NONE, key);
    if (prev == NONE || prev == key) {
      if (vals) {
        if (kMax) atomicMax(&vals[h], val);
        else atomicMin(&vals[h], val);
      }
      return;
    }
  }
}

// The slot of key, or NONE when the table does not hold it.
__device__ int table_find(const int* keys, int t_bits, int key) {
  const int mask = (1 << t_bits) - 1;
  for (int h = table_home(key, t_bits);; h = (h + 1) & mask) {
    const int k = keys[h];
    if (k == key) return h;
    if (k == NONE) return NONE;
  }
}

__device__ __forceinline__ int log2_pow2(int n) { return __ffs(n) - 1; }

// beam_expand_kernel's function for a workspace in shared memory, with
// BITS code planes: the popped rows arrive by bulk copy, the fastscan sums
// are popcounts of code planes against the query's 4 level planes, and
// the first occurrence of an id and the hashed table's last writer come
// from warp matches and shared tables instead of scans of every other
// candidate.  Every global read that does not wait on the rows is issued
// at entry, before the test of `active`.
// (At most 1,024 threads, one block an SM at least: ptxas then takes up to
// 64 registers; with the bound alone it kept 32 and spilled at 3 and 4
// bits.)
template <int BITS>
__global__ void __launch_bounds__(1024, 1) beam_expand_bulk_kernel(
    const int* __restrict__ fused, long long fused_stride,
    const int* __restrict__ q_u, const float* __restrict__ coeff_a,
    const float* __restrict__ coeff_b, const float* __restrict__ coeff_c,
    const float* __restrict__ res_d, const bool* __restrict__ active,
    const bool* __restrict__ expand_e, const int64_t* __restrict__ cur_safe,
    const float* __restrict__ dot_slack, const float* __restrict__ d_qp_sq,
    int* __restrict__ visited_hash, bool* __restrict__ visited_dense,
    int* __restrict__ nbr_ids_out, float* __restrict__ est_out,
    float* __restrict__ lower_out, bool* __restrict__ cand_ok_out,
    bool* __restrict__ rerank_out, int64_t* __restrict__ rr_node_out,
    bool* __restrict__ rr_ok_out, float* __restrict__ est_rr_out,
    int64_t* __restrict__ rr_slots_out, int k, int ew, int r, int words,
    int p, int rw, int h_size, long long n, Calib cal, float inv_k,
    float inv_k_msb) {
  const int er = ew * r;
  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qc = (size_t)q * er;
  const size_t qr = (size_t)q * rw;
  const size_t hrow = (size_t)q * (h_size + 1);
  const size_t drow = (size_t)q * (n + 1);
  WALL(0, 8);
  // the reads that need no row, before the test of `active` (a query that
  // is not active reads valid memory too, unused)
  const int c = tid;
  const bool in_range = c < er;
  const int e = in_range ? c / r : 0, j = in_range ? c - e * r : 0;
  const bool is_active = active[q];
  const int64_t row_of_lane =
      warp == 0 && lane < ew ? cur_safe[(size_t)q * ew + lane] : 0;
  const int d0 = warp * 32 + lane;
  const int u0 = warp < words && d0 < p ? q_u[(size_t)q * p + d0] : 0;
  const bool expanded = expand_e[(size_t)q * ew + e];
  const float dqp = d_qp_sq[(size_t)q * ew + e];
  const float ca = coeff_a[q], cb = coeff_b[q], cc = coeff_c[q];
  const float d_k = res_d[(size_t)q * k + k - 1];
  const float slack = dot_slack[q];
  if (!is_active) {
    for (int i = tid; i < er; i += blockDim.x) {
      cand_ok_out[qc + i] = false;
      rerank_out[qc + i] = false;
    }
    for (int i = tid; i < rw; i += blockDim.x) {
      rr_node_out[qr + i] = 0;
      if (rw < er) rr_ok_out[qr + i] = false;
    }
    if (tid == 0) {
      if (h_size) visited_hash[hrow + h_size] = -1;
      else visited_dense[drow + n] = true;
    }
    return;
  }
  STAMP(0, 0);
  const bool capped = rw < er;
  // a row's used span: ids, 4 aux channels, BITS * words plane rows of R
  const int row_words = ((5 + BITS * words) * r + 3) & ~3;
  const int t_size = pow2_at_least(2 * er), t_bits = log2_pow2(t_size);
  Carve ws{smem_ws};
  uint64_t* bar = ws.take<uint64_t>(1);
  int* rows = ws.take<int>((long long)ew * row_words);
  uint32_t* qp = ws.take<uint32_t>(words * LUT_PLANES);
  int* first_key = ws.take<int>(t_size);
  int* first_at = ws.take<int>(t_size);
  int* slot_key = ws.take<int>(t_size);
  int* slot_at = ws.take<int>(t_size);
  uint64_t* run = ws.take<uint64_t>(capped ? blockDim.x : 0);
  int* rank_of = ws.take<int>(capped ? blockDim.x : 0);
  int* counts = ws.take<int>(capped ? 96 : 0);

  // the popped nodes' rows, one bulk copy each, in flight while the block
  // stages the rest
  if (warp == 0) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, (uint32_t)(ew * row_words * 4));
    }
    __syncwarp();
    for (int i = lane; i < ew; i += 32)
      bulk_load(rows + (size_t)i * row_words,
                fused + (i == lane ? row_of_lane
                                   : cur_safe[(size_t)q * ew + i])
                            * fused_stride,
                (uint32_t)(row_words * 4), bar);
  }
  // the query's levels as 4 bit planes a word: bit d of plane l of word w
  // is bit l of q_u at dimension 32 w + d
  for (int w = warp; w < words; w += blockDim.x >> 5) {
    const int d = w * 32 + lane;
    const int u = w == warp ? u0 : d < p ? q_u[(size_t)q * p + d] : 0;
#pragma unroll
    for (int l = 0; l < LUT_PLANES; ++l) {
      const uint32_t plane = __ballot_sync(0xffffffffu, (u >> l) & 1);
      if (lane == l) qp[w * LUT_PLANES + l] = plane;
    }
  }
  for (int i = tid; i < t_size; i += blockDim.x) {
    first_key[i] = NONE;
    first_at[i] = 0x7fffffff;
    slot_key[i] = NONE;
    slot_at[i] = -1;
  }
  const float ca_k = __fmul_rn(ca, inv_k), cb_k = __fmul_rn(cb, inv_k);
  const float ca_m = __fmul_rn(ca, inv_k_msb), cb_m = __fmul_rn(cb, inv_k_msb);
  const bool warmup = !(d_k < FLOAT_MAX);
  __syncthreads();
  STAMP(0, 1);
  mbar_wait(bar, 0);
  STAMP(0, 2);

  const int* row = rows + e * row_words;
  const int id = row[j];
  const bool valid = in_range && id >= 0 && expanded;
  const int sid = valid ? id : 0;

  // the candidate's score: fs = sum over code plane b and level plane l of
  // 2^(BITS-1-b+l) popc(code_b & level_l), exact in int32; its top two
  // code planes give the bound's sums
  const float nop = __int_as_float(row[r + j]);
  const float ip_qo = __int_as_float(row[2 * r + j]);
  const float ip_cp = __int_as_float(row[3 * r + j]);
  const float wpc = __int_as_float(row[4 * r + j]);
  const int* planes = row + 5 * r + j;
  int fs = 0, fs_msb = 0, wpc_msb = 0;
  for (int w = 0; w < words; ++w) {
    const uint4 lv = *reinterpret_cast<const uint4*>(qp + w * LUT_PLANES);
    const uint32_t level[LUT_PLANES] = {lv.x, lv.y, lv.z, lv.w};
    const int tail = p - w * 32;
    const uint32_t dims = tail >= 32 ? 0xffffffffu : (1u << tail) - 1;
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      const uint32_t code = (uint32_t)planes[(b * words + w) * r];
#pragma unroll
      for (int l = 0; l < LUT_PLANES; ++l) {
        const int pc = __popc(code & level[l]);
        fs += pc << (BITS - 1 - b + l);
        if (BITS >= 2 && b < 2) fs_msb += pc << (1 - b + l);
      }
      if (BITS >= 2 && b < 2) wpc_msb += __popc(code & dims) << (1 - b);
    }
  }
  const float ip_full = ip_from_fastscan(ca_k, cb_k, cc, fs, wpc);
  const float ip_bound =
      BITS >= 2 ? ip_from_fastscan(ca_m, cb_m, cc, fs_msb, (float)wpc_msb)
                : ip_full;
  // estimate.distances_with_bounds
  const float sqrt_dqp = __fsqrt_rn(clamp_min_f(dqp, 0.f));
  const float ip_qo_p = clamp_min_f(ip_qo, cal.ip_qo_floor);
  const bool good = ip_qo_p > cal.eps_medium;
  const float denom = clamp_min_f(ip_qo_p, cal.eps_medium);
  const float ip_est = ip_estimate(ip_full, ip_cp, denom, good, cal);
  const float base = __fadd_rn(__fmul_rn(nop, nop), dqp);
  const float two_nop = __fmul_rn(2.f, nop);
  float est = clamp_min_f(__fsub_rn(base, __fmul_rn(two_nop, ip_est)), 0.f);
  const float ip_est_b = ip_estimate(ip_bound, ip_cp, denom, good, cal);
  const float cos_upper = clamp_f(
      __fdiv_rn(__fadd_rn(ip_est_b, slack),
                clamp_min_f(sqrt_dqp, cal.eps_medium)),
      -1.f, 1.f);
  float lower = clamp_min_f(
      __fsub_rn(base, __fmul_rn(__fmul_rn(two_nop, sqrt_dqp), cos_upper)),
      0.f);
  if (!good) lower = 0.f;
  if (dqp < cal.eps_small) {
    est = base;
    lower = 0.f;
  }
  // the visited check (every read of visited before any write)
  const int hslot = sid & (h_size - 1);
  int visit = 0;
  if (in_range)
    visit = h_size ? visited_hash[hrow + hslot] : visited_dense[drow + sid];
  STAMP(0, 3);

  // the first occurrence of an id among the valid candidates: the lowest
  // lane of its warp match, and the lowest candidate of the block's table
  const unsigned below = (1u << lane) - 1;
  const unsigned same_id = __match_any_sync(0xffffffffu, valid ? id : NONE);
  const bool first_in_warp = (same_id & below) == 0;
  if (valid && first_in_warp)
    table_put<false>(first_key, first_at, t_bits, id, c);
  __syncthreads();
  STAMP(0, 4);
  const bool seen = in_range && (h_size ? visit == sid : visit != 0);
  const bool ok0 = valid && !seen && first_in_warp &&
                   first_at[table_find(first_key, t_bits, id)] == c;

  // the visited update: the hashed table's last writer of a slot in row
  // order (the highest lane of its warp match, the highest candidate of
  // the block's table), or the dense rows
  if (h_size) {
    const unsigned same_slot =
        __match_any_sync(0xffffffffu, ok0 ? hslot : NONE);
    const bool last_in_warp = ((same_slot >> lane) >> 1) == 0;
    if (ok0 && last_in_warp)
      table_put<true>(slot_key, slot_at, t_bits, hslot, c);
    __syncthreads();
    if (in_range) {
      const bool mark = ok0 && last_in_warp &&
                        slot_at[table_find(slot_key, t_bits, hslot)] == c;
      if (mark) visited_hash[hrow + hslot] = sid;
      else visited_hash[hrow + h_size] = -1;
    }
  } else if (in_range) {
    visited_dense[drow + (ok0 ? sid : n)] = true;
  }
  STAMP(0, 5);

  // the gates
  const bool ok = ok0 && (warmup || lower < d_k);
  const bool rerank = ok && (warmup || est < d_k);
  if (in_range) {
    nbr_ids_out[qc + c] = id;
    est_out[qc + c] = est;
    lower_out[qc + c] = lower;
    cand_ok_out[qc + c] = ok;
    rerank_out[qc + c] = rerank;
    if (!capped) rr_node_out[qr + c] = sid;
  }
  STAMP(0, 6);
  WALL(0, 9);
  if (!capped) return;
  // the rw best estimates among the reranked candidates, stable
  const int rank = block_rank(sort_entry(rerank ? est : FLOAT_MAX, c),
                              !in_range, run, rank_of, counts);
  if (in_range && rank < rw) {
    rr_slots_out[qr + rank] = c;
    rr_ok_out[qr + rank] = rerank;
    rr_node_out[qr + rank] = sid;
    est_rr_out[qr + rank] = est;
  }
  STAMP(0, 7);
}

// beam_merge_kernel's function for a workspace in shared memory: each
// sort is a block_rank in place of a bitonic network of a barrier a
// phase, every entry's owner writes it at its rank, and the "already
// held" test of a push is a lookup in a shared set of the result ids.
// Every global read is issued at entry, before the test of `active`.
// (At most 768 threads, two blocks an SM: ptxas keeps to 40 registers, so
// that the graph cell's 1,024 blocks of 192 threads fit the card in one
// wave; at 50 it took two.)
__global__ void __launch_bounds__(768, 2) beam_merge_rank_kernel(
    int* __restrict__ res_ids, float* __restrict__ res_d,
    int* __restrict__ res_step, int* __restrict__ last_improve,
    float* __restrict__ beam_est, int* __restrict__ beam_ids,
    float* __restrict__ beam_lower, const float* __restrict__ gamma_q,
    const int* __restrict__ next_step, const bool* __restrict__ active,
    const bool* __restrict__ expand, const bool* __restrict__ expand_e,
    const int* __restrict__ pop_ids, const int64_t* __restrict__ cur_safe,
    const float* __restrict__ d_qp_sq, const int* __restrict__ nbr_ids,
    const float* __restrict__ est, const float* __restrict__ lower,
    const bool* __restrict__ cand_ok, const bool* __restrict__ rerank,
    const int64_t* __restrict__ rr_node, const bool* __restrict__ rr_ok,
    const float* __restrict__ est_rr, const int64_t* __restrict__ rr_slots,
    const float* __restrict__ exact_rr, float* __restrict__ ratio,
    bool* __restrict__ contrib, int beam_cap, int k, int ew, int er, int rw,
    float eps_small) {
  __shared__ float d_k_new;
  WALL(1, 8);
  let_next_grid_start();
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int m = k + rw + ew;          // results, reranked, popped
  const int nb = beam_cap + er;       // beam, candidates
  const size_t qk = (size_t)q * k, qe = (size_t)q * ew, qc = (size_t)q * er;
  const size_t qr = (size_t)q * rw, qb = (size_t)q * beam_cap;
  // every read, issued before the test of `active`: this thread's result
  // or push (t < m), its beam entry (t < nb), its candidate's enqueue
  // value (t < er) and its reranked candidate (t < rw; threads >= nb >= er
  // >= rw)
  const bool is_active = active[q];
  const int step = *next_step;
  const float d_k_old = res_d[qk + k - 1];
  const bool expanding = expand[q];
  const float gamma = gamma_q[q];
  int m_id = 0, m_step = step, pid = -1;
  float m_d = FLOAT_MAX, push_d = FLOAT_MAX;
  bool push_ok = false;
  if (t < k) {
    m_id = res_ids[qk + t];
    m_d = res_d[qk + t];
    m_step = res_step[qk + t];
  } else if (t < k + rw) {
    const int i = t - k;
    m_id = (int)rr_node[qr + i];
    push_ok = rr_ok[qr + i];
    push_d = exact_rr[qr + i];
    pid = m_id;
  } else if (t < m) {
    const int e = t - k - rw;
    pid = pop_ids[qe + e];
    m_id = (int)cur_safe[qe + e];
    push_ok = expand_e[qe + e];
    push_d = d_qp_sq[qe + e];
  }
  float b_val = FLOAT_MAX, b_lower = 0.f;
  int b_id = 0;
  bool b_ok = false;
  if (t < beam_cap) {
    b_val = beam_est[qb + t];
    b_lower = beam_lower[qb + t];
    b_id = beam_ids[qb + t];
  } else if (t < nb) {
    const int c = t - beam_cap;
    b_id = nbr_ids[qc + c];
    b_ok = cand_ok[qc + c];
    b_lower = lower[qc + c];
  }
  const float enq0 =
      t < er ? (rw == er && rerank[qc + t] ? exact_rr[qr + t] : est[qc + t])
             : 0.f;
  bool rr_okay = false;
  float rr_exact = 0.f, rr_est = 0.f;
  int64_t rr_slot = 0;
  if (t < rw) {
    rr_okay = rr_ok[qr + t];
    rr_exact = exact_rr[qr + t];
    rr_est = est_rr[qr + t];
    if (rw < er) rr_slot = rr_slots[qr + t];
  }
  if (!is_active) {
    if (t < rw) {
      ratio[qr + t] = 0.f;
      contrib[qr + t] = false;
    }
    return;
  }
  STAMP(1, 0);
  const bool warmup = !(d_k_old < FLOAT_MAX);
  const int t_size = pow2_at_least(2 * k), t_bits = log2_pow2(t_size);
  Carve ws{smem_ws};
  uint64_t* run = ws.take<uint64_t>(blockDim.x);
  int* rank_of = ws.take<int>(blockDim.x);
  int* counts = ws.take<int>(96);
  float* old_d = ws.take<float>(k);
  int* held = ws.take<int>(t_size);
  float* enq_val = ws.take<float>(er);
  if (t < er) enq_val[t] = enq0;
  for (int i = t; i < t_size; i += blockDim.x) held[i] = NONE;
  __syncthreads();
  STAMP(1, 1);
  if (t < k) {
    old_d[t] = m_d;
    if (m_id >= 0) table_put<false>(held, nullptr, t_bits, m_id, 0);
  }
  // the reranked entries carry their exact distances into the beam
  if (t < rw && rw < er) enq_val[rr_slot] = rr_okay ? rr_exact : rr_est;
  __syncthreads();
  STAMP(1, 2);

  // the pushes: reranked candidates, then popped nodes, none already held
  if (t >= k && t < m) {
    const bool ask = t < k + rw ? push_ok : pid >= 0;
    const bool held_id = ask && table_find(held, t_bits, pid) != NONE;
    m_d = push_ok && !held_id ? push_d : FLOAT_MAX;
  }
  const int rank = block_rank(sort_entry(m_d, t), t >= m, run, rank_of,
                              counts);
  STAMP(1, 3);
  bool improved = false;
  if (t < m && rank < k) {
    if (expanding) {
      improved = m_d != old_d[rank];
      res_ids[qk + rank] = m_id;
      res_d[qk + rank] = m_d;
      res_step[qk + rank] = m_step;
    }
    if (rank == k - 1) d_k_new = expanding ? m_d : old_d[k - 1];
  }
  if (__syncthreads_or(improved) && t == 0) last_improve[q] = step;
  STAMP(1, 4);

  // the DABS enqueue, then the stable top beam_cap of beam and candidates
  const float thresh =
      d_k_new < FLOAT_MAX ? __fmul_rn(gamma, d_k_new) : FLOAT_MAX;
  if (t >= beam_cap && t < nb) {
    const float ev = enq_val[t - beam_cap];
    b_val = b_ok && ev < thresh ? ev : FLOAT_MAX;
    if (warmup) b_lower = ev;
  }
  const int b_rank = block_rank(sort_entry(b_val, t), t >= nb, run, rank_of,
                                counts);
  STAMP(1, 5);
  if (t < nb && b_rank < beam_cap) {
    beam_est[qb + b_rank] = b_val;
    beam_ids[qb + b_rank] = b_id;
    beam_lower[qb + b_rank] = b_lower;
  }

  // the gamma adaptation's ratio of each reranked candidate
  if (t < rw) {
    const bool c = rr_okay && !warmup && rr_exact > eps_small;
    ratio[qr + t] = c ? __fdiv_rn(rr_est, clamp_min_f(rr_exact, eps_small))
                      : 0.f;
    contrib[qr + t] = c;
  }
  STAMP(1, 6);
  WALL(1, 9);
}

// ------------------------------------------------------------------------
// The pop and the gamma update: a warp per query, up to WARP_QUERIES
// queries a block (kernels/beam_step.py WARP_THREADS).

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_QUERIES = 8;
// Beam entries a lane of the pop holds in registers: beam_cap up to 256
// (the graph cell's 64, a shard's 128); the slots beyond are read again
// from L1 in each rescan.
constexpr int POP_KEEP = 8;

// The value whose order_key is `key` (order_key's inverse).
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The smallest of the warp's entries, in every lane.
__device__ __forceinline__ uint64_t warp_min(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t y = __shfl_xor_sync(FULL, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// The smallest entry of at least `lo` among the lane's slots of the row
// (j = lane + 32 i, the first POP_KEEP of them as order keys in `key`),
// or SORT_PAD when there is none.
__device__ __forceinline__ uint64_t lane_next(const uint32_t (&key)[POP_KEEP],
                                              const float* row, int beam_cap,
                                              int lane, uint64_t lo) {
  uint64_t best = SORT_PAD;
#pragma unroll
  for (int i = 0; i < POP_KEEP; ++i) {
    const int j = lane + 32 * i;
    const uint64_t e = ((uint64_t)key[i] << 32) | (uint32_t)j;
    if (j < beam_cap && e >= lo && e < best) best = e;
  }
  for (int j = lane + 32 * POP_KEEP; j < beam_cap; j += 32) {
    const uint64_t e = sort_entry(row[j], j);
    if (e >= lo && e < best) best = e;
  }
  return best;
}

__global__ void __launch_bounds__(32 * WARP_QUERIES) beam_pop_kernel(
    float* __restrict__ beam_est, const int* __restrict__ beam_ids,
    const float* __restrict__ beam_lower, const float* __restrict__ res_d,
    const float* __restrict__ gamma_q, bool* __restrict__ done,
    int* __restrict__ slack_cnt, const float* __restrict__ slack_levels,
    const int* __restrict__ steps, bool* __restrict__ active_out,
    bool* __restrict__ expand_out, bool* __restrict__ expand_e_out,
    int* __restrict__ pop_ids_out, int64_t* __restrict__ cur_safe_out,
    float* __restrict__ dot_slack_out, int* __restrict__ next_step,
    int q_count, int beam_cap, int k, int ew, int num_levels) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= q_count) return;
  wait_for_previous_grid();
  // every read that does not wait on the selection, the beam's first
  // POP_KEEP entries a lane among them, coalesced
  float* row = beam_est + (size_t)q * beam_cap;
  const bool was_done = done[q];
  const float d_k = res_d[(size_t)q * k + k - 1];
  const float gamma = gamma_q[q];
  const int cnt = slack_cnt[q];
  const float slack = slack_levels[min(cnt, num_levels - 1)];
  uint32_t key[POP_KEEP];
#pragma unroll
  for (int i = 0; i < POP_KEEP; ++i) {
    const int j = lane + 32 * i;
    key[i] = j < beam_cap ? order_key(row[j]) : 0u;
  }
  if (q == 0 && lane == 0) *next_step = *steps + 1;
  const size_t qe = (size_t)q * ew;
  if (was_done) {
    for (int e = lane; e < ew; e += 32) {
      expand_e_out[qe + e] = false;
      pop_ids_out[qe + e] = -1;
      cur_safe_out[qe + e] = 0;
    }
    if (lane == 0) {
      active_out[q] = false;
      expand_out[q] = false;
      dot_slack_out[q] = 0.f;
    }
    return;
  }

  // E rounds of a warp argmin; lane (e mod 32) keeps the winner of round e
  // and, after each 32 rounds and the last, handles its popped entry
  const bool res_full = d_k < FLOAT_MAX;
  uint64_t cur = lane_next(key, row, beam_cap, lane, 0);
  uint64_t mine = SORT_PAD, win = 0;
  bool active = false;
  int expanded = 0;
  for (int e = 0; e < ew; ++e) {
    win = warp_min(cur);
    if (lane == (entry_index(win) & 31))
      cur = lane_next(key, row, beam_cap, lane, win + 1);
    if (lane == (e & 31)) mine = win;
    if (e == 0) {
      const float pop0 = key_value((uint32_t)(win >> 32));
      const bool terminate = res_full && pop0 >= __fmul_rn(gamma, d_k);
      active = pop0 < FLOAT_MAX && !terminate;
    }
    if ((e & 31) == 31 || e == ew - 1) {
      const int pe = (e & ~31) + lane;
      bool ex = false;
      if (pe <= e) {
        const int s = entry_index(mine);
        const size_t at = (size_t)q * beam_cap + s;
        const bool valid = key_value((uint32_t)(mine >> 32)) < FLOAT_MAX;
        const bool skip = res_full && beam_lower[at] > d_k;
        const int id = beam_ids[at];
        ex = active && valid && !skip;
        expand_e_out[qe + pe] = ex;
        pop_ids_out[qe + pe] = id;
        cur_safe_out[qe + pe] = ex ? (int64_t)id : 0;
      }
      expanded += __popc(__ballot_sync(FULL, ex));
    }
  }
  // the popped slots of an active query (every entry up to the last
  // winner) that held a value go to FLOAT_MAX
  if (active) {
#pragma unroll
    for (int i = 0; i < POP_KEEP; ++i) {
      const int j = lane + 32 * i;
      const uint64_t e = ((uint64_t)key[i] << 32) | (uint32_t)j;
      if (j < beam_cap && e <= win && key_value(key[i]) < FLOAT_MAX)
        row[j] = FLOAT_MAX;
    }
    for (int j = lane + 32 * POP_KEEP; j < beam_cap; j += 32) {
      const float v = row[j];
      if (sort_entry(v, j) <= win && v < FLOAT_MAX) row[j] = FLOAT_MAX;
    }
  }
  if (lane == 0) {
    dot_slack_out[q] = slack;
    slack_cnt[q] = cnt + expanded;
    done[q] = !active;
    active_out[q] = active;
    expand_out[q] = expanded > 0;
  }
}

__global__ void __launch_bounds__(32 * WARP_QUERIES) beam_gamma_kernel(
    float* __restrict__ ratio_sum, float* __restrict__ ratio_sq,
    int* __restrict__ ratio_cnt, float* __restrict__ gamma_q,
    const bool* __restrict__ expand, const float* __restrict__ ratio,
    const bool* __restrict__ contrib, int q, int rw, float gamma,
    float gamma_max, float gamma_beta, int gamma_warmup) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  wait_for_previous_grid();
  let_next_grid_start();
  if (i >= q) return;
  const bool ex = expand[i];
  const float sum0 = ratio_sum[i], sq0 = ratio_sq[i];
  const int cnt0 = ratio_cnt[i];
  // the sums of the ratios and of their squares in the order of the plain
  // segment (`_lane_sums`): lane l from +0.0 over l, l + 32, ..., then the
  // lanes folded at 16, 8, 4, 2, 1; and the count of contributing entries
  float row_sum = 0.f, row_sq = 0.f;
  int cnt = 0;
  if (ex) {
    const float* r = ratio + (size_t)i * rw;
    const bool* c = contrib + (size_t)i * rw;
    for (int j = lane; j < rw; j += 32) {
      const float x = r[j];
      row_sum = __fadd_rn(row_sum, x);
      row_sq = __fadd_rn(row_sq, __fmul_rn(x, x));
      cnt += c[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    row_sum = __fadd_rn(row_sum, __shfl_xor_sync(FULL, row_sum, off));
    row_sq = __fadd_rn(row_sq, __shfl_xor_sync(FULL, row_sq, off));
    cnt += __shfl_xor_sync(FULL, cnt, off);
  }
  if (lane != 0) return;
  const float sum = __fadd_rn(sum0, ex ? row_sum : 0.f);
  const float sq = __fadd_rn(sq0, ex ? row_sq : 0.f);
  const int n = cnt0 + cnt;
  const float cnt_f = clamp_min_f(__int2float_rn(n), 1.f);
  const float mean = __fdiv_rn(sum, cnt_f);
  const float var = clamp_min_f(
      __fsub_rn(__fdiv_rn(sq, cnt_f), __fmul_rn(mean, mean)), 0.f);
  // gamma * (1 + beta * r_std), clamped to [gamma, gamma_max]
  const float g = clamp_f(
      __fmul_rn(__fadd_rn(__fmul_rn(__fsqrt_rn(var), gamma_beta), 1.f), gamma),
      gamma, gamma_max);
  ratio_sum[i] = sum;
  ratio_sq[i] = sq;
  ratio_cnt[i] = n;
  if (ex && n >= gamma_warmup) gamma_q[i] = g;
}

template <typename Kernel>
int opt_in(Kernel kernel, int smem) {
  // per device: set on every launch, a second card needs it too
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches a warp-per-query kernel (`threads` / 32 queries a block, no
// dynamic shared memory) for q queries on `stream` with programmatic stream
// serialization: its blocks may start while the kernel before it on the
// stream finishes, and wait in wait_for_previous_grid.  A CUDA graph
// captures the launch as a programmatic edge.
template <typename... Params, typename... Args>
int launch_after_previous(void (*kernel)(Params...), int q, int threads,
                          void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((q + threads / 32 - 1) / (threads / 32));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef BEAM_STAMPS
// Clears the stamps (before a launch) or copies them to the host buffer
// `dst` (2 x STAMP_BLOCKS x STAMP_SLOTS int64).
int beam_stamps_clear() {
  void* p;
  int err = (int)cudaGetSymbolAddress(&p, beam_stamps);
  return err ? err : (int)cudaMemset(p, 0, sizeof(beam_stamps));
}
int beam_stamps_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, beam_stamps, sizeof(beam_stamps));
}
#endif

int beam_pop_launch(void* beam_est, const void* beam_ids,
                    const void* beam_lower, const void* res_d,
                    const void* gamma_q, void* done, void* slack_cnt,
                    const void* slack_levels, const void* steps, void* active,
                    void* expand, void* expand_e, void* pop_ids,
                    void* cur_safe, void* dot_slack, void* next_step, int q,
                    int beam_cap, int k, int ew, int num_levels, int threads,
                    void* stream) {
  return launch_after_previous(
      beam_pop_kernel, q, threads, stream, (float*)beam_est,
      (const int*)beam_ids, (const float*)beam_lower, (const float*)res_d,
      (const float*)gamma_q, (bool*)done, (int*)slack_cnt,
      (const float*)slack_levels, (const int*)steps, (bool*)active,
      (bool*)expand, (bool*)expand_e, (int*)pop_ids, (int64_t*)cur_safe,
      (float*)dot_slack, (int*)next_step, q, beam_cap, k, ew, num_levels);
}

int beam_expand_launch(
    const void* fused, long long fused_stride, const void* q_u,
    const void* coeff_a, const void* coeff_b, const void* coeff_c,
    const void* res_d, const void* active, const void* expand_e,
    const void* cur_safe, const void* dot_slack, const void* d_qp_sq,
    void* visited, void* nbr_ids, void* est, void* lower, void* cand_ok,
    void* rerank, void* rr_node, void* rr_ok, void* est_rr, void* rr_slots,
    int q, int k, int ew, int r, int words, int bits, int p, int rw,
    int h_size, long long n, float affine_a, float affine_b,
    float ip_qo_floor, float eps_medium, float eps_small, float inv_k,
    float inv_k_msb, int variant, int threads, int smem, void* scratch,
    long long ws_bytes, void* stream) {
  const Calib cal{affine_a, affine_b, ip_qo_floor, eps_medium, eps_small};
  if (variant == 1) {
    auto kernel = bits == 1   ? beam_expand_bulk_kernel<1>
                  : bits == 2 ? beam_expand_bulk_kernel<2>
                  : bits == 3 ? beam_expand_bulk_kernel<3>
                              : beam_expand_bulk_kernel<4>;
    int err = opt_in(kernel, smem);
    if (err) return err;
    kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
        (const int*)fused, fused_stride, (const int*)q_u,
        (const float*)coeff_a, (const float*)coeff_b, (const float*)coeff_c,
        (const float*)res_d, (const bool*)active, (const bool*)expand_e,
        (const int64_t*)cur_safe, (const float*)dot_slack,
        (const float*)d_qp_sq, h_size ? (int*)visited : nullptr,
        h_size ? nullptr : (bool*)visited, (int*)nbr_ids, (float*)est,
        (float*)lower, (bool*)cand_ok, (bool*)rerank, (int64_t*)rr_node,
        (bool*)rr_ok, (float*)est_rr, (int64_t*)rr_slots, k, ew, r, words,
        p, rw, h_size, n, cal, inv_k, inv_k_msb);
    return (int)cudaGetLastError();
  }
  auto kernel = scratch ? beam_expand_kernel<false> : beam_expand_kernel<true>;
  int err = opt_in(kernel, smem);
  if (err) return err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      (const int*)fused, fused_stride, (const int*)q_u,
      (const float*)coeff_a, (const float*)coeff_b, (const float*)coeff_c,
      (const float*)res_d, (const bool*)active, (const bool*)expand_e,
      (const int64_t*)cur_safe, (const float*)dot_slack,
      (const float*)d_qp_sq, h_size ? (int*)visited : nullptr,
      h_size ? nullptr : (bool*)visited, (int*)nbr_ids, (float*)est,
      (float*)lower, (bool*)cand_ok, (bool*)rerank, (int64_t*)rr_node,
      (bool*)rr_ok, (float*)est_rr, (int64_t*)rr_slots, k, ew, r, words,
      bits, p, rw, h_size, n, cal, inv_k, inv_k_msb,
      (unsigned char*)scratch, ws_bytes);
  return (int)cudaGetLastError();
}

int beam_merge_launch(
    void* res_ids, void* res_d, void* res_step, void* last_improve,
    void* beam_est, void* beam_ids, void* beam_lower, const void* gamma_q,
    const void* next_step, const void* active, const void* expand,
    const void* expand_e, const void* pop_ids, const void* cur_safe,
    const void* d_qp_sq, const void* nbr_ids, const void* est,
    const void* lower, const void* cand_ok, const void* rerank,
    const void* rr_node, const void* rr_ok, const void* est_rr,
    const void* rr_slots, const void* exact_rr, void* ratio, void* contrib,
    int q, int beam_cap, int k, int ew, int er, int rw, float eps_small,
    int variant, int threads, int smem, void* scratch, long long ws_bytes,
    void* stream) {
  if (variant == 1) {
    int err = opt_in(beam_merge_rank_kernel, smem);
    if (err) return err;
    beam_merge_rank_kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
        (int*)res_ids, (float*)res_d, (int*)res_step, (int*)last_improve,
        (float*)beam_est, (int*)beam_ids, (float*)beam_lower,
        (const float*)gamma_q, (const int*)next_step, (const bool*)active,
        (const bool*)expand, (const bool*)expand_e, (const int*)pop_ids,
        (const int64_t*)cur_safe, (const float*)d_qp_sq, (const int*)nbr_ids,
        (const float*)est, (const float*)lower, (const bool*)cand_ok,
        (const bool*)rerank, (const int64_t*)rr_node, (const bool*)rr_ok,
        (const float*)est_rr, (const int64_t*)rr_slots,
        (const float*)exact_rr, (float*)ratio, (bool*)contrib, beam_cap, k,
        ew, er, rw, eps_small);
    return (int)cudaGetLastError();
  }
  auto kernel = scratch ? beam_merge_kernel<false> : beam_merge_kernel<true>;
  int err = opt_in(kernel, smem);
  if (err) return err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      (int*)res_ids, (float*)res_d, (int*)res_step, (int*)last_improve,
      (float*)beam_est, (int*)beam_ids, (float*)beam_lower,
      (const float*)gamma_q, (const int*)next_step, (const bool*)active,
      (const bool*)expand, (const bool*)expand_e, (const int*)pop_ids,
      (const int64_t*)cur_safe, (const float*)d_qp_sq, (const int*)nbr_ids,
      (const float*)est, (const float*)lower, (const bool*)cand_ok,
      (const bool*)rerank, (const int64_t*)rr_node, (const bool*)rr_ok,
      (const float*)est_rr, (const int64_t*)rr_slots,
      (const float*)exact_rr, (float*)ratio, (bool*)contrib, beam_cap, k, ew,
      er, rw, eps_small, (unsigned char*)scratch, ws_bytes);
  return (int)cudaGetLastError();
}

int beam_gamma_launch(void* ratio_sum, void* ratio_sq, void* ratio_cnt,
                      void* gamma_q, const void* expand, const void* ratio,
                      const void* contrib, int q, int rw, float gamma,
                      float gamma_max, float gamma_beta, int gamma_warmup,
                      int threads, void* stream) {
  return launch_after_previous(
      beam_gamma_kernel, q, threads, stream, (float*)ratio_sum,
      (float*)ratio_sq, (int*)ratio_cnt, (float*)gamma_q, (const bool*)expand,
      (const float*)ratio, (const bool*)contrib, q, rw, gamma, gamma_max,
      gamma_beta, gamma_warmup);
}

}  // extern "C"
