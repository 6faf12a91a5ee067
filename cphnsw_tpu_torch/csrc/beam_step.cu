// One step of the graph beam (search/beam.py `_step`) as three kernels
// around the exact distances, one block per query, and a fourth for the
// gamma update, one warp per query.
//
//   beam_pop_kernel     the pop: top-E of the beam (stable), the DABS
//                       termination, the popped slots set to FLOAT_MAX, the
//                       lower-bound skip, the nodes to expand, the slack
//                       level and its count.
//   (torch)             the exact distance to each popped node,
//                       estimate.exact_l2_sq.
//   beam_expand_kernel  the E*R candidates of the popped nodes' fused rows:
//                       bit-plane unpack and fastscan sums in int32, the
//                       estimate and its lower bound, the visited check,
//                       the intra-step dedup, the visited update (the hash
//                       table's last writer in row order, or the dense
//                       (Q, n + 1) bool rows), the gates, and the rw
//                       candidates to rerank.
//   (torch)             the exact distances of those candidates.
//   beam_merge_kernel   the result pushes, the stable top-k of the results,
//                       the DABS enqueue, the stable top beam_cap of the
//                       beam, and the per-candidate ratio of the gamma
//                       adaptation.
//   (torch)             the two float sums of those ratios per query.
//   beam_gamma_kernel   the gamma adaptation's update from those sums (one
//                       warp per query: its elementwise ops, the count of
//                       contributing candidates in int32).
//
// No TPU kernel stands behind these: the JAX package's step runs as XLA
// ops, whose fusion made its Pallas step kernel slower and got it retired
// (PARITY.md:134-152).  In PyTorch each of the step's ~255 ops is a kernel
// of its own, each at its launch floor.
//
// Each kernel reproduces its torch segment bit for bit: float32 arithmetic
// in torch's order with one rounding per torch op (__fmul_rn and the like,
// never contracted into an FMA), NaN passing through the clamps as ATen's
// clamps let it, every stable sort as a bitonic sort of 64-bit entries
// (the value's radix-sort bits above its index: the order of a stable
// sort on values without NaN and -0, which the step never makes), the
// fastscan sums in int32 (torch sums them exactly in float32).  The
// scalars come from the host as float32, rounded from doubles as ATen
// rounds a Python scalar.
//
// Each block works in one workspace of its own: dynamic shared memory
// where it fits (227 KB a block), else a slice of a global scratch buffer
// that the host allocates (a beam of thousands of entries at large k, or
// a wide query), laid out alike.  The kernels take any beam_cap, k, E, R,
// rerank width and padded dimension; the host refuses only what the plain
// step cannot compute either (kernels/beam_step.py, launch_plan).
//
// What bounds them on an H100: the bytes of the active queries (the
// fused rows of the popped nodes, the visited slots, the beam and result
// state, the candidates between the kernels), ~73 KB per query a step at
// R = 32, E = 4, 1 bit, P = 128; their ops are a few hundred integer and
// float operations per candidate.  A query already done returns at once
// (the gamma update, a few bytes per query, reads its flag and state).

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
__global__ void beam_pop_kernel(
    float* __restrict__ beam_est, const int* __restrict__ beam_ids,
    const float* __restrict__ beam_lower, const float* __restrict__ res_d,
    const float* __restrict__ gamma_q, bool* __restrict__ done,
    int* __restrict__ slack_cnt, const float* __restrict__ slack_levels,
    bool* __restrict__ active_out, bool* __restrict__ expand_out,
    bool* __restrict__ expand_e_out, int* __restrict__ pop_ids_out,
    int64_t* __restrict__ cur_safe_out, float* __restrict__ dot_slack_out,
    int beam_cap, int k, int ew, int num_levels,
    unsigned char* __restrict__ scratch, long long ws_bytes) {
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  float* est = beam_est + (size_t)q * beam_cap;
  const size_t qe = (size_t)q * ew;
  if (done[q]) {
    for (int e = tid; e < ew; e += blockDim.x) {
      expand_e_out[qe + e] = false;
      pop_ids_out[qe + e] = -1;
      cur_safe_out[qe + e] = 0;
    }
    if (tid == 0) {
      active_out[q] = false;
      expand_out[q] = false;
      dot_slack_out[q] = 0.f;
    }
    return;
  }
  Carve ws = workspace<kShared>(scratch, ws_bytes);
  const int pad = pow2_at_least(beam_cap);
  uint64_t* key = ws.take<uint64_t>(pad);
  for (int i = tid; i < pad; i += blockDim.x)
    key[i] = i < beam_cap ? sort_entry(est[i], i) : SORT_PAD;
  __syncthreads();
  block_sort(key, pad);
  if (tid != 0) return;
  const float d_k = res_d[(size_t)q * k + k - 1];
  const bool res_full = d_k < FLOAT_MAX;
  const float pop0 = est[entry_index(key[0])];
  const bool terminate = res_full && pop0 >= __fmul_rn(gamma_q[q], d_k);
  const bool now_done = !(pop0 < FLOAT_MAX) || terminate;
  const bool active = !now_done;
  int expanded = 0;
  for (int e = 0; e < ew; ++e) {
    const int s = entry_index(key[e]);
    const size_t at = (size_t)q * beam_cap + s;
    const bool valid = est[s] < FLOAT_MAX;
    const bool skip = res_full && beam_lower[at] > d_k;
    const bool ex = active && valid && !skip;
    const int id = beam_ids[at];
    expand_e_out[qe + e] = ex;
    pop_ids_out[qe + e] = id;
    cur_safe_out[qe + e] = ex ? (int64_t)id : 0;
    expanded += ex;
    if (active && valid) est[s] = FLOAT_MAX;
  }
  const int cnt = slack_cnt[q];
  dot_slack_out[q] = slack_levels[min(cnt, num_levels - 1)];
  slack_cnt[q] = cnt + expanded;
  done[q] = now_done;
  active_out[q] = active;
  expand_out[q] = expanded > 0;
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

__global__ void beam_gamma_kernel(
    float* __restrict__ ratio_sum, float* __restrict__ ratio_sq,
    int* __restrict__ ratio_cnt, float* __restrict__ gamma_q,
    const bool* __restrict__ expand, const float* __restrict__ row_sum,
    const float* __restrict__ row_sq, const bool* __restrict__ contrib,
    int q, int rw, float gamma, float gamma_max, float gamma_beta,
    int gamma_warmup) {
  // one warp per query: its lanes count the contributing candidates
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= q) return;
  const bool ex = expand[i];
  int cnt = 0;
  if (ex)
    for (int j = lane; j < rw; j += 32) cnt += contrib[(size_t)i * rw + j];
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane != 0) return;
  const float sum = __fadd_rn(ratio_sum[i], ex ? row_sum[i] : 0.f);
  const float sq = __fadd_rn(ratio_sq[i], ex ? row_sq[i] : 0.f);
  const int n = ratio_cnt[i] + cnt;
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

}  // namespace

extern "C" {

int beam_pop_launch(void* beam_est, const void* beam_ids,
                    const void* beam_lower, const void* res_d,
                    const void* gamma_q, void* done, void* slack_cnt,
                    const void* slack_levels, void* active, void* expand,
                    void* expand_e, void* pop_ids, void* cur_safe,
                    void* dot_slack, int q, int beam_cap, int k, int ew,
                    int num_levels, int threads, int smem, void* scratch,
                    long long ws_bytes, void* stream) {
  auto kernel = scratch ? beam_pop_kernel<false> : beam_pop_kernel<true>;
  int err = opt_in(kernel, smem);
  if (err) return err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      (float*)beam_est, (const int*)beam_ids, (const float*)beam_lower,
      (const float*)res_d, (const float*)gamma_q, (bool*)done,
      (int*)slack_cnt, (const float*)slack_levels, (bool*)active,
      (bool*)expand, (bool*)expand_e, (int*)pop_ids, (int64_t*)cur_safe,
      (float*)dot_slack, beam_cap, k, ew, num_levels,
      (unsigned char*)scratch, ws_bytes);
  return (int)cudaGetLastError();
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
    float inv_k_msb, int threads, int smem, void* scratch, long long ws_bytes,
    void* stream) {
  auto kernel = scratch ? beam_expand_kernel<false> : beam_expand_kernel<true>;
  int err = opt_in(kernel, smem);
  if (err) return err;
  const Calib cal{affine_a, affine_b, ip_qo_floor, eps_medium, eps_small};
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
    int threads, int smem, void* scratch, long long ws_bytes,
    void* stream) {
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
                      void* gamma_q, const void* expand, const void* row_sum,
                      const void* row_sq, const void* contrib, int q, int rw,
                      float gamma, float gamma_max, float gamma_beta,
                      int gamma_warmup, int threads, void* stream) {
  int err = opt_in(beam_gamma_kernel, 0);
  if (err) return err;
  const int per_block = threads / 32;
  beam_gamma_kernel<<<(q + per_block - 1) / per_block, threads, 0,
                      (cudaStream_t)stream>>>(
      (float*)ratio_sum, (float*)ratio_sq, (int*)ratio_cnt, (float*)gamma_q,
      (const bool*)expand, (const float*)row_sum, (const float*)row_sq,
      (const bool*)contrib, q, rw, gamma, gamma_max, gamma_beta,
      gamma_warmup);
  return (int)cudaGetLastError();
}

}  // extern "C"
