// Fused int8 scan + per-bin top-4 key selection for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// cphnsw_tpu/search/scan.py::_fused_kernel (launched by fused_scan_keys).
// For every query q and kernel-padded store row r (rows_kpad = groups*bins):
//
//   fs    = <q[q], codes[r]>                          int8 x int8 -> int32
//   score = (w_fs[q] * aux[5][r]) * fs + sum_{a<5} y_aux[q][a] * aux[a][r]
//   key   = signed-monotone int32 of score, low 10 bits := group = r / bins
//
// and per (q, bin = r % bins) it keeps the 4 smallest keys over all groups.
// out is (q_rows, 4*bins) int32: plane t of (q, bin) at column t*bins + bin.
//
// What bounds it.  At the main path's shape (Q = 2048 queries, 1M rows,
// P = 128) the int8 products are 5.2e11 operations against 186 MB of
// inputs and outputs: 0.27 ms on the tensor cores at the card's int8 peak,
// 0.06 ms at its memory rate.  But every (query, row) element also needs
// its affine score (a convert, 2 multiplies and 5 FMAs in a fixed order),
// its key (3 integer ops) and a top-4 insert (7 min/max) on the CUDA
// cores, and that epilogue, not the product, sets the floor.  The design
// keeps the product off the CUDA cores and hides everything else behind
// the epilogue:
//
//  * the product runs on the tensor cores: wgmma m64n32k32 s32.s8.s8, both
//    operands K-major in shared memory with the 128-byte swizzle that TMA
//    writes (one code row of P = 128 bytes is one swizzle line);
//  * a block owns 128 queries x 32 bins for its range of groups.  Its
//    query tile is loaded once by TMA and stays resident (P <= 1024; above
//    that the query chunks stream through the ring beside the codes);
//    each group's codes (32 rows x 128 bytes per K chunk) and aux slice
//    (6 x 32 f32) stream through rings of stages that one producer thread
//    fills with TMA, paced by mbarriers;
//  * two consumer warpgroups each own 64 queries and take the producer
//    warpgroup's registers (setmaxnreg: 240 each, no spills).  Each starts
//    group g+1's wgmma into a second accumulator before running group g's
//    epilogue, so the tensor cores and the copies overlap it.  No wgmma is
//    in flight across a branch or a loop edge: otherwise ptxas serializes
//    them all;
//  * the top-4 state (4 keys per owned (query, bin)) lives in registers
//    for the whole group loop and is written once.  Every key goes through
//    the 7-op insert (of depth 2): testing it against the 4th key first
//    (exact, and nearly always false after the first groups) measured
//    slower, whether the compiler predicated the test or a warp vote
//    skipped the insert;
//  * fs converts to float with a magic-number add where that is exact
//    (|fs| <= 2^22, i.e. P <= 256) instead of the quarter-rate I2F;
//  * the group axis is split over blockIdx.z when the output tiles alone
//    do not fill the card (small query batches): each range writes partial
//    planes and merge_kernel takes the 4 smallest per (query, bin).  Keys
//    of one bin carry distinct group bits, so that merge is exact and
//    order-free.
//
// The epilogue rounds in the order XLA gives the JAX kernel on the CPU,
// written out with explicit intrinsics so nvcc contracts nothing else:
//   s = fma(w*g, fs, y0*aux0);  s = fma(y_a, aux_a, s) for a = 1..4.
// Its keys are bit-equal to the plain PyTorch version's (which emulates the
// same fused multiply-adds) and to the JAX package's on the CPU.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;                       // bins per tile: the wgmma N
constexpr int ACC = BN / 2;                  // accumulators per thread
constexpr int WG_ROWS = 64;                  // queries per warpgroup: wgmma M
constexpr int CONSUMERS = 2;                 // consumer warpgroups
constexpr int BQ = CONSUMERS * WG_ROWS;      // queries per tile
// + a producer warpgroup, which hands its registers to the consumers
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;           // (512 - 24) / 2, in steps of 8
constexpr int KC = 128;                      // K bytes per TMA box (swizzle)
constexpr int KSTEP = 32;                    // K bytes per wgmma
constexpr int QRES_CHUNKS = 8;               // query tile resident: P <= 1024
constexpr int AUX_SLOTS = 4;
constexpr int NAUX = 6;
constexpr int NY = 5;
constexpr int TOPM = 4;
constexpr int Q_CHUNK = BQ * KC;             // 16 KB
constexpr int C_CHUNK = BN * KC;             // 4 KB
constexpr int AUX_BYTES = NAUX * BN * 4;     // 768 B
constexpr int32_t NOT_GROUP = ~((1 << 10) - 1);
constexpr int32_t I32_MAX = 0x7FFFFFFF;

// Shared memory, from a 1024-aligned base: [resident query chunks]
// [code stages (+ query chunk when streaming)] [aux slots] [mbarriers].
struct Layout {
    int nst;              // code stages
    uint32_t stage_off, stage_bytes, aux_off, bar_off, bytes;
};

// Code stages: two groups in flight when the query tile is resident.
__host__ __device__ constexpr int ring_stages(int nkc, bool resident)
{
    return resident && 2 * nkc > 4 ? 2 * nkc : 4;
}

__host__ __device__ inline Layout make_layout(int nkc, bool resident)
{
    Layout l;
    l.nst = ring_stages(nkc, resident);
    l.stage_off = resident ? nkc * Q_CHUNK : 0;
    l.stage_bytes = C_CHUNK + (resident ? 0 : Q_CHUNK);
    l.aux_off = l.stage_off + l.nst * l.stage_bytes;
    l.bar_off = l.aux_off + AUX_SLOTS * AUX_BYTES;
    l.bytes = l.bar_off + 8 * (1 + 2 * l.nst + 2 * AUX_SLOTS);
    return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Arrives from the lanes where `pred` holds, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred)
{
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
                 "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n\t}"
                 :: "r"(smem_u32(bar)), "r"(static_cast<int>(pred))
                 : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// outlasts ~2^26 polls (seconds; a real one takes microseconds) is a
// pipeline fault: trap, so the launch fails instead of hanging the card.
// (The loop lives inside one asm block, so the compiler sees no divergent
// branch between a warpgroup's wgmmas.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
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

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row atoms
// 1024 bytes apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr)
{
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
        | (static_cast<uint64_t>(1) << 16)
        | (static_cast<uint64_t>(1024 >> 4) << 32)
        | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Orders register accesses of `d` against the asynchronous wgmma.
__device__ __forceinline__ void fence_regs(int32_t (&d)[ACC])
{
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A(64 x 32, K-major) * B(32 x 32, K-major)^T, int8 -> int32.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate)
{
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n\t}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
}

// Inserts carry into the sorted 4 smallest b: slot t takes carry clamped
// to [b[t-1], b[t]].  The same 7 min/max as the insertion chain, but no
// op waits on more than one other.
__device__ __forceinline__ void insert4(int32_t (&b)[TOPM], int32_t carry)
{
#pragma unroll
    for (int t = TOPM - 1; t > 0; --t) b[t] = max(b[t - 1], min(b[t], carry));
    b[0] = min(b[0], carry);
}

// One consumer warpgroup's state: 64 queries x BN bins of one tile.
// NKC > 0: the query tile (NKC chunks of K) stays in shared memory and two
// groups' wgmmas are in flight; the chunk count is a compile-time constant
// so that nothing but wgmmas lies between a group's fence and commit.
// NKC == 0: each query chunk streams with its code chunk (P > 1024) and
// the wgmmas of one chunk complete before the next.
template <bool FAST_CVT, int NKC>
struct Consumer {
    static constexpr bool RESIDENT = NKC > 0;
    static constexpr int NST = ring_stages(NKC, RESIDENT);
    uint8_t* q_res;
    uint8_t* stages;
    const float* aux_s;
    uint64_t* code_full;
    uint64_t* code_empty;
    uint64_t* aux_full;
    uint64_t* aux_empty;
    int nkc, g_begin, wg, lane;
    float w[2], y[2][NY];
    int32_t best[2][BN / 4][TOPM];   // [row i][column 2j + c][plane]

    __device__ __forceinline__ void release_stage(int lin)
    {
        mbar_arrive_if(&code_empty[lin % NST], lane == 0);
    }

    // Waits for group g's chunks and starts its wgmmas into d.
    __device__ __forceinline__ void start(int g, int32_t (&d)[ACC])
    {
        const int it = g - g_begin;
        if (RESIDENT) {
#pragma unroll
            for (int c = 0; c < NKC; ++c) {
                const int lin = it * NKC + c;
                mbar_wait(&code_full[lin % NST], (lin / NST) & 1);
            }
            fence_regs(d);
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < NKC; ++c) {
                const uint32_t a0 = smem_u32(q_res + c * Q_CHUNK +
                                             wg * WG_ROWS * KC);
                const uint32_t b0 = smem_u32(stages +
                                             ((it * NKC + c) % NST) * C_CHUNK);
#pragma unroll
                for (int k = 0; k < KC / KSTEP; ++k)
                    wgmma_s8(d, sw128_desc(a0 + k * KSTEP),
                             sw128_desc(b0 + k * KSTEP), c > 0 || k > 0);
            }
            wgmma_commit();
        } else {
#pragma unroll 1
            for (int c = 0; c < nkc; ++c) {
                const int lin = it * nkc + c;
                mbar_wait(&code_full[lin % NST], (lin / NST) & 1);
                const uint8_t* st = stages + (lin % NST) * (Q_CHUNK + C_CHUNK);
                const uint32_t a0 = smem_u32(st + wg * WG_ROWS * KC);
                const uint32_t b0 = smem_u32(st + Q_CHUNK);
                fence_regs(d);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < KC / KSTEP; ++k)
                    wgmma_s8(d, sw128_desc(a0 + k * KSTEP),
                             sw128_desc(b0 + k * KSTEP), c > 0 || k > 0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(d);
                release_stage(lin);
            }
        }
    }

    __device__ __forceinline__ void epilogue(int32_t (&d)[ACC], int g)
    {
        const int it = g - g_begin;
        const int slot = it % AUX_SLOTS;
        mbar_wait(&aux_full[slot], (it / AUX_SLOTS) & 1);
        const float* ax = aux_s + slot * NAUX * BN;
        const int cb = 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            float2 x[NAUX];
#pragma unroll
            for (int a = 0; a < NAUX; ++a)
                x[a] = *reinterpret_cast<const float2*>(ax + a * BN + 8 * j +
                                                        cb);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int32_t f = d[4 * j + 2 * i + c];
                    // exact for |f| <= 2^22: 1.5 * 2^23 + f in the mantissa
                    const float fs = FAST_CVT
                        ? __fsub_rn(__int_as_float(f + 0x4B400000),
                                    12582912.0f)
                        : __int2float_rn(f);
                    float s = __fmaf_rn(
                        __fmul_rn(w[i], c ? x[5].y : x[5].x), fs,
                        __fmul_rn(y[i][0], c ? x[0].y : x[0].x));
#pragma unroll
                    for (int a = 1; a < NY; ++a)
                        s = __fmaf_rn(y[i][a], c ? x[a].y : x[a].x, s);
                    // the signed-monotone key with the group in the low
                    // bits: (key & NOT_GROUP) ^ ((sign & I32_MAX) | g)
                    const int32_t key = __float_as_int(s);
                    const int32_t flip = ((key >> 31) & I32_MAX & NOT_GROUP)
                                         | g;
                    insert4(best[i][2 * j + c], (key & NOT_GROUP) ^ flip);
                }
            }
        }
        mbar_arrive_if(&aux_empty[slot], lane == 0);
    }

    // Waits for the wgmmas in flight; releases group g's code stages.
    __device__ __forceinline__ void finish(int g, int32_t (&d)[ACC])
    {
        if (RESIDENT) {
            wgmma_wait<0>();
#pragma unroll
            for (int c = 0; c < NKC; ++c)
                release_stage((g - g_begin) * NKC + c);
        }
        fence_regs(d);
    }

    // Group g+1's wgmmas run while group g's epilogue does.  Nothing is in
    // flight across a branch or the loop's back edge, so the compiler has
    // no reason to serialize the wgmmas.
    __device__ __forceinline__ void run(int g_end, int32_t (&a)[ACC],
                                        int32_t (&b)[ACC])
    {
        start(g_begin, a);
        finish(g_begin, a);
        int g = g_begin;
#pragma unroll 1
        for (; g + 2 < g_end; g += 2) {
            start(g + 1, b);
            epilogue(a, g);
            finish(g + 1, b);
            start(g + 2, a);
            epilogue(b, g + 1);
            finish(g + 2, a);
        }
        if (g + 1 < g_end) {
            start(g + 1, b);
            epilogue(a, g);
            finish(g + 1, b);
            epilogue(b, g + 1);
        } else {
            epilogue(a, g);
        }
    }
};

template <bool FAST_CVT, int NKC>
__global__ void __launch_bounds__(THREADS, 1)
scan_keys_kernel(const __grid_constant__ CUtensorMap tm_codes,  // (rows, p)
                 const __grid_constant__ CUtensorMap tm_aux,    // (6, rows)
                 const __grid_constant__ CUtensorMap tm_q,      // (q_rows, p)
                 const float* __restrict__ w_fs,     // (q_rows,)
                 const float* __restrict__ y_aux,    // (q_rows, 5)
                 int32_t* __restrict__ out,          // (splits, q_rows, 4*bins)
                 int nkc, int bins, int groups)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    constexpr bool RESIDENT = NKC > 0;
    const Layout lay = make_layout(nkc, RESIDENT);
    uint8_t* stages = smem + lay.stage_off;
    float* aux_s = reinterpret_cast<float*>(smem + lay.aux_off);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
    uint64_t* code_full = q_full + 1;
    uint64_t* code_empty = code_full + lay.nst;
    uint64_t* aux_full = code_empty + lay.nst;
    uint64_t* aux_empty = aux_full + AUX_SLOTS;

    const int q0 = blockIdx.x * BQ;
    const int b0 = blockIdx.y * BN;
    const int split = blockIdx.z;
    const int splits = gridDim.z;
    const int g_begin = static_cast<int>((int64_t)split * groups / splits);
    const int g_end = static_cast<int>((int64_t)(split + 1) * groups / splits);

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < lay.nst; ++s) {
            mbar_init(&code_full[s], 1);
            mbar_init(&code_empty[s], CONSUMERS * 4);
        }
        for (int s = 0; s < AUX_SLOTS; ++s) {
            mbar_init(&aux_full[s], 1);
            mbar_init(&aux_empty[s], CONSUMERS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // the warpgroup index, broadcast so the compiler knows it is uniform
    const int role = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    if (role == CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        // producer: one thread keeps the rings full
        if (threadIdx.x != CONSUMERS * 128) return;
        if (RESIDENT) {
            mbar_expect_tx(q_full, nkc * Q_CHUNK);
            for (int c = 0; c < nkc; ++c)
                tma_load(smem + c * Q_CHUNK, &tm_q, q_full, c * KC, q0);
        }
        for (int g = g_begin; g < g_end; ++g) {
            const int it = g - g_begin;
            const int slot = it % AUX_SLOTS;
            if (it >= AUX_SLOTS)
                mbar_wait(&aux_empty[slot], (it / AUX_SLOTS - 1) & 1);
            mbar_expect_tx(&aux_full[slot], AUX_BYTES);
            tma_load(aux_s + slot * NAUX * BN, &tm_aux, &aux_full[slot],
                     g * bins + b0, 0);
              for (int c = 0; c < nkc; ++c) {
                const int lin = it * nkc + c;
                const int s = lin % lay.nst;
                if (lin >= lay.nst)
                    mbar_wait(&code_empty[s], (lin / lay.nst - 1) & 1);
                mbar_expect_tx(&code_full[s], lay.stage_bytes);
                uint8_t* st = stages + s * lay.stage_bytes;
                if (!RESIDENT) {
                    tma_load(st, &tm_q, &code_full[s], c * KC, q0);
                    st += Q_CHUNK;
                }
                tma_load(st, &tm_codes, &code_full[s], c * KC, g * bins + b0);
            }
        }
        return;
    }

    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    Consumer<FAST_CVT, NKC> cs;
    cs.q_res = smem;
    cs.stages = stages;
    cs.aux_s = aux_s;
    cs.code_full = code_full;
    cs.code_empty = code_empty;
    cs.aux_full = aux_full;
    cs.aux_empty = aux_empty;
    cs.nkc = nkc;
    cs.g_begin = g_begin;
    cs.wg = role;
    cs.lane = threadIdx.x & 31;
    // accumulator rows of this thread: r and r + 8 of the warpgroup's 64
    const int row = q0 + cs.wg * WG_ROWS + ((threadIdx.x & 127) >> 5) * 16 +
                    (cs.lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        cs.w[i] = w_fs[row + 8 * i];
#pragma unroll
        for (int a = 0; a < NY; ++a)
            cs.y[i][a] = y_aux[(size_t)(row + 8 * i) * NY + a];
#pragma unroll
        for (int j = 0; j < BN / 4; ++j)
#pragma unroll
            for (int t = 0; t < TOPM; ++t) cs.best[i][j][t] = I32_MAX;
    }

    int32_t acc0[ACC], acc1[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = acc1[i] = 0;
    if (RESIDENT) mbar_wait(q_full, 0);
    cs.run(g_end, acc0, acc1);

    const size_t q_rows = (size_t)gridDim.x * BQ;
    const int cb = 2 * (cs.lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int32_t* o = out + ((size_t)split * q_rows + row + 8 * i) * TOPM * bins
                     + b0 + cb;
#pragma unroll
        for (int t = 0; t < TOPM; ++t)
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
                *reinterpret_cast<int2*>(o + (size_t)t * bins + 8 * j) =
                    make_int2(cs.best[i][2 * j][t], cs.best[i][2 * j + 1][t]);
    }
}

// out[q, t*bins + b] := the 4 smallest of the splits' partial planes.
__global__ void merge_kernel(const int32_t* __restrict__ part,
                             int32_t* __restrict__ out, int splits,
                             int q_rows, int bins)
{
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (size_t)q_rows * bins) return;
    const size_t q = idx / bins, b = idx % bins;
    int32_t best[TOPM] = {I32_MAX, I32_MAX, I32_MAX, I32_MAX};
    for (int z = 0; z < splits; ++z) {
        const int32_t* p = part + ((size_t)z * q_rows + q) * TOPM * bins + b;
#pragma unroll
        for (int t = 0; t < TOPM; ++t) insert4(best, p[(size_t)t * bins]);
    }
#pragma unroll
    for (int t = 0; t < TOPM; ++t) out[q * TOPM * bins + t * bins + b] = best[t];
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so no -lcuda is needed.
EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
        if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 2D row-major map: `rows` rows of `cols` elements, boxes of
// box_rows x box_cols.  Returns the CUresult.
int encode_2d(EncodeTiled fn, CUtensorMap* map, const void* base,
              CUtensorMapDataType type, int elem_bytes, uint64_t rows,
              uint64_t cols, uint32_t box_rows, uint32_t box_cols,
              CUtensorMapSwizzle swizzle)
{
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * elem_bytes};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return static_cast<int>(fn(
        map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <bool FAST_CVT, int NKC>
int launch(const CUtensorMap& tc, const CUtensorMap& ta, const CUtensorMap& tq,
           const float* w_fs, const float* y_aux, int32_t* out, int q_rows,
           int nkc, int bins, int groups, int splits, cudaStream_t stream)
{
    // Set on every launch (microseconds): the opt-in to more than 48 KB
    // holds for the current device only, and one process may launch the
    // same instance on several cards.
    const int smem = make_layout(nkc, NKC > 0).bytes + 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        scan_keys_kernel<FAST_CVT, NKC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(q_rows / BQ, bins / BN, splits);
    scan_keys_kernel<FAST_CVT, NKC><<<grid, THREADS, smem, stream>>>(
        tc, ta, tq, w_fs, y_aux, out, nkc, bins, groups);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block for a K width of p bytes.
extern "C" int scan_keys_smem_bytes(int p)
{
    const int nkc = (p + KC - 1) / KC;
    return static_cast<int>(make_layout(nkc, nkc <= QRES_CHUNKS).bytes) +
           1024;
}

// Launches on `stream`: q_rows % 128 == 0, bins % 32 == 0, p % 16 == 0,
// 16-byte aligned operands, splits <= groups, and `partial` holding
// (splits, q_rows, 4*bins) int32 when splits > 1 are the caller's contract
// (the Python wrapper pads and checks).  Returns 0, a CUDA error from the
// launches, 1000 + the CUresult of a failed tensor-map encode, or 2000
// when the driver's cuTensorMapEncodeTiled cannot be found.
extern "C" int scan_keys_launch(const void* codes, const void* aux,
                                const void* q, const void* w_fs,
                                const void* y_aux, void* out, void* partial,
                                int q_rows, int p, int bins, int groups,
                                int splits, void* stream)
{
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return 2000;
    const uint64_t rows = (uint64_t)groups * bins;
    CUtensorMap tc, ta, tq;
    int res = encode_2d(fn, &tc, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                        rows, p, BN, KC, CU_TENSOR_MAP_SWIZZLE_128B);
    if (res == 0)
        res = encode_2d(fn, &ta, aux, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        NAUX, rows, NAUX, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (res == 0)
        res = encode_2d(fn, &tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q_rows,
                        p, BQ, KC, CU_TENSOR_MAP_SWIZZLE_128B);
    if (res != 0) return 1000 + res;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int nkc = (p + KC - 1) / KC;
    int32_t* dst = static_cast<int32_t*>(splits > 1 ? partial : out);
    const float* w = static_cast<const float*>(w_fs);
    const float* y = static_cast<const float*>(y_aux);
    int err;
#define SCAN_KEYS_LAUNCH(FAST, N)                                          \
    err = launch<FAST, N>(tc, ta, tq, w, y, dst, q_rows, nkc, bins, groups, \
                          splits, st)
    switch (nkc) {
    case 1: SCAN_KEYS_LAUNCH(true, 1); break;
    case 2: SCAN_KEYS_LAUNCH(true, 2); break;   // p <= 256
    case 3: SCAN_KEYS_LAUNCH(false, 3); break;
    case 4: SCAN_KEYS_LAUNCH(false, 4); break;
    case 5: SCAN_KEYS_LAUNCH(false, 5); break;
    case 6: SCAN_KEYS_LAUNCH(false, 6); break;
    case 7: SCAN_KEYS_LAUNCH(false, 7); break;
    case 8: SCAN_KEYS_LAUNCH(false, 8); break;
    default: SCAN_KEYS_LAUNCH(false, 0); break;
    }
#undef SCAN_KEYS_LAUNCH
    if (err != 0 || splits == 1) return err;
    const size_t n = (size_t)q_rows * bins;
    merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        static_cast<const int32_t*>(partial), static_cast<int32_t*>(out),
        splits, q_rows, bins);
    return static_cast<int>(cudaGetLastError());
}
