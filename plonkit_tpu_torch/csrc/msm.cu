// MSM kernels over BN254 G1 (Fq, Jacobian, ec.cuh): K6 bucket_sweep,
// K7 padd, K7r segment_fold, K7w window_sums, K8 combine.  gpu/msm.py
// drives them; gpu/msm_kernels.py holds the wrappers and their plain
// PyTorch versions.
//
// K6 bucket_sweep replaces plonkit_tpu/tpu/msm_pallas.py `sweep_flat`
// (_sweep_flat_body): there one vector lane owns one bucket and walks a
// padded run of u16-packed 64 B rows with unchecked mixed adds, flagging
// degenerate adds and overflowing runs for a host fallback.  Here one
// thread owns one *segment*: at most S consecutive entries of the MSM's
// sorted (window, digit, index) array that lie in one bucket.  The thread
// gathers each entry's 64 B affine row (x || y, Montgomery Fq) by index and
// accumulates with the complete mixed add, then writes one Jacobian segment
// sum.  Segments bound the work per thread whatever the skew (a 0/1
// selector column puts ~n points in one bucket), and the complete add makes
// P + P (which such columns do meet) exact, so there is no flag and no
// fallback.  No atomics: every sum has a fixed order, and two runs give the
// same bytes.
// What bounds it on the H100: 11 Montgomery products per entry (264 32-bit
// multiply instructions each), about 2.3e7 entries at a 2^20 MSM with
// c = 12: integer multiplies, ~3.8 ms at peak.  Its bytes (the 64 B row plus
// a 4 B index per entry) are ~0.5 ms.
// What held it at 10.4 ms (36 % of that bound) before this design, read
// from the code and the compiled SASS (ncu does not run on the card's
// machine): (1) the product, a uint64 CIOS loop that compiled to 496
// instructions, most of them carry handling around the multiplies; (2) two
// dependent global loads per entry (the index, then the row it names) with
// nothing loaded ahead; (3) index loads strided by a segment across the
// warp, 32 sectors for 128 bytes; (4) 130 registers a thread.  What this
// design does: (1) field.cuh's even/odd carry-chain product, 232
// instructions, most of them fused IMAD.WIDE.U32.X; (2) a ring of two rows a
// thread in shared memory, filled by cp.async, so entry i + 1's row is in
// flight while entry i is added; (3) a warp first stages the 32 * SEGMENT
// indices from its first segment's start, which hold all of its 32
// segments, in shared memory with coalesced 16-byte loads; (4) __launch_bounds__ for 4 blocks
// of 128 threads an SM (at most 128 registers; no spills).  Measured: 4.6
// ms at the 2^20 main-path shape, 82 % of the bound (H100 80GB HBM3 at
// 700 W, chip_smoke.py; registers in PERF.md).  The accumulator stays in
// registers for the whole segment.

// K7 padd replaces msm_pallas.py `padd` (_padd_body): an elementwise
// complete Jacobian + Jacobian add, one thread per lane.  On the MSM path it
// joins the two halves K7w leaves per window (below); the TPU drives it
// through every round of the fold and of the weighted reduction, which K7r
// and K7w replace here.
//
// K7r segment_fold replaces the fold rounds over `padd` (msm_pallas.py
// `fold_round`, driven by tpu/msm.py's bucket fold): there each round adds
// lane c + shift into lane c under a mask, so a bucket of s segment sums
// takes log2(s) rounds over every lane, most of them copies.  Here a bucket's
// partial sums are consecutive (the segment table is sorted by bucket) and a
// level cuts each bucket's run into groups of at most G; one thread walks its
// group in order with the complete add from infinity and writes one partial
// sum.  gpu/msm.py fixes the level count from n, ceil(log_G(ceil(n / 32))),
// so the host never waits to size a level; a group of length 0 exits at
// once.  The last level writes each bucket sum straight into its row of the
// [W * 2^c] bucket table.
// What bounds it on the H100: one add (16 products of 264 multiply
// instructions) per partial sum after a group's first, ~6.6e5 adds at a
// 2^20 MSM with uniform scalars: ~0.17 ms of operations against ~72 MB
// (~0.02 ms) of points.  A skewed bucket (a 0/1 column puts ~n / 2 entries
// in one) is a chain of G dependent adds per level instead of one thread
// walking 2^15 segment sums.  No atomics: the order of adds is fixed.
//
// K7w window_sums replaces tpu/msm.py `_reduce_weighted` over `padd` (a
// suffix scan and a tree in log2(2^c) rounds each): sum_k k * S_k per
// window, by chunk walks.  A thread owns L consecutive items of one window
// and walks them from the top with a running sum R and an accumulator A
// (R += T_i, A += R for i = L-1 .. 1, then R += T_0), so A is the in-chunk
// weighted sum sum_i i * T_i and L * R (log2 L doublings) the chunk total
// scaled by its weight step.  Then sum_k k * T_k = sum_j A_j + sum_j j *
// (L * R_j): the second term is the same problem on a window's chunk totals,
// which the next launch takes (4096 -> 256 -> 16 -> 1 at c = 12, L = 16),
// and the first is a plain sum that a second thread per chunk of the next
// level carries (Q = sum_i (A_i + Q_i) over its chunk), apart from the
// weighted chain so that neither chain grows.  After the last level the
// window total is A + Q: one K7 padd over the W windows.
// What bounds it on the H100: ~2 adds a bucket, ~1.9e5 adds at c = 12
// (~0.05 ms of operations), but a thread is a chain of 2L - 1 dependent
// adds and log2 L doublings, and the upper levels have few threads, so it
// is bound by latency; L = 16 keeps three levels at c = 12.
//
// K8 combine replaces msm_pallas.py `combine` (_combine_body): the window
// totals sum_w 2^(c w) P_w, by Horner from the top window as
// tpu/msm.py:_combine_body (c doublings and one complete add per window).
// One launch takes a queued group of MSMs (gpu/msm.py msm_vec_end_many), a
// thread each: about 250 doublings in sequence, bound by latency, so the
// group costs what one MSM does.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "ec.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 128;

// K6 launch shape: 4 warps a block, and __launch_bounds__ asks for 4
// blocks an SM (at most 128 registers a thread)
constexpr int kSweepThreads = 128;
constexpr int kSweepBlocksPerSM = 4;
constexpr int kSegment = 32;                          // gpu/msm.py SEGMENT
constexpr int kWarpEntries = 32 * kSegment;           // a warp's segments hold at most this
constexpr int kStage = kWarpEntries + 8;              // its idx range, widened to whole quads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__global__ void __launch_bounds__(kSweepThreads, kSweepBlocksPerSM)
bucket_sweep_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                    const int64_t* __restrict__ seg_start, const int64_t* __restrict__ seg_len,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz, int64_t m, int64_t e, FieldParams f) {
    // a warp's indices, and a ring of two 64 B rows a thread laid out
    // [slot][16 B quad][thread], so a warp's 16 B reads hit distinct banks
    __shared__ __align__(16) int32_t s_idx[kSweepThreads / 32][kStage];
    __shared__ uint4 ring[2][4][kSweepThreads];
    const int lane = threadIdx.x & 31;
    const int64_t t = (int64_t)blockIdx.x * kSweepThreads + threadIdx.x;
    const int64_t start = t < m ? seg_start[t] : e;
    const int64_t len = t < m ? seg_len[t] : 0;

    // The segments of 32 consecutive threads are consecutive runs of idx
    // of at most SEGMENT entries, the empty ones last (gpu/msm.py:
    // _segments), so they lie in the window [lo, lo + 32 * SEGMENT) that
    // starts at lane 0's segment: stage it in shared memory with coalesced
    // 16 B loads.  A table whose segment leaves its warp's window breaks
    // the wrapper's contract and stops the kernel.
    const int64_t lo = __shfl_sync(0xffffffffu, start, 0);
    const int64_t hi = lo + kWarpEntries < e ? lo + kWarpEntries : e;
    if (len > 0 && (start < lo || start + len > hi)) __trap();
    int32_t* s = s_idx[threadIdx.x >> 5];
    const int64_t a0 = lo & ~(int64_t)3;
    for (int64_t q = a0 + 4 * lane; q < hi; q += 128) {
        int4 v;
        if (q >= lo && q + 4 <= hi) {
            v = __ldg(reinterpret_cast<const int4*>(idx + q));
        } else {
            v.x = q >= lo && q < hi ? __ldg(idx + q) : 0;
            v.y = q + 1 >= lo && q + 1 < hi ? __ldg(idx + q + 1) : 0;
            v.z = q + 2 >= lo && q + 2 < hi ? __ldg(idx + q + 2) : 0;
            v.w = q + 3 >= lo && q + 3 < hi ? __ldg(idx + q + 3) : 0;
        }
        *reinterpret_cast<int4*>(s + (q - a0)) = v;
    }
    __syncwarp();

    // Entry i + 1's row is in flight (cp.async into the ring) while entry
    // i is added; each thread reads back only what it copied itself.
    const uint4* rows = reinterpret_cast<const uint4*>(table);
    auto fetch = [&](int64_t k, int slot) {
        const int64_t row = s[k - a0];
#pragma unroll
        for (int q = 0; q < 4; q++) cp_async16(&ring[slot][q][threadIdx.x], rows + 4 * row + q);
    };
    Jac acc = jac_infinity();
    if (len > 0) fetch(start, 0);
    cp_async_commit();
    for (int64_t i = 0; i < len; i++) {
        const int slot = (int)(i & 1);
        if (i + 1 < len) fetch(start + i + 1, slot ^ 1);
        cp_async_commit();
        cp_async_wait_all_but_one();
        const uint4 x0 = ring[slot][0][threadIdx.x], x1 = ring[slot][1][threadIdx.x];
        const uint4 y0 = ring[slot][2][threadIdx.x], y1 = ring[slot][3][threadIdx.x];
        Fe x, y;
        x.v[0] = x0.x; x.v[1] = x0.y; x.v[2] = x0.z; x.v[3] = x0.w;
        x.v[4] = x1.x; x.v[5] = x1.y; x.v[6] = x1.z; x.v[7] = x1.w;
        y.v[0] = y0.x; y.v[1] = y0.y; y.v[2] = y0.z; y.v[3] = y0.w;
        y.v[4] = y1.x; y.v[5] = y1.y; y.v[6] = y1.z; y.v[7] = y1.w;
        acc = jac_add_mixed(acc, x, y, f);
    }
    if (t < m) store_jac(ox, oy, oz, t, acc);
}

__global__ void padd_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                            const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                            const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                            uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                            uint32_t* __restrict__ oz, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_jac(ox, oy, oz, i, jac_add(load_jac(px, py, pz, i), load_jac(qx, qy, qz, i), f));
}

__global__ void segment_fold_kernel(const uint32_t* __restrict__ px,
                                    const uint32_t* __restrict__ py,
                                    const uint32_t* __restrict__ pz,
                                    const int64_t* __restrict__ start,
                                    const int64_t* __restrict__ len,
                                    const int64_t* __restrict__ dst,
                                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                    uint32_t* __restrict__ oz, int64_t m, FieldParams f) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= m) return;
    int64_t row = t;
    if (dst != nullptr) {
        row = dst[t];
        if (row < 0) return;            // an empty group of the last level
    }
    const int64_t s = start[t];
    const int64_t l = len[t];
    Jac acc = jac_infinity();
    for (int64_t i = 0; i < l; i++) acc = jac_add(acc, load_jac(px, py, pz, s + i), f);
    store_jac(ox, oy, oz, row, acc);
}

// threads [0, chunks) walk the weighted chain, threads [chunks, 2 chunks)
// (only when oq is given) the plain sum of p1 + p2
__global__ void window_sums_kernel(
        const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
        const uint32_t* __restrict__ tz, const uint32_t* __restrict__ p1x,
        const uint32_t* __restrict__ p1y, const uint32_t* __restrict__ p1z,
        const uint32_t* __restrict__ p2x, const uint32_t* __restrict__ p2y,
        const uint32_t* __restrict__ p2z, uint32_t* __restrict__ otx,
        uint32_t* __restrict__ oty, uint32_t* __restrict__ otz, uint32_t* __restrict__ oax,
        uint32_t* __restrict__ oay, uint32_t* __restrict__ oaz, uint32_t* __restrict__ oqx,
        uint32_t* __restrict__ oqy, uint32_t* __restrict__ oqz, int64_t chunks, int64_t k_in,
        int chunk, int log_chunk, FieldParams f) {
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (oqx != nullptr ? 2 * chunks : chunks)) return;
    const bool plain = g >= chunks;
    const int64_t c = plain ? g - chunks : g;
    const int64_t k_out = (k_in + chunk - 1) / chunk;
    const int64_t j = c % k_out;
    const int64_t base = (c / k_out) * k_in + j * chunk;
    const int64_t rest = k_in - j * chunk;
    const int64_t cnt = rest < chunk ? rest : chunk;
    if (plain) {
        Jac q = jac_infinity();
        for (int64_t i = 0; i < cnt; i++) {
            if (p1x != nullptr) q = jac_add(q, load_jac(p1x, p1y, p1z, base + i), f);
            if (p2x != nullptr) q = jac_add(q, load_jac(p2x, p2y, p2z, base + i), f);
        }
        store_jac(oqx, oqy, oqz, c, q);
        return;
    }
    Jac r = jac_infinity();
    Jac a = jac_infinity();
    for (int64_t i = cnt - 1; i >= 1; i--) {
        r = jac_add(r, load_jac(tx, ty, tz, base + i), f);
        a = jac_add(a, r, f);
    }
    r = jac_add(r, load_jac(tx, ty, tz, base), f);
    for (int k = 0; k < log_chunk; k++) r = jac_double(r, f);
    store_jac(otx, oty, otz, c, r);
    store_jac(oax, oay, oaz, c, a);
}

// thread b combines the num_windows rows of MSM b
__global__ void combine_kernel(const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
                               const uint32_t* __restrict__ wz, int batch, int num_windows,
                               int c, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, FieldParams f) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const int64_t base = (int64_t)b * num_windows;
    Jac acc = load_jac(wx, wy, wz, base + num_windows - 1);
    for (int w = num_windows - 2; w >= 0; w--) {
        for (int k = 0; k < c; k++) acc = jac_double(acc, f);
        acc = jac_add(acc, load_jac(wx, wy, wz, base + w), f);
    }
    store_jac(ox, oy, oz, b, acc);
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

extern "C" int plonkit_bucket_sweep(const void* table, const void* idx, const void* seg_start,
                                    const void* seg_len, void* ox, void* oy, void* oz,
                                    long long m, long long e, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || m < 0 || e < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaGetLastError();
    const long long blocks = (m + kSweepThreads - 1) / kSweepThreads;
    bucket_sweep_kernel<<<(unsigned)blocks, kSweepThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)idx, (const int64_t*)seg_start,
        (const int64_t*)seg_len, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int64_t)m,
        (int64_t)e, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_padd(const void* px, const void* py, const void* pz, const void* qx,
                            const void* qy, const void* qz, void* ox, void* oy, void* oz,
                            long long n, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    padd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
        (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
        (int64_t)n, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_segment_fold(const void* px, const void* py, const void* pz,
                                    const void* start, const void* len, const void* dst, void* ox,
                                    void* oy, void* oz, long long m, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || m < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaGetLastError();
    const long long blocks = (m + kThreads - 1) / kThreads;
    segment_fold_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const int64_t*)start,
        (const int64_t*)len, (const int64_t*)dst, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
        (int64_t)m, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_window_sums(const void* tx, const void* ty, const void* tz,
                                   const void* p1x, const void* p1y, const void* p1z,
                                   const void* p2x, const void* p2y, const void* p2z, void* otx,
                                   void* oty, void* otz, void* oax, void* oay, void* oaz,
                                   void* oqx, void* oqy, void* oqz, long long chunks,
                                   long long k_in, int chunk, int log_chunk, void* stream) {
    FieldParams f;
    const bool plain = p1x != nullptr || p2x != nullptr;
    if (!fq_params(&f) || chunks < 1 || k_in < 1 || log_chunk < 1 || log_chunk > 16 ||
        chunk != (1 << log_chunk) || chunks % ((k_in + chunk - 1) / chunk) != 0 ||
        plain != (oqx != nullptr))
        return (int)cudaErrorInvalidValue;
    const long long threads = plain ? 2 * chunks : chunks;
    const long long blocks = (threads + kThreads - 1) / kThreads;
    window_sums_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz, (const uint32_t*)p1x,
        (const uint32_t*)p1y, (const uint32_t*)p1z, (const uint32_t*)p2x, (const uint32_t*)p2y,
        (const uint32_t*)p2z, (uint32_t*)otx, (uint32_t*)oty, (uint32_t*)otz, (uint32_t*)oax,
        (uint32_t*)oay, (uint32_t*)oaz, (uint32_t*)oqx, (uint32_t*)oqy, (uint32_t*)oqz,
        (int64_t)chunks, (int64_t)k_in, chunk, log_chunk, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_combine(const void* wx, const void* wy, const void* wz, int batch,
                               int num_windows, int c, void* ox, void* oy, void* oz,
                               void* stream) {
    FieldParams f;
    if (!fq_params(&f) || batch < 1 || num_windows < 1 || c < 1)
        return (int)cudaErrorInvalidValue;
    constexpr int kCombineThreads = 32;
    combine_kernel<<<(batch + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
                     (cudaStream_t)stream>>>(
        (const uint32_t*)wx, (const uint32_t*)wy, (const uint32_t*)wz, batch, num_windows, c,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, f);
    return (int)cudaGetLastError();
}
