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
// c = 12: integer multiplies, ~4 ms at peak.  Its bytes (the 64 B row plus
// a 4 B index per entry) are ~0.5 ms.  The design keeps the accumulator in
// registers for the whole segment; the gathers are random 64 B rows.
//
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
// One thread: about 250 doublings in sequence, bound by latency.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "ec.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 128;

__global__ void bucket_sweep_kernel(const uint32_t* __restrict__ table,
                                    const int32_t* __restrict__ idx,
                                    const int64_t* __restrict__ seg_start,
                                    const int64_t* __restrict__ seg_len,
                                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                    uint32_t* __restrict__ oz, int64_t m, FieldParams f) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= m) return;
    const int64_t start = seg_start[t];
    const int64_t len = seg_len[t];
    Jac acc = jac_infinity();
    for (int64_t i = 0; i < len; i++) {
        const int64_t row = idx[start + i];
        // row `row` of the [n, 16] table: x is element 2*row, y 2*row + 1
        const Fe x = load_fe(table, 2 * row);
        const Fe y = load_fe(table, 2 * row + 1);
        acc = jac_add_mixed(acc, x, y, f);
    }
    store_jac(ox, oy, oz, t, acc);
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

__global__ void combine_kernel(const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
                               const uint32_t* __restrict__ wz, int num_windows, int c,
                               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, FieldParams f) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    Jac acc = load_jac(wx, wy, wz, num_windows - 1);
    for (int w = num_windows - 2; w >= 0; w--) {
        for (int k = 0; k < c; k++) acc = jac_double(acc, f);
        acc = jac_add(acc, load_jac(wx, wy, wz, w), f);
    }
    store_jac(ox, oy, oz, 0, acc);
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

extern "C" int plonkit_bucket_sweep(const void* table, const void* idx, const void* seg_start,
                                    const void* seg_len, void* ox, void* oy, void* oz,
                                    long long m, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || m < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaGetLastError();
    const long long blocks = (m + kThreads - 1) / kThreads;
    bucket_sweep_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)idx, (const int64_t*)seg_start,
        (const int64_t*)seg_len, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int64_t)m, f);
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

extern "C" int plonkit_combine(const void* wx, const void* wy, const void* wz, int num_windows,
                               int c, void* ox, void* oy, void* oz, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || num_windows < 1 || c < 1) return (int)cudaErrorInvalidValue;
    combine_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)wx, (const uint32_t*)wy, (const uint32_t*)wz, num_windows, c,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, f);
    return (int)cudaGetLastError();
}
