// The tensor-core NTT's three kernels over BN254 Fr (gpu/ntt_mxu.py):
//   K9  balanced_digits: [r, B] rows -> [B, Kp] int8, 33 balanced digits each
//   K10 dft_product:     G = A . X^T, int8 x int8 -> int32 on mma.sync
//   K11 fold_redc:       [r, 33, B] int32 digits -> [r, B] canonical rows
//
// They replace the XLA parts of plonkit_tpu/tpu/ntt_mxu.py, the JAX
// package's NTT engine on its chip: `_to_balanced` (K9), the int8
// `dot_general` of `_dft_base` (K10) and `_fold_redc` (K11).  That file has
// no pallas_call; its twiddle and coset products are K1 (field.cu).
//
// K9.  What bounds it: 32 bytes in and 33 out an element, no multiplies.
// One thread an element: a 32-byte row in two 16-byte loads (one sector),
// 33 digits by a carry ripple in registers, written where the product
// reads them: output row b holds the digits of column b's r elements
// (k * 33 + j), so consecutive threads (k fastest) write consecutive bytes
// and K10 reads X as the "col" operand of mma.sync with no transpose.  The
// last element of a row writes the zero padding up to Kp.
//
// K10.  What bounds it: the tensor cores.  At the r = 128 level of a 2^20
// transform (M = K = 4224, N = 8192) it does 2.92e11 int8 operations
// against 190 MB of operands and result.  A block computes a 128 x 128
// tile of G: eight warps of 64 x 32, each a 4 x 4 grid of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 per 32 bytes of depth.  Tiles of
// A and X, 64 bytes deep, are staged in shared memory by cp.async, two
// stages in flight; a row is padded to 80 bytes so the fragment loads (8
// rows x 4 words a warp) hit 32 distinct banks.  Loads past the edges of
// M, N or K are zero-filled, so ragged tiles need no other branch.  wgmma,
// TMA and fusing K9 and K11 into its load and epilogue are later work.
//
// K11.  What bounds it: 132 bytes in and 32 out an element; 34 32-bit
// multiplies.  One thread an output (m, b): the 33 digits G[m*33 + t][b]
// (coalesced across b), plus the bytes of 2^31 p, rippled into 36 bytes
// (9 words) in registers; then the Montgomery REDC by 2^48 as one 32-bit
// step and one 16-bit step (the JAX package takes three 16-bit steps: both
// add the one multiple M p, M < 2^48, that clears the low 48 bits, so the
// results are equal bit for bit), and one conditional subtraction of p.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "field.cuh"

using namespace plonkit;

namespace {

constexpr int NB = 33;          // balanced digits an element
constexpr int FOLD_BYTES = 36;  // bytes of sum_t G_t 2^(8t) + 2^31 p
constexpr int kThreads = 256;

__global__ void balanced_digits_kernel(const uint32_t* __restrict__ x,
                                       int8_t* __restrict__ out, int r, int64_t batch,
                                       int kp) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;   // b * r + k
    if (i >= (int64_t)r * batch) return;
    const int64_t b = i / r;
    const int k = (int)(i - b * r);
    const Fe v = load_fe(x, (int64_t)k * batch + b);
    int8_t* dst = out + b * kp + k * NB;
    int carry = 0;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
        const int byte = t < 32 ? (int)((v.v[t >> 2] >> (8 * (t & 3))) & 0xFFu) : 0;
        const int s = byte + carry;
        carry = s >= 128;
        dst[t] = (int8_t)(s - 256 * carry);
    }
    if (k == r - 1)
        for (int c = r * NB; c < kp; ++c) out[b * kp + c] = 0;
}

constexpr int BM = 128;          // rows of A (and G) a block
constexpr int BN = 128;          // rows of X (columns of G) a block
constexpr int BK = 64;           // bytes of depth a stage
constexpr int LDS = BK + 16;     // padded row of a staged tile, bytes
constexpr int kProductThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes));
}

// one stage: rows [row0, row0 + 128) of a [rows, k] int8 matrix, bytes
// [k0, k0 + 64), as 512 chunks of 16 bytes, two a thread; zero past the edges
__device__ __forceinline__ void stage_tile(int8_t* tile, const int8_t* src, int64_t rows,
                                           int64_t k, int64_t row0, int64_t k0) {
#pragma unroll
    for (int c = threadIdx.x; c < BM * BK / 16; c += kProductThreads) {
        const int row = c >> 2, col = (c & 3) * 16;
        const bool in = row0 + row < rows && k0 + col < k;
        const int8_t* g = in ? src + (row0 + row) * k + k0 + col : src;
        cp_async16(tile + row * LDS + col, g, in ? 16 : 0);
    }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kProductThreads)
dft_product_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ x,
                   int32_t* __restrict__ g, int64_t m, int64_t n, int64_t k) {
    __shared__ __align__(16) int8_t as[2][BM * LDS];
    __shared__ __align__(16) int8_t xs[2][BN * LDS];
    const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // the warp's 64 x 32 tile
    const int grp = lane >> 2, tq = lane & 3;               // fragment row / column group

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    const int stages = (int)((k + BK - 1) / BK);
    stage_tile(as[0], a, m, k, m0, 0);
    stage_tile(xs[0], x, n, k, n0, 0);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int s = 0; s < stages; ++s) {
        if (s + 1 < stages) {
            stage_tile(as[(s + 1) & 1], a, m, k, m0, (int64_t)(s + 1) * BK);
            stage_tile(xs[(s + 1) & 1], x, n, k, n0, (int64_t)(s + 1) * BK);
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 1;\n" ::);
        __syncthreads();
        const int8_t* at = as[s & 1];
        const int8_t* xt = xs[s & 1];
#pragma unroll
        for (int ks = 0; ks < BK; ks += 32) {
            // A (16 x 32, row): a0 row grp, bytes 4tq..; a1 row grp + 8;
            // a2, a3 the same rows, bytes 16 + 4tq..
            uint32_t af[4][4], bf[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int8_t* r0 = at + (wm + i * 16 + grp) * LDS + ks + 4 * tq;
                af[i][0] = lds32(r0);
                af[i][1] = lds32(r0 + 8 * LDS);
                af[i][2] = lds32(r0 + 16);
                af[i][3] = lds32(r0 + 8 * LDS + 16);
            }
            // B (32 x 8, col): column grp, bytes 4tq.. and 16 + 4tq..
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int8_t* c0 = xt + (wn + j * 8 + grp) * LDS + ks + 4 * tq;
                bf[j][0] = lds32(c0);
                bf[j][1] = lds32(c0 + 16);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    asm volatile(
                        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                        : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
                          "+r"(acc[i][j][3])
                        : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                          "r"(bf[j][0]), "r"(bf[j][1]));
        }
        __syncthreads();
    }
    // C (16 x 8): c0, c1 at row grp, columns 2tq, 2tq + 1; c2, c3 at row grp + 8
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t row = m0 + wm + i * 16 + grp + (e >> 1) * 8;
                const int64_t col = n0 + wn + j * 8 + 2 * tq + (e & 1);
                if (row < m && col < n) g[row * n + col] = acc[i][j][e];
            }
}

__global__ void fold_redc_kernel(const int32_t* __restrict__ g, uint32_t* __restrict__ out,
                                 int r, int64_t batch, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;   // m * batch + b
    if (i >= (int64_t)r * batch) return;
    const int64_t m = i / batch, b = i - m * batch;
    const int32_t* col = g + m * NB * batch + b;
    // 2^31 p as 9 words
    uint32_t off[9];
    off[0] = f.p[0] << 31;
#pragma unroll
    for (int j = 1; j < 8; ++j) off[j] = (f.p[j] << 31) | (f.p[j - 1] >> 1);
    off[8] = f.p[7] >> 1;
    // offset add and byte carry ripple: T = sum_t G_t 2^(8t) + 2^31 p in
    // [0, 2^286), 36 bytes
    uint32_t w[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) w[j] = 0;
    int carry = 0;
#pragma unroll
    for (int t = 0; t < FOLD_BYTES; ++t) {
        const int gt = t < NB ? col[(int64_t)t * batch] : 0;
        const int u = gt + (int)((off[t >> 2] >> (8 * (t & 3))) & 0xFFu) + carry;
        const int byte = u & 255;
        carry = (u - byte) >> 8;
        w[t >> 2] |= (uint32_t)byte << (8 * (t & 3));
    }
    // REDC, 32 bits: T + m1 p < 2^287, then drop the zero low word
    const uint32_t m1 = w[0] * f.n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint64_t s = (uint64_t)m1 * f.p[j] + w[j] + c;
        w[j] = (uint32_t)s;
        c = s >> 32;
    }
    w[8] += (uint32_t)c;
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = w[j + 1];
    // REDC, 16 bits (n0 mod 2^16 = -p^-1 mod 2^16), then shift by 16
    const uint32_t m2 = (w[0] * f.n0) & 0xFFFFu;
    c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint64_t s = (uint64_t)m2 * f.p[j] + w[j] + c;
        w[j] = (uint32_t)s;
        c = s >> 32;
    }
    w[8] = (uint32_t)c;
    Fe v;
#pragma unroll
    for (int j = 0; j < 8; ++j) v.v[j] = (w[j] >> 16) | (w[j + 1] << 16);
    // (T + M p) / 2^48 < 2^238 + p < 2p
    store_fe(out, i, reduce_once(v, f));
}

}  // namespace

extern "C" int plonkit_balanced_digits(const void* x, void* out, long long r, long long batch,
                                       long long kp, void* stream) {
    if (r < 1 || batch < 0 || kp < r * NB || kp % 32 || r * NB > (1LL << 30))
        return (int)cudaErrorInvalidValue;
    const long long n = r * batch;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    balanced_digits_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (int8_t*)out, (int)r, (int64_t)batch, (int)kp);
    return (int)cudaGetLastError();
}

// a: [m, k] int8, x: [n, k] int8, both row-major, k a multiple of 32 (16-byte
// rows); g: [m, n] int32
extern "C" int plonkit_dft_product(const void* a, const void* x, void* g, long long m,
                                   long long n, long long k, void* stream) {
    if (m < 0 || n < 0 || k < 32 || k % 32) return (int)cudaErrorInvalidValue;
    if (m == 0 || n == 0) return (int)cudaGetLastError();
    const long long gy = (m + BM - 1) / BM, gx = (n + BN - 1) / BN;
    if (gy > 65535 || gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    dft_product_kernel<<<dim3((unsigned)gx, (unsigned)gy), kProductThreads, 0,
                         (cudaStream_t)stream>>>((const int8_t*)a, (const int8_t*)x,
                                                 (int32_t*)g, (int64_t)m, (int64_t)n,
                                                 (int64_t)k);
    return (int)cudaGetLastError();
}

// g: [r * 33, batch] int32; out: [r, batch] rows of 8 words (Fr)
extern "C" int plonkit_fold_redc(const void* g, void* out, long long r, long long batch,
                                 void* stream) {
    FieldParams f;
    if (!field_params(0, &f) || r < 1 || batch < 0) return (int)cudaErrorInvalidValue;
    const long long n = r * batch;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    fold_redc_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)g, (uint32_t*)out, (int)r, (int64_t)batch, f);
    return (int)cudaGetLastError();
}
