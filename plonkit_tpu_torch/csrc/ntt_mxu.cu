// The tensor-core NTT's three kernels over BN254 Fr (gpu/ntt_mxu.py):
//   K9  balanced_digits: [r, B] rows -> [B, Kp] int8, 33 balanced digits each
//   K10 dft_product:     G = A . X^T, int8 x int8 -> int32 on wgmma, fed by TMA
//   K11 fold_redc:       [r, 33, B] int32 digits -> [r, B] canonical rows
//
// They replace the XLA parts of plonkit_tpu/tpu/ntt_mxu.py, the JAX
// package's NTT engine on its chip: `_to_balanced` (K9), the int8
// `dot_general` of `_dft_base` (K10) and `_fold_redc` (K11).  That file has
// no pallas_call; its twiddle and coset products are K1 (field.cu).
//
// K9.  What bounds it: bytes, 32 in and Kp / r (33 and the padding) out an
// element; no multiplies.  At the r = 128 level of a 2^20 transform that is
// 68.1 MB.  Output row b holds the digits of column b's r elements (k * 33
// + j), the K-major operand of K10, and is written with 16-byte stores.  A
// block takes `cols` consecutive columns (a power of two, at least 4, and
// at most 512 elements where r allows: 4 at r = 128 and 256, 8 at r = 64,
// 512 at r = 1), so a warp reads 128 contiguous bytes of each of 8 rows k,
// two elements a thread in flight.  Each thread ripples an element's 33
// digits in registers, packs them into words and writes them into a
// shared-memory image of the block's cols output rows (row stride Kp + 16)
// as 7 word stores and 8 predicated byte stores; the padding up to Kp is
// zeroed there.  Then the block copies the image out, 16 bytes a thread,
// consecutive threads on consecutive addresses (the cols rows are
// contiguous in `out`).  Budget: 40 registers; cols * (Kp + 16) bytes of
// dynamic shared memory (16.9 KB at r = 128, 33.9 KB at r = 256, 40 KB at
// r = 1).
//
// K10.  What bounds it: the tensor cores.  At the r = 128 level of a 2^20
// transform (M = K = 4224, N = 8192) it does 2.92e11 int8 operations
// against 190 MB of operands and result; at r = 256 the table A is 71 MB,
// more than the 50 MB L2.  A block computes a 128 x 256 tile of G with
// three warpgroups: one producer warp issues TMA loads of A and X boxes
// 128 bytes deep (128 x 128 and 256 x 128, CU_TENSOR_MAP_SWIZZLE_128B)
// into a ring of 4 stages of 48 KB with full and empty mbarriers; two
// consumer warpgroups each run wgmma.mma_async m64n256k32.s32.s8.s8 on 64
// rows of A and all 256 rows of X, both K-major in shared memory (the
// layout K9 writes and the table has: no transpose), 4 k-steps a stage,
// one wgmma group kept in flight while the next stage is awaited; the
// first k-step overwrites the accumulators, so no other instruction
// defines them and ptxas keeps the wgmmas asynchronous.  TMA
// fills boxes past the edges of M, N and K with zeros, so ragged tiles need
// no branch in the main loop.  Tiles are walked in groups of 16 m-tiles
// (2048 rows of A against ~8 n-tiles a wave of 132 blocks), so a wave's
// boxes stay in L2 when A does not.  Epilogue: the accumulators go through
// the drained ring (row stride 264 words: no bank conflict) and out as
// 16-byte stores of whole G rows, masked at the edges (N % 4 != 0, e.g.
// N = 1, takes masked word stores).  Budget: 384 threads, setmaxnreg 40
// for the producer and 232 for the consumers (128 accumulators each);
// 196,608 bytes of dynamic shared memory plus 1 KB to align the ring to
// the 1024-byte swizzle atom, one block an SM.  The tensor maps are encoded
// on the host for each call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: no link against libcuda).
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

#include <cuda.h>   // CUtensorMap and its enums; no driver function is linked

#include "field.cuh"

using namespace plonkit;

namespace {

constexpr int NB = 33;          // balanced digits an element
constexpr int FOLD_BYTES = 36;  // bytes of sum_t G_t 2^(8t) + 2^31 p
constexpr int kThreads = 256;

// -- K9 ----------------------------------------------------------------------

constexpr int kDigitElems = 512;         // elements a block, at most (r <= 128)
constexpr int kDigitSmem = 48 * 1024;    // shared memory a block, at most

// the 33 digits of v into staged row c at element k (row stride ld, a
// multiple of 16): digit t = (byte t + carry) mod 256, packed 4 a word; the
// digits start at byte k % 4 of an aligned word, so words 1-7 are this
// element's alone and words 0 and 8, which may hold a neighbour's bytes,
// are written byte by byte
__device__ __forceinline__ void stage_digits(int8_t* img, int ld, int k, int c, const Fe& v) {
    uint32_t d[9] = {};
    int carry = 0;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
        const int u = (t < 32 ? (int)((v.v[t >> 2] >> (8 * (t & 3))) & 0xFFu) : 0) + carry;
        carry = u >= 128;
        d[t >> 2] |= (uint32_t)(u & 0xFF) << (8 * (t & 3));
    }
    const int s = k & 3;
    int8_t* base = img + c * ld + k * NB - s;
    uint32_t* w = reinterpret_cast<uint32_t*>(base);
    const uint32_t first = d[0] << (8 * s), last = __funnelshift_l(d[7], d[8], 8 * s);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = __funnelshift_l(d[i - 1], d[i], 8 * s);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (b >= s) base[b] = (int8_t)(first >> (8 * b));
        if (b <= s) base[32 + b] = (int8_t)(last >> (8 * b));
    }
}

// columns [b0, b0 + 2^cols_log2) of all r elements, cols >= 4, staged in
// rows of kp + 16 bytes
__global__ void __launch_bounds__(kThreads)
balanced_digits_kernel(const uint32_t* __restrict__ x, int8_t* __restrict__ out, int r,
                       int64_t batch, int kp, int cols_log2) {
    extern __shared__ __align__(16) int8_t img[];
    const int ld = kp + 16, total = r << cols_log2;
    const int64_t b0 = (int64_t)blockIdx.x << cols_log2;
    const int live = (int)min((int64_t)1 << cols_log2, batch - b0);
    // element e: column 4 (e / 4r) + e % 4, row k = (e % 4r) / 4, so a warp
    // reads 128 contiguous bytes of each of 8 rows; two loads a thread in flight
    for (int e0 = threadIdx.x; e0 < total; e0 += 2 * kThreads) {
        int k[2], c[2];
        bool ok[2];
        Fe v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int e = e0 + h * kThreads, q = e / (4 * r);
            k[h] = (e - q * 4 * r) >> 2;
            c[h] = 4 * q + (e & 3);
            ok[h] = e < total && c[h] < live;
            if (ok[h]) v[h] = load_fe(x, (int64_t)k[h] * batch + b0 + c[h]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (ok[h]) stage_digits(img, ld, k[h], c[h], v[h]);
    }
    const int pad = kp - r * NB;
    for (int e = threadIdx.x; e < live * pad; e += kThreads) {
        const int c = e / pad;
        img[c * ld + r * NB + (e - c * pad)] = 0;
    }
    __syncthreads();
    // rows b0 .. b0 + live - 1 are live * kp contiguous bytes of `out`
    const int chunks = kp / 16;
    int4* dst = reinterpret_cast<int4*>(out + b0 * kp);
    for (int q = threadIdx.x; q < live * chunks; q += kThreads) {
        const int c = q / chunks;
        dst[q] = *reinterpret_cast<const int4*>(img + c * ld + 16 * (q - c * chunks));
    }
}

// -- K10 ---------------------------------------------------------------------

constexpr int BM = 128;                  // rows of A (and G) a block
constexpr int BN = 256;                  // rows of X (columns of G) a block
constexpr int BK = 128;                  // bytes of depth a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_STAGE = BM * BK;
constexpr int STAGE_BYTES = A_STAGE + BN * BK;
constexpr int kConsumers = 2;            // warpgroups of wgmma m64n256k32
constexpr int kProductThreads = 128 * (kConsumers + 1);
constexpr int kProductSmem = STAGES * STAGE_BYTES + 1024;
constexpr int OUT_LD = BN + 8;           // staged G row, words
constexpr int GROUP_M = 16;              // m-tiles a raster group
static_assert(kConsumers * 64 * OUT_LD * 4 <= STAGES * STAGE_BYTES, "G tile exceeds the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait that never ends (a fault of the pipeline) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    for (uint32_t polls = 0;; ++polls) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
        if (done) return;
        if (polls == (1u << 26)) __trap();
    }
}

// one box of a 2-d tensor map (c0 bytes of depth, c1 rows) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row atoms 1024 bytes apart (SBO), LBO unused by this layout
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
           (1ull << 62);
}

#define ACC8(i)                                                                          \
    "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),           \
        "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D[64 x 256] = A[64 x 32] . B[256 x 32]^T (+ D if `accumulate`), s8 x s8 -> s32
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
        "%123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
          ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
        : "l"(da), "l"(db), "r"(accumulate));
}

#undef ACC8

__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kProductThreads, 1)
dft_product_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tx,
                   int32_t* __restrict__ g, int m, int n, int k) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

    // grouped raster: GROUP_M m-tiles sweep the n-tiles together
    const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
    const int group = blockIdx.x / (GROUP_M * tiles_n);
    const int first_m = group * GROUP_M, rows = min(tiles_m - first_m, GROUP_M);
    const int in_group = blockIdx.x - group * GROUP_M * tiles_n;
    const int m0 = (first_m + in_group % rows) * BM, n0 = (in_group / rows) * BN;
    const int ktiles = (k + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == kConsumers) {
        // producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == kConsumers * 128) {
            for (int kt = 0; kt < ktiles; ++kt) {
                const int s = kt % STAGES;
                if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
                mbar_expect_tx(&full[s], STAGE_BYTES);
                uint8_t* st = ring + s * STAGE_BYTES;
                tma_load(st, &ta, &full[s], kt * BK, m0);
                tma_load(st + A_STAGE, &tx, &full[s], kt * BK, n0);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        // the first k-step overwrites: only wgmma defines the accumulators,
        // so ptxas keeps the wgmmas asynchronous (no zeroing instruction)
        int acc[128];
        for (int kt = 0; kt < ktiles; ++kt) {
            const int s = kt % STAGES;
            mbar_wait(&full[s], (kt / STAGES) & 1);
            const uint8_t* st = ring + s * STAGE_BYTES;
            const uint64_t da = sw128_desc(st + wg * 64 * BK), dx = sw128_desc(st + A_STAGE);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk)   // 32 bytes a k-step: 2 units of 16
                wgmma_m64n256k32(acc, da + 2 * kk, dx + 2 * kk, kt > 0 || kk > 0);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            // the previous stage's group is done: hand its buffers back
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

        // epilogue: both warpgroups are done with the ring; each stages its
        // 64 x 256 accumulators there and stores whole rows of G
        named_barrier(1, kConsumers * 128);
        int32_t* out = reinterpret_cast<int32_t*>(ring) + wg * 64 * OUT_LD;
        const int lane = threadIdx.x % 32, row0 = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
            // accumulator i: row row0 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4)
            const int row = row0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * (lane % 4);
            *reinterpret_cast<int2*>(out + row * OUT_LD + col) = make_int2(acc[i], acc[i + 1]);
        }
        named_barrier(2 + wg, 128);
        const bool vec = n % 4 == 0;
        for (int q = threadIdx.x % 128; q < 64 * (BN / 4); q += 128) {
            const int row = q / (BN / 4), col = 4 * (q % (BN / 4));
            const int gm = m0 + wg * 64 + row, gn = n0 + col;
            if (gm >= m || gn >= n) continue;
            const int4 v = *reinterpret_cast<const int4*>(out + row * OUT_LD + col);
            int32_t* dst = g + (int64_t)gm * n + gn;
            if (vec) {
                *reinterpret_cast<int4*>(dst) = v;
            } else {
                dst[0] = v.x;
                if (gn + 1 < n) dst[1] = v.y;
                if (gn + 2 < n) dst[2] = v.z;
                if (gn + 3 < n) dst[3] = v.w;
            }
        }
    }
}

// -- K11 ---------------------------------------------------------------------

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

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
        return nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
}

// [rows, depth] int8, row-major, as boxes of `box_rows` x 128 bytes
bool tile_map(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows,
              long long depth, int box_rows) {
    const cuuint64_t dims[2] = {(cuuint64_t)depth, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)depth};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int plonkit_balanced_digits(const void* x, void* out, long long r, long long batch,
                                       long long kp, void* stream) {
    if (r < 1 || batch < 0 || kp < r * NB || kp % 32 || 4 * (kp + 16) > kDigitSmem)
        return (int)cudaErrorInvalidValue;
    if (r * batch == 0) return (int)cudaGetLastError();
    int cols_log2 = 2;
    while ((r << (cols_log2 + 1)) <= kDigitElems && (kp + 16) << (cols_log2 + 1) <= kDigitSmem)
        ++cols_log2;
    const long long blocks = (batch + (1LL << cols_log2) - 1) >> cols_log2;
    balanced_digits_kernel<<<(unsigned)blocks, kThreads, (kp + 16) << cols_log2,
                             (cudaStream_t)stream>>>((const uint32_t*)x, (int8_t*)out, (int)r,
                                                     (int64_t)batch, (int)kp, cols_log2);
    return (int)cudaGetLastError();
}

// a: [m, k] int8, x: [n, k] int8, both row-major, k a multiple of 32 (16-byte
// rows, as TMA requires); g: [m, n] int32
extern "C" int plonkit_dft_product(const void* a, const void* x, void* g, long long m,
                                   long long n, long long k, void* stream) {
    if (m < 0 || n < 0 || k < 32 || k % 32) return (int)cudaErrorInvalidValue;
    if (m == 0 || n == 0) return (int)cudaGetLastError();
    const long long tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
    if (m > 0x7FFFFFFFLL || n > 0x7FFFFFFFLL || k > 0x7FFFFFFFLL || tiles > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    static const EncodeTiled encode = encode_tiled();
    static const cudaError_t smem = cudaFuncSetAttribute(
        dft_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kProductSmem);
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    if (smem != cudaSuccess) return (int)smem;
    CUtensorMap ta, tx;
    if (!tile_map(encode, &ta, a, m, k, BM) || !tile_map(encode, &tx, x, n, k, BN))
        return (int)cudaErrorInvalidValue;
    dft_product_kernel<<<(unsigned)tiles, kProductThreads, kProductSmem, (cudaStream_t)stream>>>(
        ta, tx, (int32_t*)g, (int)m, (int)n, (int)k);
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
