// Field scans over BN254 rows: K12 field_scan and K13 field_inverse.
//
// K12 replaces the scans the JAX package composes from its Pallas field
// kernels as Hillis-Steele rounds, log2(n) full passes of `pk.mul` or
// `pk.add` each: plonkit_tpu/backend_jax.py:145 _prefix_products_body (the
// grand product), :167 _suffix_products_body, :314 _suffix_sums_jit
// (divide_by_linear) and the two product scans of :182 _batch_inverse_body
// and tpu/pallas_kernels.py:173 batch_inverse.  K13 replaces the one-lane
// Fermat inverse of the total in those batch inverses (tpu/mont.py:298
// inverse).
//
// K12.  A single-pass chained scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016) over [N, 8] Montgomery rows.  Launch parameters: the field, the
// operator (Montgomery product or modular add), the direction (prefix or
// suffix), inclusive or exclusive (the identity is R mod p or 0), an
// optional seed that every output is combined with, and the batch-inverse
// epilogue.
// Both operators are associative and commutative and give canonical
// results, so any order of association gives the bytes of the JAX
// package's rounds.
//
// What bounds it: 32 bytes in and 32 out a row, 67 MB at 2^20, and for
// the product n - 1 Montgomery products (264 32-bit multiply instructions
// each); the sums are bound by the bytes.  A parallel product scan does at
// least two products a row (one to reduce, one to apply the prefix), here
// 2.31 (15 + 5 + 1 + 16 a thread of 16 rows), and those products, not the
// bytes, take most of its time on the H100: ptxas's Montgomery product is
// 232 instructions, ~136 of them IMAD, which issue at half rate.
//
// Design.  A block of 256 threads takes one tile of 4096 rows in scan
// order, 16 consecutive positions a thread, so that 2^20 rows are 256
// tiles and fit in one wave (two blocks an SM, by registers).  Its tile
// index comes from an atomic counter, which the entry point zeroes on the
// stream before each launch, so a tile only ever waits on tiles of blocks
// that were scheduled before it.  Each warp stages its rows through shared
// memory with cp.async, one 128-byte line a thread at a time, the next
// line in flight while the thread multiplies (see Staging below).  A
// thread reduces its 16 rows, the warp scans the thread totals by
// __shfl_up_sync, warp 0 scans the warp totals and publishes the tile's
// aggregate.  Then the block looks back: each thread reads the status of
// one of the 256 tiles before (a window); the values up to the nearest
// tile that has published its inclusive prefix are combined (each warp
// over as many butterfly levels as needed, then across warps); the block
// moves back 256 tiles if no tile of the window had its prefix; and warp 0
// publishes the tile's own inclusive prefix.  The window is as wide as the
// block so that it covers the tiles in flight (2^20 rows: all 256 tiles),
// and a tile does not walk back window by window behind the published
// prefixes.  Each thread then reads its rows again
// (from L2), applies its prefix row by row, and the warp stores whole
// lines.  A suffix scan walks the tiles and the rows from the end.
//
// Memory order of the look-back: a publication writes the 32-byte value
// first and then the status word with st.release.gpu; readers poll the
// status with ld.acquire.gpu and read the value at L2 (ld.global.cg).
// Aggregate and prefix have slots of their own and nothing is overwritten
// within a launch, so a reader never sees a torn value.  A poll that never
// ends (a fault) traps after 2^24 reads instead of hanging the card.
//
// The batch-inverse epilogue (kInverseEpilogue, with a suffix exclusive
// product, zeros read as one, and T^-1 as the seed): out_i = P_{i-1} *
// (T^-1 * S_{i+1}), 0 where x_i = 0, with P the inclusive prefix products
// of the first pass (P_{-1} = 1), staged beside x, shifted by one row.
// Seeding the scan with T^-1 saves the product by T^-1 a row.
//
// Budget: __launch_bounds__(256, 2), no spill (phase 1 of chip_smoke.py
// prints registers and spills and fails on a spill); 96 KB of dynamic
// shared memory (a warp's two x line buffers and one pre buffer, 4 KB
// each).  Scratch (from the wrapper): 16 words a tile for the two values,
// one status word a tile and the counter.
//
// K13.  The inverse of each nonzero row (0 maps to 0), one thread a row:
// Kaliski's almost Montgomery inverse of the canonical value a (plain
// integers, a^-1 2^k), 2^-k taken off 31 bits at a time (div_pow2), then
// one Montgomery product by R^3 mod p, so aR -> (aR)^-1 R^3 / R = a^-1 R.
// The result is canonical, the bytes of the Fermat ladder.  What bounds
// it: latency; about 360 dependent steps in one thread, each two 8-limb
// shifts or a compare, a subtraction and an addition (carry chains), with
// no multiply until the ~17 of the 2^-k fix-up and the last product,
// against the ladder's ~380 dependent Montgomery products.  A loop that
// runs past 4096 steps traps.  Its optional `steps` output records, for
// each row, its steps (low 16 bits) and k (high 16 bits), from which
// chip_smoke.py counts the multiplies of its bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (gpu/build.py).  C interface for ctypes: every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "field.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // rows a thread
constexpr int kTile = kThreads * kRows;      // rows a tile (gpu/field_kernels.SCAN_TILE)
constexpr int kBlocksPerSM = 2;
constexpr int kLine = 4;                     // rows a thread stages at once (128 bytes)
constexpr int kLines = kRows / kLine;
constexpr int kLineBuf = 32 * 8;             // a warp's 32 lines of 8 16-byte chunks
constexpr int kWarpStage = 3 * kLineBuf;     // two x buffers and one pre buffer
constexpr int kStageSmem = kWarps * kWarpStage * 16;   // 96 KB of dynamic shared memory
constexpr int kValueWords = 16;              // a tile's aggregate and inclusive prefix
constexpr uint32_t kPolls = 1u << 24;
constexpr uint32_t kInverseSteps = 4096;

// operators
constexpr int kMul = 0;
constexpr int kAdd = 1;

// flags
constexpr int kReverse = 1;
constexpr int kExclusive = 2;
constexpr int kZeroAsOne = 4;
constexpr int kInverseEpilogue = 8;
constexpr int kAllFlags = 15;

// tile status
constexpr uint32_t kEmpty = 0;
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kPrefix = 2;

// R mod p (Montgomery one) and R^3 mod p, R = 2^256, limbs little-endian
struct FieldConsts {
    Fe one;
    Fe r3;
};

bool field_consts(int field, FieldConsts* out) {
    static const FieldConsts kFr = {
        {{0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
          0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}},
        {{0xb4bf0040u, 0x5e94d8e1u, 0x1cfbb6b8u, 0x2a489cbeu,
          0xa19fcfedu, 0x893cc664u, 0x7fcc657cu, 0x0cf8594bu}}};
    static const FieldConsts kFq = {
        {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
          0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}},
        {{0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
          0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u}}};
    if (field == 0) { *out = kFr; return true; }
    if (field == 1) { *out = kFq; return true; }
    return false;
}

struct ScanArgs {
    const uint32_t* x;
    uint32_t* out;
    const uint32_t* pre;     // the epilogue's inclusive prefix products
    const uint32_t* seed;    // one row combined into every output, or null
    uint32_t* values;        // [tiles][16]: aggregate, inclusive prefix
    uint32_t* counter;       // the next tile index
    uint32_t* status;        // [tiles]
    int64_t n;
    int flags;
    FieldParams f;
    Fe identity;
    Fe one;
};

#ifdef PLONKIT_SCAN_TRACE
// gpu/scan_phases.py builds a copy with this defined: for each tile,
// the global timer (ns) at its start, after its rows are reduced, before
// and after the look-back and at its end, and its SM
constexpr int64_t kTraceTiles = 1 << 16;
__device__ uint64_t scan_trace[kTraceTiles][6];

__device__ __forceinline__ uint64_t trace_ns() {
    uint64_t ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
}

__device__ __forceinline__ void trace_mark(int64_t t, int slot, uint64_t value) {
    if (threadIdx.x == 0 && t < kTraceTiles) scan_trace[t][slot] = value;
}

__device__ __forceinline__ uint64_t trace_sm() {
    uint32_t sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    return sm;
}
#else
__device__ __forceinline__ uint64_t trace_ns() { return 0; }
__device__ __forceinline__ void trace_mark(int64_t, int, uint64_t) {}
__device__ __forceinline__ uint64_t trace_sm() { return 0; }
#endif

template <int OP>
__device__ __forceinline__ Fe combine(const Fe& a, const Fe& b, const FieldParams& f) {
    if constexpr (OP == kMul) {
        return fe_mont_mul(a, b, f);
    } else {
        return fe_add(a, b, f);
    }
}

__device__ __forceinline__ bool is_zero(const Fe& a) {
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) any |= a.v[j];
    return any == 0;
}

__device__ __forceinline__ Fe shfl_up(const Fe& a, int d) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = __shfl_up_sync(0xffffffffu, a.v[j], d);
    return r;
}

__device__ __forceinline__ Fe shfl_xor(const Fe& a, int m) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = __shfl_xor_sync(0xffffffffu, a.v[j], m);
    return r;
}

__device__ __forceinline__ Fe shfl_idx(const Fe& a, int src) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = __shfl_sync(0xffffffffu, a.v[j], src);
    return r;
}

__device__ __forceinline__ int64_t row_of(int64_t j, int64_t n, bool reverse) {
    return reverse ? n - 1 - j : j;
}

// a loaded row as the scan takes it: zeros read as one where the launch
// asks it
__device__ __forceinline__ Fe scan_input(const ScanArgs& a, Fe x, bool& zero) {
    zero = is_zero(x);
    if (zero && (a.flags & kZeroAsOne)) x = a.one;
    return x;
}

// Staging.  A warp's 32 threads own 32 * kRows consecutive scan positions,
// kRows a thread, and take them kLine rows (one 128-byte line) at a time:
// line t of a warp's buffer holds thread t's rows j0(t) + kLine * c ..,
// its 8 16-byte chunks XOR-swizzled by t mod 8.  Each cp.async instruction
// of the warp copies 4 whole lines (lanes 8k .. 8k + 7 one line), and 8
// threads reading chunk q of their own lines hit 8 different banks.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int line_slot(int t, int q) { return 8 * t + (q ^ (t & 7)); }

// copy line c of every thread of the warp from src, the rows at scan
// positions (shifted by `shift`) below n; one commit group
__device__ __forceinline__ void copy_lines(uint4* buf, const uint32_t* src, int64_t warp_j0,
                                           int c, int shift, const ScanArgs& a, int lane) {
    const uint4* g = reinterpret_cast<const uint4*>(src);
    const bool reverse = a.flags & kReverse;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int t = 4 * k + (lane >> 3), q = lane & 7;
        const int64_t j = warp_j0 + (int64_t)t * kRows + kLine * c + (q >> 1) + shift;
        if (j < a.n) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                             smem_addr(buf + line_slot(t, q))),
                         "l"(g + 2 * row_of(j, a.n, reverse) + (q & 1))
                         : "memory");
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copies_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// line c of every thread of the warp from buf to dst, the rows below n
__device__ __forceinline__ void store_lines(const uint4* buf, uint32_t* dst, int64_t warp_j0,
                                            int c, const ScanArgs& a, int lane) {
    uint4* g = reinterpret_cast<uint4*>(dst);
    const bool reverse = a.flags & kReverse;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int t = 4 * k + (lane >> 3), q = lane & 7;
        const int64_t j = warp_j0 + (int64_t)t * kRows + kLine * c + (q >> 1);
        if (j < a.n) g[2 * row_of(j, a.n, reverse) + (q & 1)] = buf[line_slot(t, q)];
    }
}

__device__ __forceinline__ Fe line_row(const uint4* buf, int lane, int r) {
    const uint4 lo = buf[line_slot(lane, 2 * r)];
    const uint4 hi = buf[line_slot(lane, 2 * r + 1)];
    Fe x;
    x.v[0] = lo.x; x.v[1] = lo.y; x.v[2] = lo.z; x.v[3] = lo.w;
    x.v[4] = hi.x; x.v[5] = hi.y; x.v[6] = hi.z; x.v[7] = hi.w;
    return x;
}

__device__ __forceinline__ void set_line_row(uint4* buf, int lane, int r, const Fe& x) {
    buf[line_slot(lane, 2 * r)] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
    buf[line_slot(lane, 2 * r + 1)] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

// the value first, then the status with release semantics at device scope
__device__ __forceinline__ void publish(const ScanArgs& a, int64_t t, uint32_t state,
                                        const Fe& v) {
    store_fe(a.values + kValueWords * t, state == kPrefix ? 1 : 0, v);
    asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(a.status + t), "r"(state)
                 : "memory");
}

// poll a tile's status until it is published; trap on a poll that never ends
__device__ __forceinline__ uint32_t wait_status(const uint32_t* status) {
    for (uint32_t polls = 0;; ++polls) {
        uint32_t s;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(s) : "l"(status) : "memory");
        if (s != kEmpty) return s;
        if (polls == kPolls) __trap();
    }
}

// a published value, read at L2 (past a stale L1 line)
__device__ __forceinline__ Fe load_value(const uint32_t* p) {
    const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(p));
    const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
    Fe r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
}

// the combination of everything before tile t in scan order (the seed
// included), valid in warp 0.  Every thread of the block takes part: a
// window is the 256 tiles before, one thread each; the tiles up to the
// nearest one with an inclusive prefix are combined (each warp's lanes by
// a butterfly over the levels needed, then warp 0 over the warps), and the
// next window is taken only if no tile of this one had its prefix.
template <int OP>
__device__ __forceinline__ Fe look_back(const ScanArgs& a, int64_t t, uint32_t* ballots,
                                        Fe* parts) {
    if (t == 0) return a.seed ? load_fe(a.seed, 0) : a.identity;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    Fe acc = a.identity;
    for (int64_t last = t - 1, window = 0;; last -= kThreads, ++window) {
        const int64_t j = last - tid;
        uint32_t state = kPrefix;         // before tile 0: the identity
        Fe val = a.identity;
        if (j >= 0) {
            state = wait_status(a.status + j);
            val = load_value(a.values + kValueWords * j + (state == kPrefix ? 8 : 0));
        }
        const uint32_t prefixed = __ballot_sync(0xffffffffu, state == kPrefix);
        if (lane == 0) ballots[warp] = prefixed;
        __syncthreads();
        int stop = kThreads - 1;          // the nearest tile with its prefix
        bool found = false;
#pragma unroll
        for (int w = kWarps - 1; w >= 0; --w) {
            const uint32_t b = ballots[w];
            if (b) {
                stop = 32 * w + __ffs(b) - 1;
                found = true;
            }
        }
        if (tid > stop) val = a.identity;
        const int lanes = min(stop - 32 * warp, 31);   // uniform in the warp
        for (int m = 1; m <= lanes; m <<= 1) val = combine<OP>(val, shfl_xor(val, m), a.f);
        if (lane == 0) parts[warp] = val;
        __syncthreads();
        if (warp == 0) {
            const int warps = stop >> 5;
            Fe w = lane <= warps ? parts[lane] : a.identity;
            for (int m = 1; m <= warps; m <<= 1) w = combine<OP>(w, shfl_xor(w, m), a.f);
            w = shfl_idx(w, 0);
            acc = window ? combine<OP>(acc, w, a.f) : w;
        }
        if (found) return acc;
        __syncthreads();                  // ballots and parts are read before they are rewritten
    }
}

template <int OP>
__device__ __forceinline__ void scan_tile(const ScanArgs& a) {
    extern __shared__ uint4 stage[];            // per warp: two x buffers, one pre buffer
    __shared__ Fe warp_vals[kWarps];
    __shared__ Fe parts[kWarps];
    __shared__ uint32_t ballots[kWarps];
    __shared__ uint32_t tile_index;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool exclusive = a.flags & kExclusive;
    const bool epilogue = a.flags & kInverseEpilogue;
    uint4* const xbuf = stage + kWarpStage * warp;
    uint4* const pbuf = xbuf + 2 * kLineBuf;
    bool zero;

    const uint64_t start_ns = trace_ns();
    if (tid == 0) tile_index = atomicAdd(a.counter, 1u);
    __syncthreads();
    const int64_t t = tile_index;
    trace_mark(t, 0, start_ns);
    trace_mark(t, 5, trace_sm());
    const int64_t warp_j0 = t * kTile + (int64_t)32 * kRows * warp;
    const int64_t j0 = warp_j0 + (int64_t)kRows * lane;    // the thread's first position

    // the thread's total, its next line copied in while it multiplies; then
    // the warp's inclusive scan of the totals
    Fe incl = a.identity;
    copy_lines(xbuf, a.x, warp_j0, 0, 0, a, lane);
#pragma unroll 1
    for (int c = 0; c < kLines; ++c) {
        if (c + 1 < kLines) {
            copy_lines(xbuf + kLineBuf * ((c + 1) & 1), a.x, warp_j0, c + 1, 0, a, lane);
            copies_wait<1>();
        } else {
            copies_wait<0>();
        }
        __syncwarp();
        const uint4* cur = xbuf + kLineBuf * (c & 1);
#pragma unroll
        for (int r = 0; r < kLine; ++r) {
            const int64_t j = j0 + kLine * c + r;
            const Fe x = j < a.n ? scan_input(a, line_row(cur, lane, r), zero) : a.identity;
            incl = c == 0 && r == 0 ? x : combine<OP>(incl, x, a.f);
        }
        __syncwarp();
    }
    trace_mark(t, 1, trace_ns());
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Fe y = shfl_up(incl, d);
        if (lane >= d) incl = combine<OP>(y, incl, a.f);
    }
    Fe ex = shfl_up(incl, 1);
    if (lane == 0) ex = a.identity;
    if (lane == 31) warp_vals[warp] = incl;
    __syncthreads();

    // warp 0 scans the warp totals and publishes the tile's aggregate; the
    // block looks back; warp 0 publishes the inclusive prefix and leaves
    // each warp's exclusive prefix in warp_vals
    Fe agg = a.identity, wex = a.identity;
    if (warp == 0) {
        Fe w = lane < kWarps ? warp_vals[lane] : a.identity;
#pragma unroll
        for (int d = 1; d < kWarps; d <<= 1) {
            const Fe y = shfl_up(w, d);
            if (lane >= d) w = combine<OP>(y, w, a.f);
        }
        agg = shfl_idx(w, kWarps - 1);
        wex = shfl_up(w, 1);
        if (lane == 0) wex = a.identity;
        if (lane == 0 && t > 0) publish(a, t, kAggregate, agg);
    }
    trace_mark(t, 2, trace_ns());
    const Fe prefix = look_back<OP>(a, t, ballots, parts);
    trace_mark(t, 3, trace_ns());
    if (warp == 0) {
        if (lane == 0) publish(a, t, kPrefix, combine<OP>(prefix, agg, a.f));
        if (lane < kWarps) warp_vals[lane] = combine<OP>(prefix, wex, a.f);
    }
    __syncthreads();

    // the thread's rows again (from L2), from its exclusive prefix on; each
    // output takes its input's place in the buffer, and the warp stores
    // whole lines
    Fe acc = combine<OP>(warp_vals[warp], ex, a.f);
    copy_lines(xbuf, a.x, warp_j0, 0, 0, a, lane);
#pragma unroll 1
    for (int c = 0; c < kLines; ++c) {
        if (epilogue) copy_lines(pbuf, a.pre, warp_j0, c, 1, a, lane);
        // groups complete in order: waiting for all but the newest waits
        // for this line of x (and of pre)
        if (c + 1 < kLines) {
            copy_lines(xbuf + kLineBuf * ((c + 1) & 1), a.x, warp_j0, c + 1, 0, a, lane);
            copies_wait<1>();
        } else {
            copies_wait<0>();
        }
        __syncwarp();
        uint4* cur = xbuf + kLineBuf * (c & 1);
#pragma unroll
        for (int r = 0; r < kLine; ++r) {
            const int64_t j = j0 + kLine * c + r;
            const Fe x = j < a.n ? scan_input(a, line_row(cur, lane, r), zero) : a.identity;
            Fe o = acc;
            if (!exclusive || j + 1 < j0 + kRows) acc = combine<OP>(acc, x, a.f);
            if (!exclusive) o = acc;
            if constexpr (OP == kMul) {
                // out_i = P_{i-1} * T^-1 * S_{i+1}, 0 where x_i = 0; P_{i-1}
                // is the row at the next position, one past the end
                if (epilogue) {
                    const Fe p = j + 1 < a.n ? line_row(pbuf, lane, r) : a.one;
                    o = zero ? Fe{} : combine<kMul>(p, o, a.f);
                }
            }
            set_line_row(cur, lane, r, o);
        }
        __syncwarp();
        store_lines(cur, a.out, warp_j0, c, a, lane);
        __syncwarp();
    }
    trace_mark(t, 4, trace_ns());
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) field_scan_mul_kernel(const ScanArgs a) {
    scan_tile<kMul>(a);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) field_scan_add_kernel(const ScanArgs a) {
    scan_tile<kAdd>(a);
}

// -- K13 -----------------------------------------------------------------

// a >> k for 0 < k < 32
__device__ __forceinline__ void shr(Fe& a, int k) {
#pragma unroll
    for (int j = 0; j < 7; j++) a.v[j] = __funnelshift_r(a.v[j], a.v[j + 1], k);
    a.v[7] >>= k;
}

// a > b
__device__ __forceinline__ bool gt(const Fe& a, const Fe& b) {
#pragma unroll
    for (int j = 7; j >= 0; j--) {
        if (a.v[j] != b.v[j]) return a.v[j] > b.v[j];
    }
    return false;
}

// a << k for 0 < k < 32 (no bit leaves the top limb)
__device__ __forceinline__ void shl(Fe& a, int k) {
#pragma unroll
    for (int j = 7; j > 0; j--) a.v[j] = __funnelshift_l(a.v[j - 1], a.v[j], k);
    a.v[0] <<= k;
}

// a + b for a + b < 2^256, one carry chain
__device__ __forceinline__ Fe add_raw(const Fe& a, const Fe& b) {
    Fe s;
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, %23;"
        : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]),
          "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    return s;
}

// a - b for a >= b, one borrow chain
__device__ __forceinline__ Fe sub_raw(const Fe& a, const Fe& b) {
    Fe d;
    asm("sub.cc.u32 %0, %8, %16;\n\t"
        "subc.cc.u32 %1, %9, %17;\n\t"
        "subc.cc.u32 %2, %10, %18;\n\t"
        "subc.cc.u32 %3, %11, %19;\n\t"
        "subc.cc.u32 %4, %12, %20;\n\t"
        "subc.cc.u32 %5, %13, %21;\n\t"
        "subc.cc.u32 %6, %14, %22;\n\t"
        "subc.u32 %7, %15, %23;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
          "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    return d;
}

// x * 2^-k mod p for x < p and 0 < k < 32: with m = x * n0 mod 2^k (n0 =
// -p^-1 mod 2^32), t = x + m * p < 2^k p + p is a multiple of 2^k, and
// t / 2^k is below 2p.  t takes 9 limbs: one carry chain adds the low
// halves of m * p_j at limb j, a second the high halves at limb j + 1.
__device__ __forceinline__ Fe div_pow2(const Fe& x, int k, const FieldParams& f) {
    const uint32_t m = (x.v[0] * f.n0) & ((1u << k) - 1);
    uint32_t t[9];
    asm("mad.lo.cc.u32 %0, %9, %18, %10;\n\t"
        "madc.lo.cc.u32 %1, %9, %19, %11;\n\t"
        "madc.lo.cc.u32 %2, %9, %20, %12;\n\t"
        "madc.lo.cc.u32 %3, %9, %21, %13;\n\t"
        "madc.lo.cc.u32 %4, %9, %22, %14;\n\t"
        "madc.lo.cc.u32 %5, %9, %23, %15;\n\t"
        "madc.lo.cc.u32 %6, %9, %24, %16;\n\t"
        "madc.lo.cc.u32 %7, %9, %25, %17;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %9, %19, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %20, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %21, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %22, %5;\n\t"
        "madc.hi.cc.u32 %6, %9, %23, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %24, %7;\n\t"
        "madc.hi.u32 %8, %9, %25, %8;"
        : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]),
          "=&r"(t[6]), "=&r"(t[7]), "=&r"(t[8])
        : "r"(m), "r"(x.v[0]), "r"(x.v[1]), "r"(x.v[2]), "r"(x.v[3]), "r"(x.v[4]),
          "r"(x.v[5]), "r"(x.v[6]), "r"(x.v[7]), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]),
          "r"(f.p[3]), "r"(f.p[4]), "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]));
    Fe q;
#pragma unroll
    for (int j = 0; j < 8; j++) q.v[j] = __funnelshift_r(t[j], t[j + 1], k);
    return reduce_once(q, f);
}

// the number of trailing zero bits of an even a, at most 31 a step
__device__ __forceinline__ int even_shift(const Fe& a) {
    return a.v[0] ? __ffs(a.v[0]) - 1 : 31;
}

__device__ __forceinline__ void count_step(uint32_t& steps) {
    if (++steps > kInverseSteps) __trap();
}

// a^-1 mod p for 0 < a < p, by Kaliski's almost Montgomery inverse: with
// u = p, v = a, r = 0, s = 1, p = u s + v r holds throughout, so r, s < 2p;
// a run of t trailing zeros of u (or v) is shifted out in one step and s
// (or r) shifted up by t, k counting the bits; an odd pair subtracts the
// smaller from the larger and adds the other's coefficient.  At v = 0, p -
// (r mod p) = a^-1 2^k, and 2^-k comes from div_pow2 31 bits at a time.
// No step multiplies: a step's dependent chain is one compare and a
// subtraction beside an addition, or two shifts.
__device__ Fe almost_inverse(const Fe& a, const FieldParams& f, uint32_t& steps) {
    Fe u, v = a, r = {}, s = {};
#pragma unroll
    for (int j = 0; j < 8; j++) u.v[j] = f.p[j];
    s.v[0] = 1;
    uint32_t k = 0;
    while (!is_zero(v)) {
        if (!(u.v[0] & 1)) {
            const int t = even_shift(u);
            shr(u, t);
            shl(s, t);
            k += t;
            count_step(steps);
        } else if (!(v.v[0] & 1)) {
            const int t = even_shift(v);
            shr(v, t);
            shl(r, t);
            k += t;
            count_step(steps);
        } else if (gt(u, v)) {
            u = sub_raw(u, v);
            r = add_raw(r, s);
            count_step(steps);
        } else {
            v = sub_raw(v, u);
            s = add_raw(r, s);
            count_step(steps);
        }
    }
    Fe p;
#pragma unroll
    for (int j = 0; j < 8; j++) p.v[j] = f.p[j];
    Fe x = sub_raw(p, reduce_once(r, f));
    steps |= k << 16;
    for (; k > 31; k -= 31) x = div_pow2(x, 31, f);
    return k ? div_pow2(x, (int)k, f) : x;
}

__global__ void field_inverse_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                                     uint32_t* __restrict__ steps, int64_t n, FieldParams f,
                                     Fe r3) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Fe x = load_fe(a, i);
    uint32_t count = 0;
    Fe r = {};
    if (!is_zero(x)) r = fe_mont_mul(almost_inverse(x, f, count), r3, f);
    store_fe(out, i, r);
    if (steps != nullptr) steps[i] = count;
}

}  // namespace

// K12.  x, out: [n, 8] rows (out must not alias x); op 0 = product, 1 =
// add; flags: 1 suffix, 2 exclusive, 4 zeros read as one (product only), 8
// the batch-inverse epilogue (with 1, 2 and 4, reading `pre`); seed: one
// row or null; scratch: at least 17 * ceil(n / 1024) + 1 words, 16-byte
// aligned.
extern "C" int plonkit_field_scan(const void* x, void* out, const void* pre, const void* seed,
                                  void* scratch, long long scratch_words, long long n,
                                  int field, int op, int flags, void* stream) {
    FieldParams f;
    FieldConsts c;
    if (!field_params(field, &f) || !field_consts(field, &c) || n < 0 ||
        (op != kMul && op != kAdd) || (flags & ~kAllFlags))
        return (int)cudaErrorInvalidValue;
    if ((flags & kZeroAsOne) && op != kMul) return (int)cudaErrorInvalidValue;
    if ((flags & kInverseEpilogue) &&
        ((flags & kAllFlags) != kAllFlags || op != kMul || pre == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long tiles = (n + kTile - 1) / kTile;
    if (tiles > 0x7FFFFFFFLL || scratch_words < (kValueWords + 1) * tiles + 1)
        return (int)cudaErrorInvalidValue;
    ScanArgs a;
    a.x = (const uint32_t*)x;
    a.out = (uint32_t*)out;
    a.pre = (const uint32_t*)pre;
    a.seed = (const uint32_t*)seed;
    a.values = (uint32_t*)scratch;
    a.counter = a.values + kValueWords * tiles;
    a.status = a.counter + 1;
    a.n = (int64_t)n;
    a.flags = flags;
    a.f = f;
    a.identity = op == kMul ? c.one : Fe{};
    a.one = c.one;
    const cudaError_t e = cudaMemsetAsync(a.counter, 0, (size_t)(tiles + 1) * sizeof(uint32_t),
                                          (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    static const cudaError_t smem_mul = cudaFuncSetAttribute(
        field_scan_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageSmem);
    static const cudaError_t smem_add = cudaFuncSetAttribute(
        field_scan_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageSmem);
    if (smem_mul != cudaSuccess) return (int)smem_mul;
    if (smem_add != cudaSuccess) return (int)smem_add;
    if (op == kMul) {
        field_scan_mul_kernel<<<(unsigned)tiles, kThreads, kStageSmem, (cudaStream_t)stream>>>(a);
    } else {
        field_scan_add_kernel<<<(unsigned)tiles, kThreads, kStageSmem, (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}

// K13.  a, out: [n, 8] Montgomery rows; steps: [n] uint32 or null.
extern "C" int plonkit_field_inverse(const void* a, void* out, void* steps, long long n,
                                     int field, void* stream) {
    FieldParams f;
    FieldConsts c;
    if (!field_params(field, &f) || !field_consts(field, &c) || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    constexpr int kInverseThreads = 32;
    const long long blocks = (n + kInverseThreads - 1) / kInverseThreads;
    field_inverse_kernel<<<(unsigned)blocks, kInverseThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (uint32_t*)out, (uint32_t*)steps, (int64_t)n, f, c.r3);
    return (int)cudaGetLastError();
}

#ifdef PLONKIT_SCAN_TRACE
// the trace of the last launch's first `tiles` tiles, [tiles][6] uint64
extern "C" int plonkit_scan_trace(void* host, long long tiles) {
    if (tiles < 0 || tiles > kTraceTiles) return (int)cudaErrorInvalidValue;
    return (int)cudaMemcpyFromSymbol(host, scan_trace, (size_t)tiles * 6 * sizeof(uint64_t));
}
#endif
