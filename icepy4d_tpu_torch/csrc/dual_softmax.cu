// LoFTR's dual-softmax coarse match for Hopper (sm_90a) without the
// L0 x L1 similarity in device memory: TMA loads, 3xTF32 wgmma products,
// f32 statistics, two passes over the product.
//
// Replaces no Pallas kernel: the JAX package runs the dual softmax as
// plain jnp (icepy4d_tpu/models/loftr.py), and the port's plain version
// (ops/dual_softmax.py::confidence_plain) writes a (B, L0, L1) f32
// similarity, two softmaxes of it and their product, ~10 passes over
// 3.6 GB a tile pair at LoFTR's 30000 coarse tokens. Added because the
// coarse match needs only three vectors of that matrix. With s the
// scaled similarity, R_i the log-sum-exp of row i and C_j that of column
// j, conf_ij = exp(2 s_ij - R_i - C_j), so
//   bj_i = argmax_j (2 s_ij - C_j),  bv_i = exp(max_j (2 s_ij - C_j) - R_i),
//   bi_j = argmax_i (2 s_ij - R_i),
// which is what the matcher takes from conf (argmax and max over dim 2,
// argmax over dim 1). Pass 1 computes R and per-64-row partial column
// statistics, a reduction gives C; pass 2 recomputes the product for the
// three argmaxes; a second reduction gives bj, bv and bi.
//
// What bounds it on this card: the products. At (2 tile pairs, 30000,
// 30000, d 256) each pass is 3 TF32 products of 0.461 TFLOP a tile pair
// (3xTF32: the operands split into rounded TF32 high and low parts,
// a_hi b_hi + a_hi b_lo + a_lo b_hi summed in f32, so the products keep
// f32 accuracy, ~2^-21 relative, as the plain version's f32 bmm), 2.77
// TFLOP a tile pair over both passes: 5.6 ms at the 495 TFLOP/s TF32
// peak. The operands stream from L2: a 128 x 128 output tile reads 8
// bytes an element of both operands per k, ~43 bytes a clock an SM at
// the tensor-core rate. Exponentials (two an element in pass 1) and the
// column reductions run beside the products.
//
// What the design does about it:
//  - A prologue kernel splits c0 and c1 into TF32 high and low parts
//    (round to nearest, low 13 bits zero), so the tensor cores read
//    exact values.
//  - One block owns 128 rows of one tile pair and sweeps its split of
//    the column tiles (128 wide). Three warpgroups: two consumers of 64
//    rows each, and a producer whose elected thread keeps TMA loads
//    (128-byte swizzle) of k-chunks of 32 (A high, A low, B high, B low;
//    64 KB) in flight through a ring of STAGES buffers. Each chunk is 12
//    wgmma.m64n128k8 tf32 per consumer; the chunk before is released
//    once the next one is issued.
//  - Row statistics stay in registers, each thread over its own
//    columns, merged across its quad at the end. Column statistics of a
//    tile are merged in registers (a thread's two rows, then a
//    reduce-scatter across the eight lanes that share its columns), then
//    across the four warps through shared memory, and written as one
//    partial per 64 rows and column. Partials are (max, sum of 2^(x -
//    max)) in pass 1 and (value, row) in pass 2.
//  - Ties go to the lowest index, as torch.argmax returns them.
//  - Masked entries take -1e9 (the plain version's fill), entries past
//    L0 or L1 -inf (they do not exist). A row whose every entry is -1e9
//    gets the plain version's bv: 1/(L0 L1) where some column is wholly
//    -1e9 too, else 0.
//  - The block count per tile pair is split over the columns where that
//    fills the last wave of blocks better (row partials merged in the
//    reductions).
// Any L0, L1 >= 1 (L1 <= 131072), d = 256 (ops/dual_softmax.py
// FEATURE_DIM). Shared memory per block: 192 KB of ring, 16 KB of
// column scratch, the barriers and a bit a column of the mask (215,360
// bytes at L1 = 30000); one block of 384 threads per SM.

#include <cuda.h>   // CUtensorMap and its enums; libcuda's entry is looked up at run time
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int D = 256;                    // feature dim
constexpr int KC = 32;                    // k of a chunk: one 128-byte swizzle row of f32
constexpr int NCHUNK = D / KC;
constexpr int BM = 128;                   // rows a block, 64 a consumer warpgroup
constexpr int BN = 128;                   // columns a tile
constexpr int STAGES = 3;
constexpr int WG = 128;
constexpr int THREADS = 3 * WG;
constexpr int CONSUMER_WARPS = 8;
constexpr int SUB = BM * KC * 4;          // one operand's chunk, 16 KB (BM == BN)
constexpr int STAGE_BYTES = 4 * SUB;      // A high, A low, B high, B low
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SCRATCH_BYTES = 2 * 2 * 4 * BN * 8;   // [warpgroup][buffer][warp][column] float2
constexpr int BAR_BYTES = 64;
static_assert(2 * STAGES * 8 <= BAR_BYTES, "room for the barriers");
constexpr int MAX_SPLITS = 4;
constexpr int MAX_L1 = 131072;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED_T = -1e9f * LOG2E;  // the plain version's -1e9, in log2 units

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    return ok != 0;
}

// Wait until the barrier has left the phase of this parity; a wait of
// seconds is a fault of the pipeline: trap, so that the launch ends in an
// error and not in a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - t0 > 4000000000LL) __trap();
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile whose rows are 128 bytes,
// 128-byte swizzled, 1024-byte aligned: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
           ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving a definition or a use of these
// registers across a wgmma fence or wait
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(d, i)                                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
        "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = or += A (64 x 8 tf32, shared, K-major) B^T (128 x 8 tf32, shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// ---- the two merges ---------------------------------------------------------

// (m, l) <- the log-sum-exp partial of (m, l) and (m2, l2), each a max and
// the sum of 2^(x - max) over its entries; a max of -inf is an empty partial.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
    const float d = m2 == neg_inf() ? pos_inf() : m - m2;
    const float e = ex2(-fabsf(d));
    const bool keep = d >= 0.f;
    l = keep ? fmaf(l2, e, l) : fmaf(l, e, l2);
    m = keep ? m : m2;
}

// (v, i) <- the larger of (v, i) and (v2, i2); the lower index on a tie
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2, int i2) {
    const bool take = v2 > v || (v2 == v && i2 < i);
    v = take ? v2 : v;
    i = take ? i2 : i;
}

// ---- accumulator layout ---------------------------------------------------
// Thread (warp w, lane 4g + t) of a warpgroup holds, of its 64 x 128 tile,
// rows 16w + g ([4j], [4j+1]) and 16w + g + 8 ([4j+2], [4j+3]) at columns
// 8j + 2t, 8j + 2t + 1. Its 32 columns are c = 2j + e, column 8j + 2t + e.
// A column's pair of partials is kept in place: first at [MI(c)], second
// at [MI(c) + 2].
__device__ __forceinline__ constexpr int MI(int c) { return 4 * (c >> 1) + (c & 1); }

struct Params {
    const uint8_t* m0;   // (B, L0) bool bytes
    const uint8_t* m1;   // (B, L1)
    float2* part;        // (B, G2, L1p) column partials of 64-row groups
    float2* rowpart;     // (B, MAX_SPLITS, L0p) row partials of the column splits
    float* R;            // (B, L0p) row log-sum-exp, log2 units (0 past L0)
    float* C;            // (B, L1p) column log-sum-exp (0 past L1)
    int L0, L1, L0p, L1p, G2, n_rb, n_ct, splits;
    float scale;         // log2(e) / (d T): the product to log2 units
};

// One level of the reduce-scatter of a column partial across the lanes
// that share its columns: lanes with bit S clear keep entries [0, N/2),
// the others [N/2, N), each merged with its partner's copy.
template <bool LSE, int N, int S>
__device__ __forceinline__ void scatter_level(float (&a)[64], int lane) {
    const bool hi = (lane & S) != 0;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
        const int lo_i = MI(k), hi_i = MI(k + N / 2);
        const float k1 = hi ? a[hi_i] : a[lo_i], k2 = hi ? a[hi_i + 2] : a[lo_i + 2];
        const float s1 = hi ? a[lo_i] : a[hi_i], s2 = hi ? a[lo_i + 2] : a[hi_i + 2];
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, S);
        const float r2 = __shfl_xor_sync(0xffffffffu, s2, S);
        float m = k1, x = k2;
        if (LSE) {
            lse_merge(m, x, r1, r2);
        } else {
            int i = __float_as_int(k2);
            arg_merge(m, i, r1, __float_as_int(r2));
            x = __int_as_float(i);
        }
        a[lo_i] = m;
        a[lo_i + 2] = x;
    }
}

// The tile's column partials, one per column and 64 rows, from the pairs
// kept in place in `a`: reduce-scatter across the 8 lanes of a column,
// then across the 4 warps through shared memory; written to `out`
// (128 columns). One named barrier of the warpgroup a tile; the scratch
// is double-buffered so that the next tile's writes need no second one.
template <bool LSE>
__device__ __forceinline__ void column_partials(float (&a)[64], float2* scratch, int wg, int buf,
                                                int warp, int lane, int tid, float2* out) {
    scatter_level<LSE, 32, 16>(a, lane);
    scatter_level<LSE, 16, 8>(a, lane);
    scatter_level<LSE, 8, 4>(a, lane);
    // entries k = 0..3 now hold columns 16g + 8 (k >> 1) + 2t + (k & 1)
    const int g = lane >> 2, t = lane & 3;
    float2* mine = scratch + ((wg * 2 + buf) * 4) * BN;
    float2* row = mine + warp * BN;
    *reinterpret_cast<float4*>(row + 16 * g + 2 * t) = make_float4(a[0], a[2], a[1], a[3]);
    *reinterpret_cast<float4*>(row + 16 * g + 8 + 2 * t) = make_float4(a[4], a[6], a[5], a[7]);
    if (wg == 0)
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
    else
        asm volatile("bar.sync 3, 128;\n" ::: "memory");
    float2 r = mine[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
        const float2 o = mine[w * BN + tid];
        if (LSE) {
            lse_merge(r.x, r.y, o.x, o.y);
        } else {
            int i = __float_as_int(r.y);
            arg_merge(r.x, i, o.x, __float_as_int(o.y));
            r.y = __int_as_float(i);
        }
    }
    out[tid] = r;
}

// Scores of a tile in log2 units, masked: -inf where the row or the
// column does not exist, MASKED_T where either is masked.
__device__ __forceinline__ void mask_tile(float (&a)[64], uint4 w, int state0, int state1, int col0,
                                          int t, int L1) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * j + 2 * t + e;
            const bool exists = col < L1;
            const bool live = (words[j >> 2] >> (8 * (j & 3) + 2 * t + e)) & 1u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int state = h ? state1 : state0;   // 0 live, 1 masked, 2 past L0
                float& x = a[4 * j + 2 * h + e];
                x = (!exists || state == 2) ? neg_inf() : ((!live || state == 1) ? MASKED_T : x);
            }
        }
    }
}

template <int PASS>
__global__ void __launch_bounds__(THREADS, 1) dual_pass(const __grid_constant__ CUtensorMap map_ahi,
                                                         const __grid_constant__ CUtensorMap map_alo,
                                                         const __grid_constant__ CUtensorMap map_bhi,
                                                         const __grid_constant__ CUtensorMap map_blo,
                                                         const Params p) {
    extern __shared__ uint8_t smem_raw[];
    // the swizzled tiles need 1024-byte alignment
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t ring_s = smem_u32(smem);
    float2* scratch = reinterpret_cast<float2*>(smem + RING_BYTES);
    const uint32_t bar_s = ring_s + RING_BYTES + SCRATCH_BYTES;   // full [st], empty [st]
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + RING_BYTES + SCRATCH_BYTES + BAR_BYTES);

    const int b = blockIdx.y;
    const int rb = blockIdx.x % p.n_rb, sp = blockIdx.x / p.n_rb;
    const int ct0 = sp * p.n_ct / p.splits, ct1 = (sp + 1) * p.n_ct / p.splits;
    const int row0 = rb * BM;
    const int wg = threadIdx.x / WG;

    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(bar_s + 8 * st, 1);
            mbar_init(bar_s + 8 * (STAGES + st), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer -------------------------------------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == 2 * WG) {
            int st = 0;
            uint32_t ph = 0;
            for (int ct = ct0; ct < ct1; ++ct) {
                for (int kc = 0; kc < NCHUNK; ++kc) {
                    mbar_wait(bar_s + 8 * (STAGES + st), ph ^ 1);
                    const uint32_t full = bar_s + 8 * st;
                    const uint32_t dst = ring_s + st * STAGE_BYTES;
                    mbar_expect_tx(full, STAGE_BYTES);
                    tma_load_3d(dst, &map_ahi, full, kc * KC, row0, b);
                    tma_load_3d(dst + SUB, &map_alo, full, kc * KC, row0, b);
                    tma_load_3d(dst + 2 * SUB, &map_bhi, full, kc * KC, ct * BN, b);
                    tma_load_3d(dst + 3 * SUB, &map_blo, full, kc * KC, ct * BN, b);
                    if (++st == STAGES) {
                        st = 0;
                        ph ^= 1;
                    }
                }
            }
        }
        return;
    }

    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    // the column mask of this split as one bit a column, 0 past L1
    {
        const uint8_t* mrow = p.m1 + (size_t)b * p.L1;
        const int n_words = (ct1 - ct0) * (BN / 32);
        for (int w = threadIdx.x >> 5; w < n_words; w += CONSUMER_WARPS) {
            const int col = ct0 * BN + 32 * w + lane;
            const bool keep = col < p.L1 && mrow[col] != 0;
            const uint32_t word = __ballot_sync(0xffffffffu, keep);
            if (lane == 0) bits[w] = word;
        }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    const int r0 = row0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    auto row_state = [&](int r) {
        return r >= p.L0 ? 2 : (p.m0[(size_t)b * p.L0 + r] ? 0 : 1);
    };
    const int state0 = row_state(r0), state1 = row_state(r1);
    const bool rows_live = state0 == 0 && state1 == 0;
    // pass 2: the rows' log-sum-exp (0 past L0, where every score is -inf)
    float Rrow[2] = {0.f, 0.f};
    if (PASS == 2) {
        Rrow[0] = p.R[(size_t)b * p.L0p + r0];
        Rrow[1] = p.R[(size_t)b * p.L0p + r1];
    }
    float2* part = p.part + ((size_t)b * p.G2 + rb * 2 + wg) * p.L1p;

    // row state: pass 1 (max, sum of 2^(x - max)), pass 2 (best value, column)
    float rv[2], rl[2];
    int ri[2] = {0, 0};
    rv[0] = rv[1] = neg_inf();
    rl[0] = rl[1] = 0.f;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    int st = 0, buf = 0;
    uint32_t ph = 0;
    auto release = [&](int stage) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_s + 8 * (STAGES + stage));
    };

    for (int ct = ct0; ct < ct1; ++ct) {
        const int col0 = ct * BN;
        float2 cpre[BN / 8];
        if (PASS == 2) {
            const float* Cb = p.C + (size_t)b * p.L1p + col0 + 2 * t;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) cpre[j] = *reinterpret_cast<const float2*>(Cb + 8 * j);
        }
        // ---- the product of the tile, chunk by chunk ----------------------
        int prev = 0;
#pragma unroll
        for (int kc = 0; kc < NCHUNK; ++kc) {
            mbar_wait(bar_s + 8 * st, ph);
            const uint32_t base = ring_s + st * STAGE_BYTES;
            const uint64_t ahi = smem_desc(base + wg * 64 * 128);
            const uint64_t alo = smem_desc(base + SUB + wg * 64 * 128);
            const uint64_t bhi = smem_desc(base + 2 * SUB);
            const uint64_t blo = smem_desc(base + 3 * SUB);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KC / 8; ++kk) {   // 32 bytes along the row a step
                // the small terms first; the tile's first product overwrites
                wgmma_tf32(acc, alo + 2 * kk, bhi + 2 * kk, kc | kk);
                wgmma_tf32(acc, ahi + 2 * kk, blo + 2 * kk, 1);
                wgmma_tf32(acc, ahi + 2 * kk, bhi + 2 * kk, 1);
            }
            wgmma_commit();
            if (kc > 0) {
                wgmma_wait<1>();
                release(prev);
            }
            prev = st;
            if (++st == STAGES) {
                st = 0;
                ph ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(prev);

        // ---- scores in log2 units, masked ----------------------------------
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= p.scale;
        const uint4 wbits = *reinterpret_cast<const uint4*>(bits + (ct - ct0) * (BN / 32));
        const bool cols_live = col0 + BN <= p.L1 && (wbits.x & wbits.y & wbits.z & wbits.w) == 0xffffffffu;
        if (!(cols_live && rows_live)) mask_tile(acc, wbits, state0, state1, col0, t, p.L1);

        if (PASS == 1) {
            // rows: online max and sum over this thread's columns
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float mx = rv[h];
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
                    mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
                const float use = mx == neg_inf() ? 0.f : mx;
                float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int j = 0; j < BN / 8; ++j)
                    s[j & 3] += ex2(acc[4 * j + 2 * h] - use) + ex2(acc[4 * j + 2 * h + 1] - use);
                rl[h] = fmaf(rl[h], ex2(rv[h] - use), (s[0] + s[1]) + (s[2] + s[3]));
                rv[h] = mx;
            }
            // columns: this thread's two rows as one partial, in place
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                float m = acc[MI(c)], l = m == neg_inf() ? 0.f : 1.f;
                const float x = acc[MI(c) + 2];
                lse_merge(m, l, x, x == neg_inf() ? 0.f : 1.f);
                acc[MI(c)] = m;
                acc[MI(c) + 2] = l;
            }
            column_partials<true>(acc, scratch, wg, buf, warp, lane, tid, part + col0);
        } else {
            // rows: best of 2 s - C_j, columns in increasing order
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = col0 + 8 * j + 2 * t + e;
                    const float cj = e ? cpre[j].y : cpre[j].x;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float v = fmaf(2.f, acc[4 * j + 2 * h + e], -cj);
                        if (v > rv[h]) {
                            rv[h] = v;
                            ri[h] = col;
                        }
                    }
                }
            }
            // columns: best of 2 s - R_i over this thread's two rows, in place
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                const float v0 = fmaf(2.f, acc[MI(c)], -Rrow[0]);
                const float v1 = fmaf(2.f, acc[MI(c) + 2], -Rrow[1]);
                const bool second = v1 > v0;
                acc[MI(c)] = second ? v1 : v0;
                acc[MI(c) + 2] = __int_as_float(second ? r1 : r0);
            }
            column_partials<false>(acc, scratch, wg, buf, warp, lane, tid, part + col0);
        }
        buf ^= 1;
    }

    // ---- the rows' partials of this split, merged across the quad ---------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int s = 1; s <= 2; s <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, rv[h], s);
            if (PASS == 1) {
                const float ol = __shfl_xor_sync(0xffffffffu, rl[h], s);
                lse_merge(rv[h], rl[h], ov, ol);
            } else {
                const int oi = __shfl_xor_sync(0xffffffffu, ri[h], s);
                arg_merge(rv[h], ri[h], ov, oi);
            }
        }
    }
    if (t == 0) {
        float2* rp = p.rowpart + ((size_t)b * MAX_SPLITS + sp) * p.L0p;
        rp[r0] = make_float2(rv[0], PASS == 1 ? rl[0] : __int_as_float(ri[0]));
        rp[r1] = make_float2(rv[1], PASS == 1 ? rl[1] : __int_as_float(ri[1]));
    }
}

// c0 and c1 (f32, n0 and n1 float4s) into their TF32 high parts and the
// TF32 low parts of what the high parts leave, each rounded to nearest
// (ties away), so that the tensor cores read them exactly.
__device__ __forceinline__ float tf32_round(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__global__ void split_tf32(const float4* c0, const float4* c1, float4* a_hi, float4* a_lo, float4* b_hi,
                           float4* b_lo, long long n0, long long n1) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n0 + n1;
         i += (long long)gridDim.x * blockDim.x) {
        const bool first = i < n0;
        const long long k = first ? i : i - n0;
        const float4 x = first ? c0[k] : c1[k];
        float4 h, l;
        h.x = tf32_round(x.x), l.x = tf32_round(x.x - h.x);
        h.y = tf32_round(x.y), l.y = tf32_round(x.y - h.y);
        h.z = tf32_round(x.z), l.z = tf32_round(x.z - h.z);
        h.w = tf32_round(x.w), l.w = tf32_round(x.w - h.w);
        (first ? a_hi : b_hi)[k] = h;
        (first ? a_lo : b_lo)[k] = l;
    }
}

// Pass 1: C_j from the column partials, R_i from the row partials (0 in
// the padding). Pass 2: bi_j, bj_i and bv_i.
template <int PASS>
__global__ void dual_reduce(const Params p, int B, long long* bj, float* bv, long long* bi) {
    const long long n_cols = (long long)B * p.L1p, n_rows = (long long)B * p.L0p;
    const int G = (p.L0 + 63) / 64;
    for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x; it < n_cols + n_rows;
         it += (long long)gridDim.x * blockDim.x) {
        if (it < n_cols) {
            const int b = (int)(it / p.L1p), j = (int)(it % p.L1p);
            if (j >= p.L1) {
                if (PASS == 1) p.C[it] = 0.f;
                continue;
            }
            const float2* q = p.part + (size_t)b * p.G2 * p.L1p + j;
            float v = neg_inf(), l = 0.f;
            int idx = 0x7fffffff;
            for (int g = 0; g < G; ++g) {
                const float2 x = q[(size_t)g * p.L1p];
                if (PASS == 1)
                    lse_merge(v, l, x.x, x.y);
                else
                    arg_merge(v, idx, x.x, __float_as_int(x.y));
            }
            if (PASS == 1)
                p.C[it] = v + log2f(l);
            else
                bi[(size_t)b * p.L1 + j] = idx;
        } else {
            const long long r = it - n_cols;
            const int b = (int)(r / p.L0p), i = (int)(r % p.L0p);
            if (i >= p.L0) {
                if (PASS == 1) p.R[r] = 0.f;
                continue;
            }
            const float2* q = p.rowpart + (size_t)b * MAX_SPLITS * p.L0p + i;
            float v = neg_inf(), l = 0.f;
            int idx = 0x7fffffff;
            for (int s = 0; s < p.splits; ++s) {
                const float2 x = q[(size_t)s * p.L0p];
                if (PASS == 1)
                    lse_merge(v, l, x.x, x.y);
                else
                    arg_merge(v, idx, x.x, __float_as_int(x.y));
            }
            if (PASS == 1) {
                p.R[r] = v + log2f(l);
            } else {
                const float Ri = p.R[r];
                float out;
                if (Ri < 0.5f * MASKED_T)
                    // every entry of the row masked: the plain version's
                    // product of two uniform softmaxes where the best column
                    // is wholly masked too (its score MASKED_T, else ~2x)
                    out = v > 1.5f * MASKED_T ? (1.f / (float)p.L0) * (1.f / (float)p.L1) : 0.f;
                else
                    out = exp2f(v - Ri);
                bj[(size_t)b * p.L0 + i] = idx;
                bv[(size_t)b * p.L0 + i] = out;
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the libcuda that the process has loaded
EncodeTiled encode_tiled() {
    static EncodeTiled fn = []() -> EncodeTiled {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
    }();
    return fn;
}

// Rank-3 map over (d, L, B) of a contiguous f32 tensor; a box is KC
// features of 128 rows, 128-byte swizzled, and rows past L read zeros.
CUresult operand_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int L) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)L * D * 4};
    const cuuint32_t box[3] = {KC, BM, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

size_t align_up(size_t n) { return (n + 1023) & ~size_t(1023); }

// The workspace's parts, in bytes from its start.
struct Layout {
    size_t a_hi, a_lo, b_hi, b_lo, part, rowpart, R, C, total;
    int L0p, L1p, G2, n_rb, n_ct;
};

Layout layout(int B, int L0, int L1) {
    Layout s;
    s.n_rb = (L0 + BM - 1) / BM;
    s.n_ct = (L1 + BN - 1) / BN;
    s.L0p = s.n_rb * BM;
    s.L1p = s.n_ct * BN;
    s.G2 = 2 * s.n_rb;
    const size_t op0 = align_up((size_t)B * L0 * D * 4), op1 = align_up((size_t)B * L1 * D * 4);
    size_t at = 0;
    s.a_hi = at, at += op0;
    s.a_lo = at, at += op0;
    s.b_hi = at, at += op1;
    s.b_lo = at, at += op1;
    s.part = at, at += align_up((size_t)B * s.G2 * s.L1p * 8);
    s.rowpart = at, at += align_up((size_t)B * MAX_SPLITS * s.L0p * 8);
    s.R = at, at += align_up((size_t)B * s.L0p * 4);
    s.C = at, at += align_up((size_t)B * s.L1p * 4);
    s.total = at;
    return s;
}

// Column splits a row block: the count of 1..MAX_SPLITS whose waves of
// one-block-an-SM leave the least idle, the fewest on a tie.
int pick_splits(int blocks, int n_ct, int sms) {
    int best = 1;
    double best_cost = 1e30;
    for (int s = 1; s <= MAX_SPLITS && s <= n_ct; ++s) {
        const double cost = (double)((blocks * s + sms - 1) / sms) / s;
        if (cost < best_cost - 1e-9) {
            best_cost = cost;
            best = s;
        }
    }
    return best;
}

int smem_bytes(int words) { return 1024 + RING_BYTES + SCRATCH_BYTES + BAR_BYTES + 4 * words; }

constexpr int MAX_DEVICES = 64;
// Per device, its SM count once its first launch has set the passes'
// shared-memory limit; 0 before.
std::atomic<int> device_sms[MAX_DEVICES];

// The current device's SM count. The first call on a device sets both
// passes' dynamic shared-memory limit, once, to what L1 = MAX_L1 needs
// with no column split (the most any launch asks for).
cudaError_t device_setup(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev >= 0 && dev < MAX_DEVICES;
    if (cached && (*sms = device_sms[dev].load(std::memory_order_acquire)) > 0) return cudaSuccess;
    const int limit = smem_bytes((MAX_L1 / BN + 1) * (BN / 32));
    if ((err = cudaFuncSetAttribute(dual_pass<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) !=
        cudaSuccess)
        return err;
    if ((err = cudaFuncSetAttribute(dual_pass<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) !=
        cudaSuccess)
        return err;
    if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if (cached) device_sms[dev].store(*sms, std::memory_order_release);
    return cudaSuccess;
}

}  // namespace

// Bytes of the workspace dual_softmax_fwd takes for (B, L0, L1).
extern "C" long long dual_softmax_workspace(int B, int L0, int L1) {
    return (long long)layout(B, L0, L1).total;
}

// c0 (B, L0, 256) and c1 (B, L1, 256) f32, mask0 (B, L0) and mask1
// (B, L1) bool bytes, all contiguous; work of dual_softmax_workspace
// bytes, 16-byte aligned; scale = log2(e) / (256 T). Writes bj (B, L0)
// int64, bv (B, L0) f32 and bi (B, L1) int64. Returns 0, a cudaError_t,
// 9000 for a shape it does not take, or 10000 + a CUresult of the
// tensor-map encoding.
extern "C" int dual_softmax_fwd(const void* c0, const void* c1, const void* mask0, const void* mask1,
                                void* work, void* bj, void* bv, void* bi, int B, int L0, int L1,
                                float scale, void* stream) {
    if (B < 1 || L0 < 1 || L1 < 1 || L1 > MAX_L1) return 9000;
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout lay = layout(B, L0, L1);
    uint8_t* w = static_cast<uint8_t*>(work);
    float* a_hi = reinterpret_cast<float*>(w + lay.a_hi);
    float* a_lo = reinterpret_cast<float*>(w + lay.a_lo);
    float* b_hi = reinterpret_cast<float*>(w + lay.b_hi);
    float* b_lo = reinterpret_cast<float*>(w + lay.b_lo);

    CUtensorMap maps[4];
    const void* ptrs[4] = {a_hi, a_lo, b_hi, b_lo};
    for (int k = 0; k < 4; ++k) {
        const CUresult res = operand_map(encode, &maps[k], ptrs[k], B, k < 2 ? L0 : L1);
        if (res != CUDA_SUCCESS) return 10000 + (int)res;
    }

    int sms = 0;
    cudaError_t err = device_setup(&sms);
    if (err != cudaSuccess) return (int)err;

    Params p;
    p.m0 = static_cast<const uint8_t*>(mask0);
    p.m1 = static_cast<const uint8_t*>(mask1);
    p.part = reinterpret_cast<float2*>(w + lay.part);
    p.rowpart = reinterpret_cast<float2*>(w + lay.rowpart);
    p.R = reinterpret_cast<float*>(w + lay.R);
    p.C = reinterpret_cast<float*>(w + lay.C);
    p.L0 = L0, p.L1 = L1, p.L0p = lay.L0p, p.L1p = lay.L1p, p.G2 = lay.G2;
    p.n_rb = lay.n_rb, p.n_ct = lay.n_ct;
    p.splits = pick_splits(lay.n_rb * B, lay.n_ct, sms);
    p.scale = scale;

    const long long n0 = (long long)B * L0 * D / 4, n1 = (long long)B * L1 * D / 4;
    split_tf32<<<4 * sms, 256, 0, s>>>(static_cast<const float4*>(c0), static_cast<const float4*>(c1),
                                       reinterpret_cast<float4*>(a_hi), reinterpret_cast<float4*>(a_lo),
                                       reinterpret_cast<float4*>(b_hi), reinterpret_cast<float4*>(b_lo), n0,
                                       n1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    // the largest split's mask words
    const int words = ((lay.n_ct + p.splits - 1) / p.splits + 1) * (BN / 32);
    const int smem = smem_bytes(words);
    const dim3 grid(lay.n_rb * p.splits, B);
    const int reduce_blocks = 2 * sms;
    dual_pass<1><<<grid, THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dual_reduce<1><<<reduce_blocks, 256, 0, s>>>(p, B, nullptr, nullptr, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dual_pass<2><<<grid, THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3], p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dual_reduce<2><<<reduce_blocks, 256, 0, s>>>(p, B, static_cast<long long*>(bj), static_cast<float*>(bv),
                                                 static_cast<long long*>(bi));
    return (int)cudaGetLastError();
}
