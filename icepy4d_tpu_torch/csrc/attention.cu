// Masked flash attention for Hopper (sm_90a): TMA loads, wgmma products,
// bf16 operands, f32 sums.
//
// Replaces the Pallas TPU kernel icepy4d_tpu/ops/attention.py::
// flash_attention (_flash_kernel), which every LightGlue self and cross
// block calls (icepy4d_tpu/models/lightglue.py:106-114). What it
// computes, as on the TPU: q scaled by hd^-0.5 * log2(e) and rounded to
// bf16, S = q k^T, exp2 after subtracting a row offset, masked keys
// dropped, PV and the softmax denominator in f32, and pv / max(den,
// 1e-20) as the output, so a row whose keys are all masked gives zeros.
// One deliberate difference: the row max is taken over the unmasked
// keys only. The TPU kernel takes it over all keys, and where a masked
// key's logit exceeds every valid one by more than ~66 (log2 units) the
// denominator falls under the 1e-20 clamp and the row comes out scaled
// down; the bundled LightGlue reaches such gaps in its eighth layer's
// cross attention. Over the valid keys den >= 1 for every row with a
// valid key, and the output is the softmax the JAX package's XLA path
// computes.
//
// What bounds it on this card: tensor-core operations, then the
// exponentials. At the main path's shape (B=16 tile pairs, H=4,
// Nq=Nk=4096, hd=64) it does 4*B*H*Nq*Nk*hd = 275 GFLOP against ~0.3 GB
// of operands, some 900 FLOP per byte, so the bf16 tensor-core rate is
// the limit (0.278 ms); the 1.07e9 exp2 at 16 per clock and SM take
// about as long again unless they run under the products.
//
// What the design does about it:
//  - One block owns 128 query rows of one (b, h) and walks the keys in
//    tiles of 128. Three warpgroups: two consumers of 64 query rows
//    each, and a producer whose one elected thread keeps TMA loads
//    (cp.async.bulk.tensor, 128-byte swizzle) of K and V tiles in
//    flight through a ring of STAGES buffers, with an mbarrier per
//    buffer and operand for "full" and one per buffer for "empty".
//    setmaxnreg hands the producer's registers to the consumers.
//  - Both products are wgmma.mma_async, bf16 -> f32. S = Q K^T reads Q
//    and K from shared memory by descriptor (K-major, 128-byte
//    swizzle). The probabilities go from the accumulator registers
//    straight into the A operand of the PV product, and V is read as
//    the transposed (MN-major) B operand, so nothing is transposed or
//    staged. PV of one tile and S of the next are started back to back
//    and waited for together, and the two warpgroups take turns at
//    starting theirs (a named barrier each), so that one's softmax runs while
//    the other's products are on the tensor cores.
//  - The tensor maps are rank 4 over (hd, n, h, b) with the tensors'
//    own strides, so LightGlue's (B, N, H, hd) head views are read as
//    they lie, a tile never crosses into the next head, and keys past
//    Nk arrive as zeros. Q is staged by the consumers themselves: read
//    with its strides, scaled in f32, rounded to bf16 and written in the
//    swizzled layout. The output is divided by max(den, 1e-20) and
//    stored once, in the caller's type and strides.
//  - The key mask (bool bytes) is packed once per block into one bit
//    per key. A tile whose bits are all 1 skips the masking, a tile
//    whose bits are all 0 is skipped whole (it adds nothing to max, sum
//    or PV), and a mixed tile sets its masked scores to -inf once.
//  - The online softmax rounds as the plain version: the offset subtracted
//    is the running max over unmasked keys rounded up to an integer, so
//    the rescale of earlier tiles is an exact power of two and each
//    probability is rounded to bf16 at the same scale as in the plain
//    version, wherever in the key sequence the max turns up.
// Any Nq, Nk >= 1. Shared memory per block: 16 KB of Q, STAGES x 32 KB
// of K and V, Nk / 8 bytes of mask bits and the barriers (113.6 KB at
// Nk = 4096); one block of 384 threads per SM.

#include <cuda.h>   // CUtensorMap and its enums; libcuda's entry is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim (ops/attention.py HEAD_DIM)
constexpr int BQ = 128;         // query rows per block, 64 per consumer warpgroup
constexpr int BK = 128;         // keys per tile
constexpr int STAGES = 3;       // K/V buffers in the ring
constexpr int WG = 128;         // threads of a warpgroup
constexpr int THREADS = 3 * WG; // two consumers and the producer
constexpr int CONSUMER_WARPS = 8;
constexpr int TILE_BYTES = BK * HD * 2;   // one K or V tile, 16 KB
constexpr int Q_BYTES = BQ * HD * 2;
constexpr int ROW_BYTES = HD * 2;         // 128: one swizzle row
// bytes of shared memory before the mask bits, and the barriers' place
constexpr int RING_BYTES = Q_BYTES + STAGES * 2 * TILE_BYTES;
constexpr int BAR_BYTES = 128;            // 3 * STAGES barriers: full K, full V, empty
static_assert(3 * STAGES * 8 <= BAR_BYTES, "room for the barriers");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// Wait until the barrier has left the phase of this parity. A wait that
// lasts seconds is a fault of the pipeline: trap, so that the launch
// ends in an error and not in a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try(bar, parity))
        if (clock64() - t0 > 4000000000LL) __trap();
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile whose rows are 128 bytes,
// 128-byte swizzled, 1024-byte aligned: 8-row groups 1024 bytes apart
// (the stride offset); the leading offset is not used at these widths.
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define F8(d, i)                                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
        "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = or += A (64 x 16 bf16, shared, K-major) B^T (128 x 16 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) B (16 x 64 bf16, shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// two floats -> packed bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Params {
    const __nv_bfloat16* q;
    const uint8_t* kmask;   // (B, Nk) bool bytes
    void* out;
    long long q_sb, q_sh, q_sn;   // strides in elements; the last dim's is 1
    long long o_sb, o_sh, o_sn;
    int H, Nq, Nk;
    int out_f32;            // the output's type: f32 if set, else bf16
    float q_scale;
};

// Online-softmax step of one 64 x 128 score tile held as wgmma
// accumulators: thread (warp w, lane 4g + t) holds rows 16w + g ([4j],
// [4j+1]) and 16w + g + 8 ([4j+2], [4j+3]) at columns 8j + 2t, 8j + 2t + 1.
// Turns the scores into f32 probabilities in place, updates the offsets
// and the running sums, and leaves in `alpha` the factor the output
// accumulators take before this tile's PV product is added.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&alpha)[2], float (&m_off)[2],
                                             float (&l_run)[2], const uint32_t* bits, int t) {
    if (MASKED) {
        // masked keys and keys past Nk (bit 0) take no part in the max
        // and give exp2(-inf) = 0
#pragma unroll
        for (int w = 0; w < BK / 32; ++w) {
            const uint32_t m = bits[w] >> (2 * t);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * w + jj;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (!((m >> (8 * jj + e)) & 1u)) {
                        s[4 * j + e] = neg_inf();
                        s[4 * j + 2 + e] = neg_inf();
                    }
            }
        }
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_off[r], ceilf(mx[r]));
        // -inf while every key so far is masked: exp2 then gives 0
        m_use[r] = m_new == neg_inf() ? 0.f : m_new;
        alpha[r] = ex2(m_off[r] - m_use[r]);   // exact power of two
        m_off[r] = m_new;
    }
    // four partial sums per row keep the adds independent
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(s[4 * j] - m_use[0]);
        s[4 * j + 1] = ex2(s[4 * j + 1] - m_use[0]);
        s[4 * j + 2] = ex2(s[4 * j + 2] - m_use[1]);
        s[4 * j + 3] = ex2(s[4 * j + 3] - m_use[1]);
        part[0][j & 3] += s[4 * j] + s[4 * j + 1];
        part[1][j & 3] += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
        l_run[r] = l_run[r] * alpha[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

// The f32 probabilities of a tile, rounded to bf16, as the A fragments of
// the PV product: key slice kk takes the column blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_probabilities(const float (&s)[64], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        pa[j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
}

__global__ void __launch_bounds__(THREADS, 1) masked_attention_kernel(
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v, const Params p) {
    extern __shared__ uint8_t smem_raw[];
    // the swizzled tiles need 1024-byte alignment
    uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t q_s = smem_u32(smem);
    const uint32_t ring_s = q_s + Q_BYTES;                 // stage st: K at 2 st, V at 2 st + 1
    const uint32_t bar_s = q_s + RING_BYTES;               // full K [st], full V [st], empty [st]
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + RING_BYTES + BAR_BYTES);

    const int n_tiles = (p.Nk + BK - 1) / BK;
    const int bh = blockIdx.y;
    const int b = bh / p.H, h = bh % p.H;
    const int q0 = blockIdx.x * BQ;
    const int wg = threadIdx.x / WG;

    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(bar_s + 8 * st, 1);
            mbar_init(bar_s + 8 * (STAGES + st), 1);
            mbar_init(bar_s + 8 * (2 * STAGES + st), CONSUMER_WARPS);
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
            for (int it = 0; it < n_tiles; ++it) {
                mbar_wait(bar_s + 8 * (2 * STAGES + st), ph ^ 1);
                const uint32_t full_k = bar_s + 8 * st, full_v = bar_s + 8 * (STAGES + st);
                mbar_expect_tx(full_k, TILE_BYTES);
                tma_load_4d(ring_s + (2 * st) * TILE_BYTES, &map_k, full_k, 0, it * BK, h, b);
                mbar_expect_tx(full_v, TILE_BYTES);
                tma_load_4d(ring_s + (2 * st + 1) * TILE_BYTES, &map_v, full_v, 0, it * BK, h, b);
                if (++st == STAGES) {
                    st = 0;
                    ph ^= 1;
                }
            }
        }
    } else {
        // ---- consumers ------------------------------------------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int tid = threadIdx.x % WG;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;

        // the key mask of this batch row as one bit per key, 0 past Nk
        {
            const uint8_t* mrow = p.kmask + (size_t)b * p.Nk;
            const int cw = threadIdx.x >> 5;   // 0..7
#pragma unroll 4
            for (int w = cw; w < 4 * n_tiles; w += CONSUMER_WARPS) {
                const int key = 32 * w + lane;
                const bool keep = key < p.Nk && mrow[key] != 0;
                const uint32_t word = __ballot_sync(0xffffffffu, keep);
                if (lane == 0) bits[w] = word;
            }
        }
        // this warpgroup's 64 query rows: scaled in f32, rounded to bf16,
        // stored 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8))
        {
            const __nv_bfloat16* qg = p.q + (size_t)b * p.q_sb + (size_t)h * p.q_sh;
#pragma unroll
            for (int i = 0; i < 64 * 8 / WG; ++i) {
                const int c = i * WG + tid;
                const int r = wg * 64 + (c >> 3), ch = c & 7;
                uint4 val = make_uint4(0u, 0u, 0u, 0u);
                if (q0 + r < p.Nq) {
                    val = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * p.q_sn + ch * 8);
                    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float2 f = __bfloat1622float2(h2[e]);
                        h2[e] = __floats2bfloat162_rn(f.x * p.q_scale, f.y * p.q_scale);
                    }
                }
                *reinterpret_cast<uint4*>(smem + r * ROW_BYTES + ((ch ^ (r & 7)) << 4)) = val;
            }
        }
        // the wgmma reads (async proxy) must see these writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 256;\n" ::: "memory");

        const uint64_t desc_q = smem_desc(q_s + wg * 64 * ROW_BYTES);
        float o[32], s[64];
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        // offset subtracted so far: ceil of the running row max (-inf
        // until a valid key is seen); this thread's share of the row sums
        float m_off[2] = {neg_inf(), neg_inf()};
        float l_run[2] = {0.f, 0.f};

        int it = 0, st = 0;
        uint32_t ph = 0;
        auto full_k = [&](int stage) { return bar_s + 8 * stage; };
        auto full_v = [&](int stage) { return bar_s + 8 * (STAGES + stage); };
        auto release = [&](int stage) {
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_s + 8 * (2 * STAGES + stage));
        };
        auto step = [&]() {
            ++it;
            if (++st == STAGES) {
                st = 0;
                ph ^= 1;
            }
        };
        auto tile_bits = [&](int tile, uint32_t& any, uint32_t& all) {
            const uint4 w = *reinterpret_cast<const uint4*>(bits + 4 * tile);
            any = w.x | w.y | w.z | w.w;
            all = w.x & w.y & w.z & w.w;
        };
        // hand back, unread, every tile from `it` on whose keys are all masked
        auto skip_masked = [&]() {
            while (it < n_tiles) {
                uint32_t any, all;
                tile_bits(it, any, all);
                if (any) break;
                mbar_wait(full_k(st), ph);
                mbar_wait(full_v(st), ph);
                release(st);
                step();
            }
        };
        auto start_s = [&]() {
            mbar_wait(full_k(st), ph);
            const uint64_t desc_k = smem_desc(ring_s + (2 * st) * TILE_BYTES);
            fence_regs(s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)   // 32 bytes along the row per step
                wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk != 0);
            wgmma_commit();
        };
        auto softmax = [&](float (&alpha)[2]) {
            uint32_t any, all;
            tile_bits(it, any, all);
            if (all == 0xffffffffu)
                softmax_tile<false>(s, alpha, m_off, l_run, bits + 4 * it, t);
            else
                softmax_tile<true>(s, alpha, m_off, l_run, bits + 4 * it, t);
        };

        auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
                o[4 * n] *= alpha[0];
                o[4 * n + 1] *= alpha[0];
                o[4 * n + 2] *= alpha[1];
                o[4 * n + 3] *= alpha[1];
            }
        };
        auto start_pv = [&](int stage, uint32_t phase) {
            mbar_wait(full_v(stage), phase);
            const uint64_t desc_v = smem_desc(ring_s + (2 * stage + 1) * TILE_BYTES);
            fence_regs(o);
            fence_regs(pa);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)   // 16 keys = 2048 bytes per step
                wgmma_m64n64k16_rs(o, pa[kk], desc_v + (2048 >> 4) * kk);
            wgmma_commit();
        };
        // The two warpgroups take turns at starting their products: a
        // warpgroup waits for its turn (named barrier 2 + wg), starts
        // them, and passes the turn on, so that one's softmax runs while the other's
        // products are on the tensor cores. Both walk the same tiles, so
        // every wait meets its arrival.
        auto turn_wait = [&]() {
            if (wg == 0)
                asm volatile("bar.sync 2, 256;\n" ::: "memory");
            else
                asm volatile("bar.sync 3, 256;\n" ::: "memory");
        };
        auto turn_pass = [&]() {
            if (wg == 0)
                asm volatile("bar.arrive 3, 256;\n" ::: "memory");
            else
                asm volatile("bar.arrive 2, 256;\n" ::: "memory");
        };
        auto next_is_live = [&]() {
            if (it + 1 >= n_tiles) return false;
            uint32_t any, all;
            tile_bits(it + 1, any, all);
            return any != 0;
        };

        // Every branch below is taken by the whole block alike, and no
        // wgmma is started under a condition inside a loop body: the
        // assembler serialises every wgmma of the kernel when it cannot
        // tell which groups are in flight at a wait.
        if (wg == 1) turn_pass();   // warpgroup 0 goes first
        skip_masked();
        while (it < n_tiles) {
            // a tile with nothing in flight before it: its scores, softmax
            // and probabilities one after the other
            float alpha[2];
            turn_wait();
            start_s();
            turn_pass();
            wgmma_wait<0>();
            fence_regs(s);
            softmax(alpha);
            pack_probabilities(s, pa);
            int cur_st = st;
            uint32_t cur_ph = ph;
            // then tile after tile: the next tile's S and this tile's PV
            // are started together, and the next tile's softmax runs while
            // PV is still on the tensor cores
            while (next_is_live()) {
                step();
                rescale(alpha);
                turn_wait();
                start_s();
                start_pv(cur_st, cur_ph);
                turn_pass();
                wgmma_wait<1>();   // the next tile's S
                fence_regs(s);
                softmax(alpha);
                wgmma_wait<0>();   // this tile's PV
                fence_regs(o);
                fence_regs(pa);
                release(cur_st);
                pack_probabilities(s, pa);
                cur_st = st;
                cur_ph = ph;
            }
            // the next tile is fully masked or there is none
            rescale(alpha);
            turn_wait();
            start_pv(cur_st, cur_ph);
            turn_pass();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            release(cur_st);
            step();
            skip_masked();
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
            l_run[r] = fmaxf(l_run[r], 1e-20f);
        }
        const int r0 = q0 + wg * 64 + warp * 16 + g;
        const int r1 = r0 + 8;
        const size_t base = (size_t)b * p.o_sb + (size_t)h * p.o_sh + 2 * t;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            const float a0 = o[4 * n] / l_run[0], a1 = o[4 * n + 1] / l_run[0];
            const float a2 = o[4 * n + 2] / l_run[1], a3 = o[4 * n + 3] / l_run[1];
            const size_t e0 = base + (size_t)r0 * p.o_sn + 8 * n;
            const size_t e1 = base + (size_t)r1 * p.o_sn + 8 * n;
            if (p.out_f32) {
                float* out = static_cast<float*>(p.out);
                if (r0 < p.Nq) *reinterpret_cast<float2*>(out + e0) = make_float2(a0, a1);
                if (r1 < p.Nq) *reinterpret_cast<float2*>(out + e1) = make_float2(a2, a3);
            } else {
                __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
                if (r0 < p.Nq) *reinterpret_cast<__nv_bfloat162*>(out + e0) = __floats2bfloat162_rn(a0, a1);
                if (r1 < p.Nq) *reinterpret_cast<__nv_bfloat162*>(out + e1) = __floats2bfloat162_rn(a2, a3);
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

// Rank-4 map over (hd, n, h, b) of a bf16 tensor with strides in
// elements; a box is BK keys of one head, 128-byte swizzled, and reads
// past n give zeros.
CUresult kv_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int H, int N,
                long long sb, long long sh, long long sn) {
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {HD, BK, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Bytes of dynamic shared memory a launch with Nk keys asks for.
int smem_bytes(int Nk) {
    const int n_tiles = (Nk + BK - 1) / BK;
    return 1024 + RING_BYTES + BAR_BYTES + n_tiles * (BK / 8);
}

}  // namespace

// q (B,H,Nq,64), k/v (B,H,Nk,64) bf16 and out (B,H,Nq,64) bf16 or f32
// (out_f32), each with strides in elements (batch, head, row; the last
// dim's stride is 1, every other a multiple of 8, base pointers 16-byte
// aligned); kmask (B,Nk) bool bytes, contiguous. q is scaled by q_scale
// in f32 and rounded to bf16 in the kernel. Returns 0, a cudaError_t, or
// 10000 + a CUresult of the tensor-map encoding.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v, const void* kmask,
                                    void* out, int B, int H, int Nq, int Nk, long long q_sb,
                                    long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                                    long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                                    long long o_sb, long long o_sh, long long o_sn, float q_scale,
                                    int out_f32, void* stream) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
    CUtensorMap map_k, map_v;
    CUresult res = kv_map(encode, &map_k, k, B, H, Nk, k_sb, k_sh, k_sn);
    if (res == CUDA_SUCCESS) res = kv_map(encode, &map_v, v, B, H, Nk, v_sb, v_sh, v_sn);
    if (res != CUDA_SUCCESS) return 10000 + (int)res;

    Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.kmask = static_cast<const uint8_t*>(kmask);
    p.out = out;
    p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
    p.o_sb = o_sb, p.o_sh = o_sh, p.o_sn = o_sn;
    p.H = H, p.Nq = Nq, p.Nk = Nk;
    p.out_f32 = out_f32;
    p.q_scale = q_scale;

    const int smem = smem_bytes(Nk);
    cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    masked_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(map_k, map_v, p);
    return (int)cudaGetLastError();
}
