// Masked flash attention for Hopper (sm_90a), bf16 operands, f32 sums.
//
// Replaces the Pallas TPU kernel icepy4d_tpu/ops/attention.py::
// flash_attention (_flash_kernel), which every LightGlue self and cross
// block calls (icepy4d_tpu/models/lightglue.py:106-114). Contract, as
// on the TPU: q arrives pre-scaled by hd^-0.5 * log2(e); the kernel
// subtracts the row max of the logits, takes exp2, multiplies by the
// 0/1 key mask and emits PV and the softmax denominator; the caller
// normalises pv / max(den, 1e-20), so a row whose keys are all masked
// gives zeros. One deliberate difference: the row max is taken over
// the unmasked keys only. The TPU kernel takes it over all keys, and
// where a masked key's logit exceeds every valid one by more than ~66
// (log2 units) the denominator falls under the 1e-20 clamp and the row
// comes out scaled down; the bundled LightGlue reaches such gaps in its
// eighth layer's cross attention. Over the valid keys den >= 1 for
// every row with a valid key, and the output is the softmax the JAX
// package's XLA path computes.
//
// What bounds it on this card: tensor-core operations. At the main
// path's shape (B=16 tile pairs, H=4, Nq=Nk=4096, hd=64) it does
// 4*B*H*Nq*Nk*hd = 275 GFLOP against ~0.3 GB of operands, some 900
// FLOP per byte, so the bf16 tensor-core rate is the limit.
//
// What the design does about it: the (Nq, Nk) score matrix never
// leaves the chip. The TPU kernel keeps one (b, h)'s whole K/V resident
// (about 1 MB at Nk=4096), which does not fit a block's shared memory,
// so this kernel tiles the keys and keeps an online softmax (running
// max and running sum per query row). The offset subtracted is the
// running max rounded up to an integer: the rescale of earlier tiles is
// then an exact power of two, and each probability is rounded to bf16
// at the same scale as in the plain version, which subtracts the ceil
// of the final max, wherever in the key sequence the max turns up. One block of four warps owns 64
// query rows (16 per warp, held as mma A fragments in registers) and
// walks the keys in tiles of 64 staged through shared memory. Both
// products run on the tensor cores as mma.sync.m16n8k16 bf16 with f32
// accumulators; the probabilities go from the score accumulators
// straight into the A fragments of the PV product without touching
// shared memory. Any Nq and Nk: rows and keys past the end are zero
// filled, and keys past Nk count as masked.
// Shared memory is 3 x 64 x 72 bf16 + 64 f32 = 27.9 KB per block
// whatever Nk is. This is the simple first version: loads are
// synchronous (no cp.async/TMA pipeline) and it does not use wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim (ops/attention.py HEAD_DIM)
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int LD = HD + 8;    // smem row stride in bf16: 144 B, conflict-free fragment loads

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> packed bf16x2, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v;
    v.x = lo;
    v.y = hi;
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a (rows, HD) bf16 matrix -> smem, zero past `rows`
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows) {
    for (int i = threadIdx.x; i < 64 * (HD / 8); i += blockDim.x) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < rows)
            val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c * 8);
        *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
    }
}

__global__ void __launch_bounds__(THREADS) masked_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ kmask,
    float* __restrict__ pv, float* __restrict__ den, int H, int Nq, int Nk) {
    __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
    __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
    __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];
    __shared__ float Ms[BK];

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int q0 = blockIdx.x * BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;   // mma group row, thread in group

    const __nv_bfloat16* qg = q + (size_t)bh * Nq * HD;
    const __nv_bfloat16* kg = k + (size_t)bh * Nk * HD;
    const __nv_bfloat16* vg = v + (size_t)bh * Nk * HD;
    const float* mg = kmask + (size_t)b * Nk;

    load_tile(Qs, qg, q0, Nq);
    __syncthreads();
    // this warp's 16 query rows as A fragments, one per 16-wide slice of hd
    uint32_t qa[HD / 16][4];
    const __nv_bfloat16* qw = Qs + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        qa[kk][0] = ld32(qw + g * LD + kk * 16 + 2 * t);
        qa[kk][1] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t);
        qa[kk][2] = ld32(qw + g * LD + kk * 16 + 2 * t + 8);
        qa[kk][3] = ld32(qw + (g + 8) * LD + kk * 16 + 2 * t + 8);
    }

    // accumulators of rows g ([0], [1]) and g + 8 ([2], [3])
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    // offset subtracted so far: ceil of the running row max (-inf until a
    // valid key is seen)
    float m_off[2] = {neg_inf(), neg_inf()};
    float l_run[2] = {0.f, 0.f};   // this thread's share of the row sums

    for (int k0 = 0; k0 < Nk; k0 += BK) {
        __syncthreads();   // the previous tile is consumed
        load_tile(Ks, kg, k0, Nk);
        load_tile(Vs, vg, k0, Nk);
        for (int i = threadIdx.x; i < BK; i += blockDim.x)
            Ms[i] = k0 + i < Nk ? mg[k0 + i] : 0.f;
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16 x 8
        float s[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
            const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk)
                mma_bf16(s[j], qa[kk], ld32(kr + kk * 16 + 2 * t),
                         ld32(kr + kk * 16 + 2 * t + 8));
        }

        // masked keys and keys past Nk (mask 0) take no part in the max
        float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                if (Ms[j * 8 + 2 * t + e] == 0.f) {
                    s[j][e] = neg_inf();
                    s[j][2 + e] = neg_inf();
                }
                mx[0] = fmaxf(mx[0], s[j][e]);
                mx[1] = fmaxf(mx[1], s[j][2 + e]);
            }
        }
        float alpha[2], m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_off[r], ceilf(mx[r]));
            // -inf while every key so far is masked: exp2 then gives 0
            m_use[r] = m_new == neg_inf() ? 0.f : m_new;
            alpha[r] = exp2f(m_off[r] - m_use[r]);   // exact power of two
            m_off[r] = m_new;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float m = Ms[j * 8 + 2 * t + e];
                s[j][e] = exp2f(s[j][e] - m_use[0]) * m;
                s[j][2 + e] = exp2f(s[j][2 + e] - m_use[1]) * m;
                l_run[0] += s[j][e];
                l_run[1] += s[j][2 + e];
            }
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
        }

        // O += P V: the score tiles 2kk and 2kk+1 are the A fragment of
        // key slice kk; B fragments read V's column n*8+g
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_f32(s[2 * kk][0], s[2 * kk][1]),
                pack_f32(s[2 * kk][2], s[2 * kk][3]),
                pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
            };
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
                const __nv_bfloat16* vc = Vs + (kk * 16 + 2 * t) * LD + n * 8 + g;
                mma_bf16(o[n], pa, pack_bf16(vc[0], vc[LD]),
                         pack_bf16(vc[8 * LD], vc[9 * LD]));
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int r0 = q0 + warp * 16 + g;
    const int r1 = r0 + 8;
    float* pvb = pv + (size_t)bh * Nq * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (r0 < Nq)
            *reinterpret_cast<float2*>(pvb + (size_t)r0 * HD + c) = make_float2(o[n][0], o[n][1]);
        if (r1 < Nq)
            *reinterpret_cast<float2*>(pvb + (size_t)r1 * HD + c) = make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
        if (r0 < Nq) den[(size_t)bh * Nq + r0] = l_run[0];
        if (r1 < Nq) den[(size_t)bh * Nq + r1] = l_run[1];
    }
}

}  // namespace

// q (B,H,Nq,64), k/v (B,H,Nk,64) bf16 contiguous, q pre-scaled by
// 64^-0.5 * log2(e); kmask (B,Nk) f32 0/1. Writes pv (B,H,Nq,64) f32 and
// den (B,H,Nq) f32.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kmask, void* pv, void* den,
                                    int B, int H, int Nq, int Nk, void* stream) {
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    masked_attention_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(kmask),
        static_cast<float*>(pv), static_cast<float*>(den), H, Nq, Nk);
    return (int)cudaGetLastError();
}
