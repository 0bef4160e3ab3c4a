// Fused SuperPoint NMS + border zeroing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel icepy4d_tpu/ops/pallas_nms.py::
// fused_nms_border (_kernel, _nms_stripe, _pool2d). Computes exactly
// simple_nms (icepy4d_tpu/models/superpoint.py:186-205): a (2r+1)^2
// max-pool mask, then two suppression rounds, each pooling the mask,
// zeroing the suppressed scores, re-pooling them and OR-ing in the new
// maxima; then zeroes a `border`-wide frame against the original
// h0 x w0 extent (superpoint.py:407-412).
//
// What bounds it on this card: bytes. The function reads the heatmap
// once and writes it once (8 bytes per pixel) and does ~100 compares
// per pixel, far below the card's compute rate. As five separate
// pooling passes it would make about eleven round trips through device
// memory.
//
// What the design does about it: one block owns a TILE x TILE output
// tile and loads it with a 5r halo on every side (each of the five
// pools reaches r further), so the whole suppression chain runs in
// shared memory and only the final scores go back to device memory.
// Pools are separable (a row pass, then a column pass). Cells outside
// the map count as -inf, as reduce_window pads in simple_nms, and never
// hold a maximum. Values near the window's edge are wrong after each
// pool, but the error moves in by at most r per pool and never reaches
// the tile. Max and equality are exact in f32, so the result is
// bitwise equal to the plain PyTorch version (ops/nms.py).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;      // output tile side (ops/nms.py TILE)
constexpr int THREADS = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Row pass of a (2r+1) max over an S x S plane: dst[y][x] = max over
// src[y][x-r .. x+r], clipped to the plane.
__device__ __forceinline__ void row_max(const float* src, float* dst, int S, int r) {
    for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
        const int y = i / S, x = i - y * S;
        const int lo = max(x - r, 0), hi = min(x + r, S - 1);
        const float* row = src + y * S;
        float m = row[lo];
        for (int j = lo + 1; j <= hi; ++j) m = fmaxf(m, row[j]);
        dst[i] = m;
    }
}

__device__ __forceinline__ void row_max_u8(const unsigned char* src, float* dst, int S, int r) {
    for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
        const int y = i / S, x = i - y * S;
        const int lo = max(x - r, 0), hi = min(x + r, S - 1);
        const unsigned char* row = src + y * S;
        unsigned char m = 0;
        for (int j = lo; j <= hi; ++j) m |= row[j];
        dst[i] = m ? 1.f : 0.f;
    }
}

// Column max at cell (y, x) of a row-pooled plane.
__device__ __forceinline__ float col_max(const float* src, int S, int r, int y, int x) {
    const int lo = max(y - r, 0), hi = min(y + r, S - 1);
    float m = src[lo * S + x];
    for (int j = lo + 1; j <= hi; ++j) m = fmaxf(m, src[j * S + x]);
    return m;
}

__global__ void __launch_bounds__(THREADS) nms_border_kernel(
    const float* __restrict__ heat, float* __restrict__ out,
    int H, int W, int r, int border, int h0, int w0) {
    extern __shared__ float smem[];
    const int halo = 5 * r;
    const int S = TILE + 2 * halo;
    const int n = S * S;
    float* X = smem;            // scores; -inf outside the map
    float* T = X + n;           // row-pass results
    float* Y = T + n;           // suppressed scores
    unsigned char* M = reinterpret_cast<unsigned char*>(Y + n);  // max mask
    unsigned char* P = M + n;   // suppression mask

    const int gy0 = blockIdx.y * TILE - halo;
    const int gx0 = blockIdx.x * TILE - halo;
    const float* src = heat + (size_t)blockIdx.z * H * W;

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int gy = gy0 + i / S, gx = gx0 + i % S;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        X[i] = in ? src[(size_t)gy * W + gx] : neg_inf();
    }
    __syncthreads();

    // max_mask = scores == max_pool(scores), in-map cells only
    row_max(X, T, S, r);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int y = i / S, x = i - y * S;
        const int gy = gy0 + y, gx = gx0 + x;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        M[i] = in && X[i] == col_max(T, S, r, y, x);
    }
    __syncthreads();

    for (int round = 0; round < 2; ++round) {
        // supp = max_pool(max_mask) > 0; supp_scores = supp ? 0 : scores
        row_max_u8(M, T, S, r);
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int y = i / S, x = i - y * S;
            const int gy = gy0 + y, gx = gx0 + x;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const bool supp = col_max(T, S, r, y, x) > 0.f;
            P[i] = supp;
            Y[i] = in ? (supp ? 0.f : X[i]) : neg_inf();
        }
        __syncthreads();
        // max_mask |= (supp_scores == max_pool(supp_scores)) & ~supp
        row_max(Y, T, S, r);
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int y = i / S, x = i - y * S;
            const int gy = gy0 + y, gx = gx0 + x;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
            if (in && !P[i] && Y[i] == col_max(T, S, r, y, x)) M[i] = 1;
        }
        __syncthreads();
    }

    float* dst = out + (size_t)blockIdx.z * H * W;
    for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
        const int ty = i / TILE, tx = i - ty * TILE;
        const int gy = blockIdx.y * TILE + ty, gx = blockIdx.x * TILE + tx;
        if (gy >= H || gx >= W) continue;
        const int c = (ty + halo) * S + tx + halo;
        const bool keep = gy >= border && gy < h0 - border &&
                          gx >= border && gx < w0 - border;
        dst[(size_t)gy * W + gx] = (keep && M[c]) ? X[c] : 0.f;
    }
}

}  // namespace

// heat, out: (B, H, W) float32 contiguous on the current device.
extern "C" int fused_nms_border(const void* heat, void* out, int B, int H, int W,
                                int r, int border, int h0, int w0, void* stream) {
    const int S = TILE + 10 * r;
    const size_t smem = (size_t)S * S * (3 * sizeof(float) + 2);
    cudaError_t err = cudaFuncSetAttribute(
        nms_border_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    nms_border_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(heat), static_cast<float*>(out), H, W, r, border, h0, w0);
    return (int)cudaGetLastError();
}
