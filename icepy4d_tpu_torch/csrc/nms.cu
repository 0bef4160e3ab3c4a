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
// once and writes it once (8 bytes per pixel); its five pools are ~60
// compares per pixel, far below the card's f32 rate. What a kernel pays
// beyond the bytes is the halo (each pool reaches r further, 5r in all),
// shared-memory traffic and instruction issue.
//
// What the design does about it:
//
// * A block owns a WIN_H x WIN_W window of the map (WIN_W a whole
//   number of 32-pixel words) and writes its centre, the window less a
//   5r halo on every side: 64 x 152 pixels at r = 4. The halo costs 2.1x
//   at the load where a 32 x 32 tile paid 5.1x.
// * Pool k is computed only on the rows the next one needs: rows
//   [k r, WIN_H - k r). A stage therefore reads only rows the stage
//   before it wrote. Along x every stage runs the whole window width
//   and reads past the window's edge as -inf (scores) or 0 (masks); the
//   error this makes moves in by r per pool and stops short of the
//   centre. Cells outside the map hold -inf and their mask bits are
//   cleared, as reduce_window pads in simple_nms.
// * A score pool is a column pass, then a row pass. In both a thread
//   keeps a run of outputs and their 2r neighbours in registers and
//   forms the (2r+1)-wide max in log steps (windows of 2, 4, 8, then
//   the rest): about 5 fmaxf and 2.5 shared-memory words per cell and
//   pass at r = 4. A thread stays on one column (column pass, runs of up
//   to 24 rows, conflict free) or one run of 8 columns (row pass), so
//   its index arithmetic and its in-map and border bits are computed
//   once per tile. The row pass reads 16-byte vectors, its halo from
//   columns of -inf beside the window without a test, even and odd
//   lanes on neighbouring rows of a plane with an odd number of vectors
//   per row, so that a quarter warp's eight vectors fall into eight
//   different bank groups.
// * The max mask and the suppression mask are bits: the thread that
//   owns a run of 8 pixels writes them as one byte, 4 bytes are one
//   32-pixel word. The two mask pools are a vertical OR of 2r+1 words
//   and funnel shifts across neighbouring words. The suppressed scores
//   (0.0 where suppressed, the score elsewhere) are never stored: the
//   next column pass forms them from the score and the bit.
// * The radius is a template parameter, every side a constexpr: no
//   integer divide by a run-time value inside a pass. Ten block-wide
//   barriers per tile.
// * As many blocks as the card holds at once (one per SM: the planes
//   take 168 KB) walk over the tiles. Loads and stores are 16-byte
//   vectors, coalesced along x, where W, the pointers and 5r are
//   multiples of 4 pixels; then a thread fetches the next tile's window
//   into registers before it starts this tile's pools, so the load's
//   latency is hidden behind them. Elsewhere the accesses are coalesced
//   4-byte ones. The result is staged through shared memory so that the
//   store runs along x.
//
// Max and equality are exact in f32 in any order, so the result is
// bitwise equal to the plain PyTorch version (ops/nms.py) for every
// finite input.

#include <cuda_runtime.h>

// The block's geometry; scripts/time_torch_kernels.py --variants builds
// the source with other values to time them beside these.
#ifndef NMS_WIN_H
#define NMS_WIN_H 104
#endif
#ifndef NMS_WIN_WORDS
#define NMS_WIN_WORDS 6
#endif
#ifndef NMS_THREADS
#define NMS_THREADS 384
#endif
#ifndef NMS_MIN_BLOCKS
#define NMS_MIN_BLOCKS 1
#endif

namespace {

// the constants below are mirrored in ops/nms.py
constexpr int WIN_H = NMS_WIN_H;            // window rows (even)
constexpr int WIN_WORDS = NMS_WIN_WORDS;    // window width in 32-pixel words
constexpr int THREADS = NMS_THREADS;
constexpr int WIN_W = 32 * WIN_WORDS;
constexpr int RUN = 8;                      // outputs a thread keeps in registers
constexpr int COL_RUN_MAX = 24;             // ... at most, in a column pass
constexpr int OCTETS = WIN_W / RUN;
constexpr int MAX_RADIUS_CAP = 9;

// A score plane's row: PAD columns that stay -inf, the window's WIN_W
// columns, PAD + 4 more of -inf. The row pass reads its halo from the
// pads without a test; the odd number of 16-byte vectors per row keeps
// its loads free of bank conflicts.
__host__ __device__ constexpr int pad_cols(int r) { return 4 * ((r + 3) / 4); }
__host__ __device__ constexpr int pitch(int r) { return WIN_W + 2 * pad_cols(r) + 4; }
__host__ __device__ constexpr size_t smem_bytes(int r) {
    return (size_t)WIN_H * (2 * pitch(r) * sizeof(float) + 2 * WIN_WORDS * sizeof(unsigned));
}

static_assert(WIN_H % 2 == 0, "the row pass takes rows in pairs");
static_assert(THREADS % WIN_W == 0, "a column pass keeps a thread on one column");
static_assert(THREADS % (2 * OCTETS) == 0, "a row pass keeps a thread on one run of columns");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// n-bit mask of the i in [0, n) with lo <= base + i < hi
__device__ __forceinline__ unsigned bits_in_range(int base, int lo, int hi, int n) {
    const int a = min(max(lo - base, 0), n), b = min(max(hi - base, 0), n);
    const unsigned ma = a >= 32 ? 0xffffffffu : (1u << a) - 1u;
    const unsigned mb = b >= 32 ? 0xffffffffu : (1u << b) - 1u;
    return mb & ~ma;
}

template <int S, int LEN>
__device__ __forceinline__ void max_step(float* a) {
#pragma unroll
    for (int i = 0; i + 2 * S - 1 < LEN; ++i) a[i] = fmaxf(a[i], a[i + S]);
}

__host__ __device__ constexpr int pow2_floor(int k) { return k < 2 ? 1 : 2 * pow2_floor(k / 2); }

// a[0 .. N + K - 2] in; a[i] = max(a[i .. i + K - 1]) for i < N out.
// Windows of 2, 4, ... P (the largest power of two <= K), then two
// overlapping windows of P make one of K.
template <int K, int N>
__device__ __forceinline__ void sliding_max(float* a) {
    constexpr int LEN = N + K - 1;
    constexpr int P = pow2_floor(K);
    if constexpr (P > 1) max_step<1, LEN>(a);
    if constexpr (P > 2) max_step<2, LEN>(a);
    if constexpr (P > 4) max_step<4, LEN>(a);
    if constexpr (P > 8) max_step<8, LEN>(a);
    if constexpr (P > 16) max_step<16, LEN>(a);
    static_assert(P <= 32, "radius too large");
    if constexpr (K > P) {
#pragma unroll
        for (int i = 0; i < N; ++i) a[i] = fmaxf(a[i], a[i + K - P]);
    }
}

// Rows a thread takes at a time in a column pass over `nrows` rows: the
// threads on one column (THREADS / WIN_W of them) get equally many runs
// of at most COL_RUN_MAX rows.
__host__ __device__ constexpr int col_run(int nrows) {
    int nseg = THREADS / WIN_W;
    while ((nrows + nseg - 1) / nseg > COL_RUN_MAX) nseg += THREADS / WIN_W;
    const int run = (nrows + nseg - 1) / nseg;
    return run < RUN ? RUN : run;
}

// Column pass of the pool of stage K_STAGE: T[y][x] = max over rows
// y-R .. y+R of the scores (SUPPRESSED: 0.0 where the S bit is set) for
// rows [K_STAGE R, WIN_H - K_STAGE R). A thread stays on one column and
// takes runs of CRUN rows; the last run of a region overlaps the one
// before it.
template <int R, int K_STAGE, bool SUPPRESSED>
__device__ __forceinline__ void column_pass(const float* X, float* T, const unsigned* S) {
    constexpr int PITCH = pitch(R);
    constexpr int ROW_LO = K_STAGE * R;
    constexpr int NROWS = WIN_H - 2 * ROW_LO;
    constexpr int CRUN = col_run(NROWS);
    constexpr int NSEG = (NROWS + CRUN - 1) / CRUN;
    static_assert(NROWS >= CRUN, "window too low for this radius");
    const int x = threadIdx.x % WIN_W;
    const unsigned bit = 1u << (x & 31);
    X += pad_cols(R) + x;
    T += pad_cols(R) + x;
    S += x >> 5;
    for (int seg = threadIdx.x / WIN_W; seg < NSEG; seg += THREADS / WIN_W) {
        const int y0 = ROW_LO + min(seg * CRUN, NROWS - CRUN);
        float a[CRUN + 2 * R];
#pragma unroll
        for (int j = 0; j < CRUN + 2 * R; ++j) {
            const int y = y0 - R + j;
            float v = X[y * PITCH];
            if (SUPPRESSED && (S[y * WIN_WORDS] & bit)) v = 0.f;
            a[j] = v;
        }
        sliding_max<2 * R + 1, CRUN>(a);
#pragma unroll
        for (int i = 0; i < CRUN; ++i) T[(y0 + i) * PITCH] = a[i];
    }
}

// Row pass of the pool of stage K_STAGE and the update of the max mask,
// for rows [K_STAGE R, WIN_H - K_STAGE R). A thread stays on one run of
// RUN columns, even and odd lanes on neighbouring rows. `in_cols` and
// `keep_cols` are the run's columns inside the map and inside the border
// frame, as bits.
//   ROUND 0: M  = (score == pool) in the map
//   ROUND 1: M |= (score == pool) & ~S in the map
//   ROUND 2: as 1, then the run's result (score where M is set and the
//            pixel is inside the border frame, else 0.0) replaces the
//            scores in X.
template <int R, int K_STAGE, int ROUND>
__device__ __forceinline__ void row_pass(float* X, const float* T, unsigned char* M,
                                         const unsigned char* S, int gy0, int H,
                                         int border, int h0, unsigned in_cols,
                                         unsigned keep_cols) {
    constexpr int PITCH = pitch(R);
    constexpr int ROW_LO = K_STAGE * R;
    constexpr int NROWS = WIN_H - 2 * ROW_LO;
    constexpr int NQ = 2 + 2 * ((R + 3) / 4);  // 16-byte vectors of a run and its halo
    const int rem = threadIdx.x % (2 * OCTETS);
    const int o = rem >> 1;
    // the run's first halo vector in T; its own columns in X
    T += RUN * o;
    X += pad_cols(R) + RUN * o;
    M += o;
    S += o;
    for (int y = ROW_LO + 2 * (threadIdx.x / (2 * OCTETS)) + (rem & 1); y < ROW_LO + NROWS;
         y += 2 * (THREADS / (2 * OCTETS))) {
        float a[4 * NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(T + y * PITCH + 4 * q);
            a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
        }
        float* p = a + pad_cols(R) - R;
        sliding_max<2 * R + 1, RUN>(p);

        float* xrow = X + y * PITCH;
        const float4 x0 = *reinterpret_cast<const float4*>(xrow);
        const float4 x1 = *reinterpret_cast<const float4*>(xrow + 4);
        const float xs[RUN] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        unsigned eq = 0;
#pragma unroll
        for (int i = 0; i < RUN; ++i) eq |= (xs[i] == p[i] ? 1u : 0u) << i;

        const int gy = gy0 + y;
        eq = (gy >= 0 && gy < H) ? eq & in_cols : 0u;
        const int mi = y * (4 * WIN_WORDS);
        unsigned m;
        if (ROUND == 0) {
            m = eq;
        } else {
            m = M[mi] | (eq & ~(unsigned)S[mi]);
        }
        if (ROUND < 2) {
            M[mi] = (unsigned char)m;
        } else {
            m = (gy >= border && gy < h0 - border) ? m & keep_cols : 0u;
            float r[RUN];
#pragma unroll
            for (int i = 0; i < RUN; ++i) r[i] = (m >> i) & 1u ? xs[i] : 0.f;
            *reinterpret_cast<float4*>(xrow) = make_float4(r[0], r[1], r[2], r[3]);
            *reinterpret_cast<float4*>(xrow + 4) = make_float4(r[4], r[5], r[6], r[7]);
        }
    }
}

// S = max_pool(M) > 0 as bits, for rows [K_STAGE R, WIN_H - K_STAGE R):
// a vertical OR of 2R+1 words and a horizontal dilation by R across
// neighbouring words; bits outside the map are cleared.
template <int R, int K_STAGE>
__device__ __forceinline__ void dilate_pass(const unsigned* M, unsigned* S, int gy0, int gx0,
                                            int H, int W) {
    constexpr int ROW_LO = K_STAGE * R;
    constexpr int NROWS = WIN_H - 2 * ROW_LO;
    for (int it = threadIdx.x; it < NROWS * WIN_WORDS; it += THREADS) {
        const int row = it / WIN_WORDS, q = it - row * WIN_WORDS;
        const int y = ROW_LO + row;
        unsigned left = 0, mid = 0, right = 0;
#pragma unroll
        for (int dy = -R; dy <= R; ++dy) {
            const unsigned* m = M + (y + dy) * WIN_WORDS + q;
            mid |= m[0];
            if (q > 0) left |= m[-1];
            if (q < WIN_WORDS - 1) right |= m[1];
        }
        unsigned d = mid;
#pragma unroll
        for (int s = 1; s <= R; ++s)
            d |= __funnelshift_l(left, mid, s) | __funnelshift_r(mid, right, s);
        const int gy = gy0 + y;
        d = (gy >= 0 && gy < H) ? d & bits_in_range(gx0 + 32 * q, 0, W, 32) : 0u;
        S[y * WIN_WORDS + q] = d;
    }
}

// One block walks over tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...
// (tiles of one map row by row, map after map). Where the window can be
// loaded as 16-byte vectors, the next tile's window is fetched into
// registers while this tile's pools run.
template <int R>
__global__ void __launch_bounds__(THREADS, NMS_MIN_BLOCKS) nms_border_kernel(
    const float* __restrict__ heat, float* __restrict__ out, int H, int W, int border,
    int h0, int w0, int vec, int tiles_x, int tiles_y, int n_tiles) {
    constexpr int HALO = 5 * R;
    constexpr int TILE_H = WIN_H - 2 * HALO, TILE_W = WIN_W - 2 * HALO;
    constexpr int PITCH = pitch(R), PAD = pad_cols(R);
    constexpr int QUADS = WIN_W / 4;                     // 16-byte vectors per window row
    constexpr int FSTEP = THREADS / QUADS;               // window rows the block fetches at once
    constexpr int NFETCH = (WIN_H + FSTEP - 1) / FSTEP;
    static_assert(THREADS % QUADS == 0, "a thread fetches one column of vectors");
    extern __shared__ __align__(16) float smem[];
    float* X = smem;                         // scores; -inf outside the map
    float* T = X + WIN_H * PITCH;            // column-pass results, -inf pads
    unsigned* M = reinterpret_cast<unsigned*>(T + WIN_H * PITCH);  // max mask bits
    unsigned* S = M + WIN_H * WIN_WORDS;     // suppression mask bits
    unsigned char* M8 = reinterpret_cast<unsigned char*>(M);
    const unsigned char* S8 = reinterpret_cast<const unsigned char*>(S);
    // W, the pointers and the windows' origins are multiples of 4
    // pixels: a vector lies wholly inside or outside the map
    const bool vectors = R % 4 == 0 && vec;

    // T's pads stay -inf for the whole run
    for (int i = threadIdx.x; i < WIN_H * (2 * PAD + 4); i += THREADS) {
        const int wy = i / (2 * PAD + 4), c = i - wy * (2 * PAD + 4);
        T[wy * PITCH + (c < PAD ? c : WIN_W + c)] = neg_inf();
    }

    // the window of tile t as vectors in registers: this thread's are
    // those at window column fx of rows fy, fy + FSTEP, ...
    const int fx = 4 * (threadIdx.x % QUADS), fy = threadIdx.x / QUADS;
    float4 win[NFETCH];
    auto fetch = [&](int t) {
        const int b = t / (tiles_x * tiles_y), rem = t - b * (tiles_x * tiles_y);
        const int by = rem / tiles_x, bx = rem - by * tiles_x;
        const int gy = by * TILE_H - HALO + fy, gx = bx * TILE_W - HALO + fx;
        const float* src = heat + (size_t)b * H * W;
        const ptrdiff_t first = (ptrdiff_t)gy * W + gx;
#pragma unroll
        for (int k = 0; k < NFETCH; ++k) {
            win[k] = make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
            if (gx >= 0 && gx < W && gy + k * FSTEP >= 0 && gy + k * FSTEP < H &&
                (WIN_H % FSTEP == 0 || fy + k * FSTEP < WIN_H))
                win[k] = __ldg(reinterpret_cast<const float4*>(
                    src + first + (ptrdiff_t)k * FSTEP * W));
        }
    };
    if (vectors && blockIdx.x < n_tiles) fetch(blockIdx.x);

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int b = t / (tiles_x * tiles_y), rem = t - b * (tiles_x * tiles_y);
        const int by = rem / tiles_x, bx = rem - by * tiles_x;
        const int gy0 = by * TILE_H - HALO, gx0 = bx * TILE_W - HALO;
        if (vectors) {
#pragma unroll
            for (int k = 0; k < NFETCH; ++k) {
                if (WIN_H % FSTEP == 0 || fy + k * FSTEP < WIN_H)
                    *reinterpret_cast<float4*>(X + (fy + k * FSTEP) * PITCH + PAD + fx) =
                        win[k];
            }
            if (t + gridDim.x < n_tiles) fetch(t + gridDim.x);
        } else {
            const float* src = heat + (size_t)b * H * W;
#pragma unroll 4
            for (int i = threadIdx.x; i < WIN_H * WIN_W; i += THREADS) {
                const int wy = i / WIN_W, wx = i - wy * WIN_W;
                const int gy = gy0 + wy, gx = gx0 + wx;
                float v = neg_inf();
                if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    v = __ldg(src + (size_t)gy * W + gx);
                X[wy * PITCH + PAD + wx] = v;
            }
        }
        __syncthreads();

        // this thread's run of columns in every row pass
        const int run_gx = gx0 + RUN * ((threadIdx.x % (2 * OCTETS)) >> 1);
        const unsigned in_cols = bits_in_range(run_gx, 0, W, RUN);
        const unsigned keep_cols = bits_in_range(run_gx, border, w0 - border, RUN);

        // max_mask = scores == max_pool(scores)
        column_pass<R, 1, false>(X, T, S);
        __syncthreads();
        row_pass<R, 1, 0>(X, T, M8, S8, gy0, H, border, h0, in_cols, keep_cols);
        __syncthreads();
        // round 1: supp = max_pool(max_mask) > 0; supp_scores = supp ? 0 : scores;
        // max_mask |= (supp_scores == max_pool(supp_scores)) & ~supp
        dilate_pass<R, 2>(M, S, gy0, gx0, H, W);
        __syncthreads();
        column_pass<R, 3, true>(X, T, S);
        __syncthreads();
        row_pass<R, 3, 1>(X, T, M8, S8, gy0, H, border, h0, in_cols, keep_cols);
        __syncthreads();
        // round 2, then the border frame; the result replaces X's centre
        dilate_pass<R, 4>(M, S, gy0, gx0, H, W);
        __syncthreads();
        column_pass<R, 5, true>(X, T, S);
        __syncthreads();
        row_pass<R, 5, 2>(X, T, M8, S8, gy0, H, border, h0, in_cols, keep_cols);
        __syncthreads();

        float* dst = out + (size_t)b * H * W;
        const int ty0 = by * TILE_H, tx0 = bx * TILE_W;
        if (vectors) {
            // a thread stays on one column of vectors of the tile
            constexpr int OQ = TILE_W / 4, OSTEP = THREADS / OQ;
            const int tx = 4 * (threadIdx.x % OQ), gx = tx0 + tx;
            if (threadIdx.x < OSTEP * OQ && gx < W) {
                for (int ty = threadIdx.x / OQ; ty < TILE_H && ty0 + ty < H; ty += OSTEP)
                    *reinterpret_cast<float4*>(dst + (size_t)(ty0 + ty) * W + gx) =
                        *reinterpret_cast<const float4*>(
                            X + (ty + HALO) * PITCH + PAD + tx + HALO);
            }
        } else {
            for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
                const int ty = i / TILE_W, tx = i - ty * TILE_W;
                const int gy = ty0 + ty, gx = tx0 + tx;
                if (gy < H && gx < W)
                    dst[(size_t)gy * W + gx] = X[(ty + HALO) * PITCH + PAD + tx + HALO];
            }
        }
        __syncthreads();                     // X is the next tile's
    }
}

constexpr size_t SMEM_LIMIT = 227 * 1024;    // dynamic shared memory of one block

constexpr int max_radius() {
    int r = 0;
    while (r < MAX_RADIUS_CAP && WIN_H - 10 * (r + 1) >= RUN && WIN_W - 10 * (r + 1) >= RUN &&
           smem_bytes(r + 1) <= SMEM_LIMIT)
        ++r;
    return r;
}
constexpr int MAX_RADIUS = max_radius();

// blocks of nms_border_kernel<R> that fit the card at once (asked once;
// the cards of one host are alike)
template <int R>
cudaError_t resident_blocks(int* blocks) {
    static int cached = 0;
    if (cached == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, nms_border_kernel<R>, THREADS, smem_bytes(R));
        if (err != cudaSuccess) return err;
        if (sms * per_sm <= 0) return cudaErrorLaunchOutOfResources;
        cached = sms * per_sm;
    }
    *blocks = cached;
    return cudaSuccess;
}

template <int R>
int launch(const float* heat, float* out, int B, int H, int W, int r, int border,
           int h0, int w0, cudaStream_t stream) {
    if constexpr (R > MAX_RADIUS) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (r != R) return launch<R + 1>(heat, out, B, H, W, r, border, h0, w0, stream);
        constexpr int TILE_H = WIN_H - 10 * R, TILE_W = WIN_W - 10 * R;
        cudaError_t err = cudaFuncSetAttribute(
            nms_border_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(R));
        int resident = 0;
        if (err == cudaSuccess) err = resident_blocks<R>(&resident);
        if (err != cudaSuccess) return (int)err;
        const int vec = W % 4 == 0 && reinterpret_cast<size_t>(heat) % 16 == 0 &&
                        reinterpret_cast<size_t>(out) % 16 == 0;
        const int tiles_x = (W + TILE_W - 1) / TILE_W, tiles_y = (H + TILE_H - 1) / TILE_H;
        const long long n_tiles = (long long)tiles_x * tiles_y * B;
        if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        const int grid = n_tiles < resident ? (int)n_tiles : resident;
        nms_border_kernel<R><<<grid, THREADS, smem_bytes(R), stream>>>(
            heat, out, H, W, border, h0, w0, vec, tiles_x, tiles_y, (int)n_tiles);
        return (int)cudaGetLastError();
    }
}

}  // namespace

// heat, out: (B, H, W) float32 contiguous on the current device;
// 0 <= r <= MAX_RADIUS.
extern "C" int fused_nms_border(const void* heat, void* out, int B, int H, int W,
                                int r, int border, int h0, int w0, void* stream) {
    if (r < 0) return (int)cudaErrorInvalidValue;
    return launch<0>(static_cast<const float*>(heat), static_cast<float*>(out), B, H, W,
                     r, border, h0, w0, static_cast<cudaStream_t>(stream));
}
