// Kernel B1: FAST-9/16 ring scores at two thresholds + separable 7-tap
// sigma=2 Gaussian blur over an f32[L, H, W] pyramid stack; and kernel B4,
// the same tiled kernel without the blur on one f32[H, W] image.
//
// Replaces _band_kernel_stack (plslam_tpu/ops/fast_pallas.py:145). Its
// bytes bound on the H100 is one read of each level's live area with its
// 3-px halo (4.1 MB at 8 x 480 x 640) and three writes of the whole stack
// (29.5 MB): ~10 us at 3.35 TB/s. What bounds it in practice is the
// integer/compare pipe, which issues at half the float rate: the 64 ring
// bits per pixel (two thresholds, bright and dark), the relu maxima and the
// arc tests (measured: the one-pixel-per-thread kernel spent 0.0163 of its
// 0.0419 ms on loads and stores, 0.023 ms on the two ring scores). The
// design cuts those instructions and keeps the loads cheap:
//  - ring bits from the sign bits of th - d and d + th (an add and a
//    shift-or per bit, not compare + select + shift-or);
//  - the 9-of-16 arc test by doubling (4 shift-ands instead of 8);
//  - the relu sums only in warps where some pixel has a 9-arc (the score
//    is 0 elsewhere, so skipping is exact), and the higher threshold's
//    bits and sums only where the lower one found an arc (its masks are
//    subsets);
//  - a 64 x 16 output tile per block of 256 threads; each thread owns one
//    column and 4 rows of it and walks down them with a 7 x 7 window in
//    registers, so each input pixel is loaded from shared memory and
//    blurred horizontally once per thread; the vertical blur slides down
//    the registers;
//  - the 22 x 72 halo tile arrives by one TMA load (cp.async.bulk.tensor.2d
//    over the stack seen as [L * H, W], completing on an mbarrier). TMA
//    fills cells outside the tensor with zeros and reads a neighbouring
//    level's rows past a level's edge, where the oracle clamps
//    (plslam_tpu/ops/fast.py:48), so border tiles rewrite their halo from
//    clamped coordinates; interior tiles need no fix-up. The box starts 4
//    columns left of the tile: the card faults on an inner start
//    coordinate that is not a 16-byte multiple. Planes whose rows are not
//    16-byte multiples load the tile with plain clamped loads;
//  - tiles at or beyond a level's live extent (its true size rounded up to
//    the 32-px FAST cell, in live_h / live_w) are written as float4 zeros
//    without any read; pixels of a live tile past the extent are zeros too.
// Live tiles store with 4-byte stores: a warp's 32 lanes are 32 adjacent
// columns, so each store instruction writes one 128-byte row segment
// (float4 stores would need a transpose through shared memory that costs
// as many instructions as it saves). Sums keep the oracle's order (ring
// order, blur taps in order).
//
// B4 replaces _band_kernel (plslam_tpu/ops/fast_pallas.py:48, launched by
// fast_scores_pallas at :87): fast_kernel<false, ...> with L = 1, every
// tile live and no blur plane. Bound by one read and two writes of the
// image (3.7 MB at 480 x 640, ~1.1 us at 3.35 TB/s) against 276 float32
// operations per pixel (~1.3 us at 67 TFLOP/s). Neighbours are edge-clamped
// as in the jnp oracle; the TPU kernel's circular roll along W and its
// 128-lane padding are TPU mechanics, not carried over.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPT = 4, TW = 64, TH = 4 * RPT, R = 3;  // rows per thread, tile, ring radius
constexpr int NT = TW * (TH / RPT);                   // 256 threads
constexpr int SW = 72, SH = TH + 2 * R;               // halo tile: 70 columns used, 72 for TMA's 16-byte rows
constexpr int CL = 4;  // tile column 0 is x0 - 4: TMA's inner start coordinate must be a 16-byte multiple
constexpr int MAX_LEVELS = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
    int live_h[MAX_LEVELS];
    int live_w[MAX_LEVELS];
    float gauss[7];
};

// 9 consecutive set bits anywhere on the 16-bit ring: with w the ring
// doubled to 32 bits, bit j of r ends up set iff bits j..j+8 of w are.
__device__ __forceinline__ bool arc9(unsigned bits) {
    const unsigned w = bits | (bits << 16);
    unsigned r = w & (w >> 1);  // runs of 2
    r &= r >> 2;                // runs of 4
    r &= r >> 4;                // runs of 8
    r &= w >> 8;                // runs of 9
    return (r & 0xFFFFu) != 0u;
}

// Ring of radius 3, clockwise from 12 o'clock (ops/fast.py CIRCLE), as
// offsets into the 7 x 7 window (row, column).
__device__ __forceinline__ int ring_r(int i) {
    constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    return R + dy[i];
}
__device__ __forceinline__ int ring_c(int i) {
    constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    return R + dx[i];
}

// Bright (d > th) and dark (d < -th) bits of the 16 ring differences, read
// off the sign bits of th - d and d + th (neither is -0 for finite d, so a
// negative sign means the strict inequality), packed from bit 15 down:
// an add and a shift-or per bit on the integer pipe, where a compare, a
// select and a shift-or cost three.
__device__ __forceinline__ void masks(const float* d, float th, unsigned& mb, unsigned& md) {
    mb = 0u;
    md = 0u;
#pragma unroll
    for (int i = 15; i >= 0; --i) {
        mb = (mb << 1) | (__float_as_uint(__fsub_rn(th, d[i])) >> 31);
        md = (md << 1) | (__float_as_uint(__fadd_rn(d[i], th)) >> 31);
    }
}

// max(sum relu(d - t), sum relu(-d - t)), summed in ring order as the oracle.
__device__ __forceinline__ float relu_sums(const float* d, float th) {
    float sb = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        sb = __fadd_rn(sb, fmaxf(__fsub_rn(d[i], th), 0.f));
        sd = __fadd_rn(sd, fmaxf(__fsub_rn(-th, d[i]), 0.f));
    }
    return fmaxf(sb, sd);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n"
        "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// kTma: the plane suits TMA (rows of 16-byte multiples, aligned pointers)
// and `map` describes it; its tiles then arrive by one TMA load. Otherwise
// every tile loads plainly, clamped.
template <bool kBlur, bool kTma>
__global__ void __launch_bounds__(NT, 2)
fast_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ stack, float* __restrict__ hi,
            float* __restrict__ lo, float* __restrict__ blur, int H, int W, float th_hi, float th_lo, Params p) {
    __shared__ __align__(128) float tile[SH][SW];
    __shared__ __align__(8) uint64_t bar_mem;
    const int l = blockIdx.z;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
    const size_t plane = static_cast<size_t>(l) * H * W;
    const int live_h = p.live_h[l], live_w = p.live_w[l];

    if (y0 >= live_h || x0 >= live_w) {  // block-uniform: a dead tile, zeros without a read
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = tid; i < TH * (TW / 4); i += NT) {
            const int y = y0 + i / (TW / 4), x = x0 + 4 * (i % (TW / 4));
            if (y >= H || x >= W) continue;
            const size_t o = plane + static_cast<size_t>(y) * W + x;
            if (kTma && x + 4 <= W) {  // rows are 16-byte multiples on this path
                *reinterpret_cast<float4*>(hi + o) = z;
                *reinterpret_cast<float4*>(lo + o) = z;
                if constexpr (kBlur) *reinterpret_cast<float4*>(blur + o) = z;
            } else {
                for (int k = 0; k < 4 && x + k < W; ++k) {
                    hi[o + k] = 0.f;
                    lo[o + k] = 0.f;
                    if constexpr (kBlur) blur[o + k] = 0.f;
                }
            }
        }
        return;
    }

    // ---- the halo tile: rows y0-3 .. y0+TH+2, columns x0-4 .. x0+67 (the
    // inner start coordinate of a TMA box must be a 16-byte multiple, or
    // the card faults); rows above the stack's top arrive as zeros.
    if constexpr (kTma) {
        const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&bar_mem));
        if (tid == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         ::"r"(bar), "r"(static_cast<int>(sizeof(tile))) : "memory");
            asm volatile(
                "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
                ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(&tile[0][0]))),
                  "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(x0 - CL), "r"(l * H + y0 - R)
                : "memory");
        }
        __syncthreads();  // the mbarrier is initialised before anyone waits on it
        mbar_wait(bar, 0);
        // border tiles: cells off the plane got zeros or another level's
        // rows; give them the clamped edge pixel (sources are on-plane
        // cells, which no thread writes)
        if (y0 < R || y0 + TH + R > H || x0 < CL || x0 + SW - CL > W) {
            for (int i = tid; i < SH * SW; i += NT) {
                const int sy = i / SW, sx = i - sy * SW;
                const int gy = y0 - R + sy, gx = x0 - CL + sx;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W) continue;
                const int cy = min(max(gy, 0), H - 1), cx = min(max(gx, 0), W - 1);
                tile[sy][sx] = tile[cy - y0 + R][cx - x0 + CL];
            }
            __syncthreads();
        }
    } else {
        for (int i = tid; i < SH * SW; i += NT) {
            const int sy = i / SW, sx = i - sy * SW;
            const int gy = min(max(y0 - R + sy, 0), H - 1);
            const int gx = min(max(x0 - CL + sx, 0), W - 1);
            tile[sy][sx] = stack[plane + static_cast<size_t>(gy) * W + gx];
        }
        __syncthreads();
    }

    // ---- walk down the thread's column: input rows ty*RPT .. ty*RPT+RPT+5
    // of the tile, output rows y = y0 + ty*RPT + j for j < RPT
    const int x = x0 + tx;
    const bool col_live = x < live_w && x < W;
    const float t_a = fminf(th_hi, th_lo), t_b = fmaxf(th_hi, th_lo);  // masks at t_b are subsets of t_a's
    const bool swap = th_hi < th_lo;
    float win[7][7] = {};  // win[k][c]: tile row (centre - 3 + k), column x - 3 + c
    float hb[7] = {};      // horizontal blur of the same rows at column x
#pragma unroll
    for (int k = 0; k < RPT + 2 * R; ++k) {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int c = 0; c < 7; ++c) win[a][c] = win[a + 1][c];
            hb[a] = hb[a + 1];
        }
        const float* src = &tile[ty * RPT + k][tx + CL - R];
#pragma unroll
        for (int c = 0; c < 7; ++c) win[6][c] = src[c];
        if constexpr (kBlur) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < 7; ++c) s = __fadd_rn(s, __fmul_rn(p.gauss[c], win[6][c]));
            hb[6] = s;
        }
        if (k < 2 * R) continue;  // the window is not full yet

        const int y = y0 + ty * RPT + (k - 2 * R);
        const float cen = win[R][R];
        float d[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i] = __fsub_rn(win[ring_r(i)][ring_c(i)], cen);
        unsigned mb, md;
        masks(d, t_a, mb, md);
        const bool arc_a = arc9(mb) || arc9(md);
        float s_a = 0.f, s_b = 0.f;
        if (__any_sync(FULL, arc_a)) {  // warp-uniform: warps without a 9-arc skip the sums
            s_a = arc_a ? relu_sums(d, t_a) : 0.f;
            masks(d, t_b, mb, md);
            const bool arc_b = arc9(mb) || arc9(md);
            if (__any_sync(FULL, arc_b)) s_b = arc_b ? relu_sums(d, t_b) : 0.f;
        }
        if (y >= H || x >= W) continue;
        const bool live = col_live && y < live_h;
        const size_t o = plane + static_cast<size_t>(y) * W + x;
        hi[o] = live ? (swap ? s_a : s_b) : 0.f;
        lo[o] = live ? (swap ? s_b : s_a) : 0.f;
        if constexpr (kBlur) {
            float b = 0.f;
#pragma unroll
            for (int a = 0; a < 7; ++a) b = __fadd_rn(b, __fmul_rn(p.gauss[a], hb[a]));
            blur[o] = live ? b : 0.f;
        }
    }
}

// cuTensorMapEncodeTiled / cuTensorMapReplaceAddress from libcuda, reached
// through the runtime's entry-point query so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

cudaError_t cu_entry(const char* name, void** fn) {
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    return q == cudaDriverEntryPointSuccess && *fn ? cudaSuccess : cudaErrorSymbolNotFound;
}

// The tensor map of an f32[rows, W] plane stack with a 72 x 38 box: encoded
// once per (rows, W), its address replaced when the data moves; one cache
// per kernel (B1's stack and B4's image).
template <bool kBlur>
cudaError_t tensor_map(const float* data, int rows, int W, CUtensorMap* out) {
    static EncodeTiled encode = nullptr;
    static ReplaceAddress replace = nullptr;
    static CUtensorMap map;
    static int map_rows = -1, map_w = -1;
    static const float* map_ptr = nullptr;
    if (!encode) {
        cudaError_t e = cu_entry("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode));
        if (e == cudaSuccess) e = cu_entry("cuTensorMapReplaceAddress", reinterpret_cast<void**>(&replace));
        if (e != cudaSuccess) {
            encode = nullptr;
            return e;
        }
    }
    if (rows != map_rows || W != map_w) {
        const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(rows)};
        const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * sizeof(float)};
        const cuuint32_t box[2] = {SW, SH};
        const cuuint32_t estr[2] = {1, 1};
        if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(data), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return cudaErrorInvalidValue;
        map_rows = rows;
        map_w = W;
        map_ptr = data;
    } else if (data != map_ptr) {
        if (replace(&map, const_cast<float*>(data)) != CUDA_SUCCESS) return cudaErrorInvalidValue;
        map_ptr = data;
    }
    *out = map;
    return cudaSuccess;
}

template <bool kBlur>
cudaError_t launch(const float* img, float* hi, float* lo, float* blur, int L, int H, int W, float th_hi,
                   float th_lo, const Params& p, cudaStream_t stream) {
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, L);
    const bool tma = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(hi) % 16 == 0 && reinterpret_cast<uintptr_t>(lo) % 16 == 0 &&
                     (!kBlur || reinterpret_cast<uintptr_t>(blur) % 16 == 0);
    CUtensorMap map = {};
    if (tma) {
        cudaError_t e = tensor_map<kBlur>(img, L * H, W, &map);
        if (e != cudaSuccess) return e;
        fast_kernel<kBlur, true><<<grid, NT, 0, stream>>>(map, img, hi, lo, blur, H, W, th_hi, th_lo, p);
    } else {
        fast_kernel<kBlur, false><<<grid, NT, 0, stream>>>(map, img, hi, lo, blur, H, W, th_hi, th_lo, p);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" int plslam_fast_blur_stack(const float* stack, float* hi, float* lo, float* blur,
                                      int L, int H, int W, float th_hi, float th_lo,
                                      const int* live_h, const int* live_w, const float* gauss7,
                                      void* stream) {
    if (L < 1 || L > MAX_LEVELS || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        p.live_h[l] = l < L ? live_h[l] : 0;
        p.live_w[l] = l < L ? live_w[l] : 0;
    }
    for (int k = 0; k < 7; ++k) p.gauss[k] = gauss7[k];
    return static_cast<int>(launch<true>(stack, hi, lo, blur, L, H, W, th_hi, th_lo, p,
                                         static_cast<cudaStream_t>(stream)));
}

extern "C" int plslam_fast_scores(const float* img, float* hi, float* lo, int H, int W,
                                  float th_hi, float th_lo, void* stream) {
    if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    Params p = {};
    p.live_h[0] = H;  // one level, every tile live
    p.live_w[0] = W;
    return static_cast<int>(launch<false>(img, hi, lo, nullptr, 1, H, W, th_hi, th_lo, p,
                                          static_cast<cudaStream_t>(stream)));
}
