// Kernel B1: FAST-9/16 ring scores at two thresholds + separable 7-tap
// sigma=2 Gaussian blur over an f32[L, H, W] pyramid stack; and kernel B4,
// the same tiled kernel without the blur on one f32[H, W] image.
//
// Replaces _band_kernel_stack (plslam_tpu/ops/fast_pallas.py:145). Bound on
// the H100 by memory traffic: one read of each level's live area with its
// 3-px halo (4.1 MB at 8 x 480 x 640) and three writes of the whole stack
// (29.5 MB), ~10 us at 3.35 TB/s. Design: one block per 32x8
// output tile of one level; the tile and a 3-pixel halo are read once into
// shared memory (coordinates clamped to the plane, which is the edge rule of
// both the reference's FAST padding and its banded blur matrices); the 16
// ring differences, both threshold masks, the doubled 16-bit arc test and
// max(sum relu(d - t), sum relu(-d - t)) stay in registers; the blur is a
// vertical pass into shared memory, then a horizontal pass. Tiles at or
// beyond a level's live extent (its true size rounded up to the 32-px FAST
// cell, passed in live_h / live_w) are written as zeros without any read.
//
// B4 replaces _band_kernel (plslam_tpu/ops/fast_pallas.py:48, launched by
// fast_scores_pallas at :87): fast_kernel<false> with L = 1, every tile live
// and no blur plane. Bound by one read and two writes of the image (3.7 MB
// at 480 x 640, ~1.1 us at 3.35 TB/s). Neighbours are edge-clamped as in
// the jnp oracle (plslam_tpu/ops/fast.py:48); the TPU kernel's circular
// roll along W and its 128-lane padding are TPU mechanics, not carried over.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32, TH = 8, R = 3;
constexpr int SW = TW + 2 * R, SH = TH + 2 * R;
constexpr int MAX_LEVELS = 16;

struct Params {
    int live_h[MAX_LEVELS];
    int live_w[MAX_LEVELS];
    float gauss[7];
};

// Bresenham ring of radius 3, clockwise from 12 o'clock (ops/fast.py CIRCLE).
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool arc9(unsigned bits) {
    unsigned ww = bits | (bits << 16);
    unsigned r = ww;
#pragma unroll
    for (int k = 1; k < 9; ++k) r &= ww >> k;
    return (r & 0xFFFFu) != 0u;
}

__device__ __forceinline__ float ring_score(const float* d, float th) {
    float sb = 0.f, sd = 0.f;
    unsigned mb = 0u, md = 0u;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        float xb = __fsub_rn(d[i], th);   // d - t   (> 0  <=>  d > t)
        float xd = __fsub_rn(-th, d[i]);  // -d - t  (> 0  <=>  d < -t)
        sb = __fadd_rn(sb, fmaxf(xb, 0.f));
        sd = __fadd_rn(sd, fmaxf(xd, 0.f));
        mb |= (xb > 0.f ? 1u : 0u) << i;
        md |= (xd > 0.f ? 1u : 0u) << i;
    }
    return (arc9(mb) || arc9(md)) ? fmaxf(sb, sd) : 0.f;
}

template <bool kBlur>
__global__ void __launch_bounds__(TW * TH)
fast_kernel(const float* __restrict__ stack, float* __restrict__ hi, float* __restrict__ lo,
            float* __restrict__ blur, int H, int W, float th_hi, float th_lo, Params p) {
    __shared__ float tile[SH][SW];
    __shared__ float vpass[kBlur ? TH : 1][SW];
    const int l = blockIdx.z;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
    const int x = x0 + tx, y = y0 + ty;
    const size_t plane = static_cast<size_t>(l) * H * W;
    const size_t o = plane + static_cast<size_t>(y) * W + x;

    if (y0 >= p.live_h[l] || x0 >= p.live_w[l]) {  // block-uniform
        if (x < W && y < H) {
            hi[o] = 0.f;
            lo[o] = 0.f;
            if constexpr (kBlur) blur[o] = 0.f;
        }
        return;
    }
    for (int i = tid; i < SH * SW; i += TW * TH) {
        int sy = i / SW, sx = i - sy * SW;
        int gy = min(max(y0 + sy - R, 0), H - 1);
        int gx = min(max(x0 + sx - R, 0), W - 1);
        tile[sy][sx] = stack[plane + static_cast<size_t>(gy) * W + gx];
    }
    __syncthreads();
    if constexpr (kBlur) {
        for (int i = tid; i < TH * SW; i += TW * TH) {
            int r = i / SW, c = i - r * SW;
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 7; ++k) s = __fadd_rn(s, __fmul_rn(p.gauss[k], tile[r + k][c]));
            vpass[r][c] = s;
        }
        __syncthreads();
    }
    if (x >= W || y >= H) return;

    const float c = tile[ty + R][tx + R];
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = __fsub_rn(tile[ty + R + c_dy[i]][tx + R + c_dx[i]], c);
    hi[o] = ring_score(d, th_hi);
    lo[o] = ring_score(d, th_lo);
    if constexpr (kBlur) {
        float b = 0.f;
#pragma unroll
        for (int k = 0; k < 7; ++k) b = __fadd_rn(b, __fmul_rn(p.gauss[k], vpass[ty][tx + k]));
        blur[o] = b;
    }
}

}  // namespace

extern "C" int plslam_fast_blur_stack(const float* stack, float* hi, float* lo, float* blur,
                                      int L, int H, int W, float th_hi, float th_lo,
                                      const int* live_h, const int* live_w, const float* gauss7,
                                      void* stream) {
    if (L < 1 || L > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        p.live_h[l] = l < L ? live_h[l] : 0;
        p.live_w[l] = l < L ? live_w[l] : 0;
    }
    for (int k = 0; k < 7; ++k) p.gauss[k] = gauss7[k];
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, L);
    dim3 block(TW, TH);
    fast_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        stack, hi, lo, blur, H, W, th_hi, th_lo, p);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int plslam_fast_scores(const float* img, float* hi, float* lo, int H, int W,
                                  float th_hi, float th_lo, void* stream) {
    if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    Params p = {};
    p.live_h[0] = H;  // one level, every tile live
    p.live_w[0] = W;
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, 1);
    dim3 block(TW, TH);
    fast_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img, hi, lo, nullptr, H, W, th_hi, th_lo, p);
    return static_cast<int>(cudaGetLastError());
}
