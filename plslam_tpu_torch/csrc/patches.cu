// Kernel B2: one size x size window per keypoint from the flattened blurred
// pyramid stack, f32[rows, W] -> f32[K, size, size].
//
// Replaces gather_patches_pallas (plslam_tpu/ops/patches.py:44). Bound on
// the H100 by memory traffic: K * size^2 floats read and written, ~12 MB at
// K = 1000, size = 39, ~4 us at 3.35 TB/s. Design: one block per keypoint,
// one warp per window row at a time, lanes on consecutive pixels, so each
// row is one coalesced read and one contiguous write. The window start follows
// lax.dynamic_slice: a negative start wraps once by the dimension, then the
// start is clamped into [0, dim - size] (only padded slots reach either).
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
gather_patches_kernel(const float* __restrict__ img, const int* __restrict__ yx,
                      float* __restrict__ out, int H, int W, int size) {
    const int k = blockIdx.x;
    const int r = size / 2;
    int ys = yx[2 * k] - r, xs = yx[2 * k + 1] - r;
    if (ys < 0) ys += H;
    if (xs < 0) xs += W;
    ys = min(max(ys, 0), H - size);
    xs = min(max(xs, 0), W - size);
    float* dst = out + static_cast<size_t>(k) * size * size;
    // warp-per-row: lane = column, so each row is one coalesced read
    for (int row = threadIdx.y; row < size; row += blockDim.y) {
        const float* src = img + static_cast<size_t>(ys + row) * W + xs;
        for (int col = threadIdx.x; col < size; col += blockDim.x) dst[row * size + col] = src[col];
    }
}

}  // namespace

extern "C" int plslam_gather_patches(const float* img, const int* yx, float* out, int H, int W,
                                     int K, int size, void* stream) {
    if (size < 1 || size > H || size > W) return static_cast<int>(cudaErrorInvalidValue);
    if (K > 0)
        gather_patches_kernel<<<K, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(img, yx, out, H, W, size);
    return static_cast<int>(cudaGetLastError());
}
