// Kernel B2: one 39x39 window per keypoint from the flattened blurred
// pyramid stack, f32[rows, W] -> f32[K, 39, 39]. The window size is the
// compile-time SIZE (BRIEF's patch, ops/brief.py PATCH_D); the C entry
// refuses any other.
//
// Replaces gather_patches_pallas (plslam_tpu/ops/patches.py:44), whose TPU
// design (aligned bf16 DMA windows rotated in registers) exists for the
// TPU's (8, 128) tiling; the result here is the plain dynamic_slice gather
// (patches.py:29-40), start rules included.
//
// What bounds it on the H100: bytes. The work is a copy: K * 39^2 floats
// written (6.2 MB at K = 1024) and the same count read from
// windows of a 9.8 MB stack that the blur has just written, which stays in
// the 50 MB L2. At ~1,000 keypoints the whole copy is a few microseconds,
// so what costs is per-block overhead, idle lanes, loads in flight and
// store width, not arithmetic.
//
// Design: the output is one flat array cut into warp tiles of TILE floats.
// A warp loads its tile lane-contiguously (load i of lane l is element
// 32 i + l, so one load instruction reads at most two window-row segments,
// ~2-4 cache lines), 8 independent loads per lane in flight, parks the
// tile in shared memory, and writes it back as float4s, each store
// instruction 512 contiguous bytes (four full 128-byte lines) whatever the
// window boundaries. The first attempt, float4 groups decoded per thread
// with no staging, read 4 values 16 bytes apart per lane: each load
// instruction then touched ~8 lines, and it took longer than the earlier
// warp-per-row kernel. A tile (TILE = 256 <= 39^2 floats) spans at most
// two windows, so a lane computes both window origins once per tile and
// picks one per element by a compare; the divisions by SIZE and SIZE^2 are
// by constants. The grid is sized
// from the work (one warp per tile), capped at 8 blocks per SM of the card
// with a grid-stride loop past that. The window start follows
// lax.dynamic_slice: a negative start wraps once by the dimension, then the
// start is clamped into [0, dim - 39] (only padded slots reach either).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int WARPS = 8;               // warps per block
constexpr int PER_LANE = 8;            // loads in flight per lane
constexpr int TILE = 32 * PER_LANE;    // floats per warp tile
constexpr int SIZE = 39;               // window side
constexpr int SQ = SIZE * SIZE;
static_assert(SQ >= TILE, "a tile must span at most two windows");

struct Window {
    int H, W, K;
    __device__ __forceinline__ const float* origin(const float* img, const int2* yx, int k) const {
        const int2 c = __ldg(yx + k);
        int ys = c.x - SIZE / 2, xs = c.y - SIZE / 2;
        if (ys < 0) ys += H;
        if (xs < 0) xs += W;
        ys = min(max(ys, 0), H - SIZE);
        xs = min(max(xs, 0), W - SIZE);
        return img + static_cast<size_t>(ys) * W + xs;
    }
};

__global__ void __launch_bounds__(32 * WARPS)
gather_patches_kernel(const float* __restrict__ img, const int2* __restrict__ yx,
                      float* __restrict__ out, Window win, int n_elem) {
    __shared__ __align__(16) float stage[WARPS][TILE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_tiles = (n_elem + TILE - 1) / TILE;
    float* st = stage[warp];
    for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles; tile += gridDim.x * WARPS) {
        const int base = tile * TILE;
        float v[PER_LANE];
        const int k0 = base / SQ;
        const float* o0 = win.origin(img, yx, k0);
        const float* o1 = k0 + 1 < win.K ? win.origin(img, yx, k0 + 1) : o0;
        const int rem0 = base - k0 * SQ;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) {
            int rem = rem0 + 32 * i + lane;
            const bool second = rem >= SQ;
            rem -= second ? SQ : 0;
            const int row = rem / SIZE, col = rem - row * SIZE;
            const float* p = (second ? o1 : o0) + row * win.W + col;
            v[i] = base + 32 * i + lane < n_elem ? __ldg(p) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i) st[32 * i + lane] = v[i];
        __syncwarp();
        const float4* st4 = reinterpret_cast<const float4*>(st);
#pragma unroll
        for (int j = 0; j < TILE / 128; ++j) {
            const int g = base / 4 + 32 * j + lane;  // float4 group of the output
            const float4 q = st4[32 * j + lane];
            if (4 * g + 4 <= n_elem) {
                reinterpret_cast<float4*>(out)[g] = q;
            } else if (4 * g < n_elem) {  // the ragged last group
                const float w[4] = {q.x, q.y, q.z, q.w};
                for (int m = 0; 4 * g + m < n_elem; ++m) out[4 * g + m] = w[m];
            }
        }
        __syncwarp();  // the stage is rewritten by the next tile
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (n <= 0) n = 1;
    }
    return n;
}

}  // namespace

extern "C" int plslam_gather_patches(const float* img, const int* yx, float* out, int H, int W,
                                     int K, int size, void* stream) {
    if (size != SIZE || SIZE > H || SIZE > W) return static_cast<int>(cudaErrorInvalidValue);
    if (static_cast<long long>(K) * SQ + TILE >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);  // element indices are 32-bit
    if ((reinterpret_cast<uintptr_t>(out) & 15) || (reinterpret_cast<uintptr_t>(yx) & 7))
        return static_cast<int>(cudaErrorMisalignedAddress);
    if (K > 0) {
        const int n_elem = K * SQ;
        const int n_tiles = (n_elem + TILE - 1) / TILE;
        const int want = (n_tiles + WARPS - 1) / WARPS;
        const int blocks = want < 8 * sm_count() ? want : 8 * sm_count();
        gather_patches_kernel<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
            img, reinterpret_cast<const int2*>(yx), out, Window{H, W, K}, n_elem);
    }
    return static_cast<int>(cudaGetLastError());
}
