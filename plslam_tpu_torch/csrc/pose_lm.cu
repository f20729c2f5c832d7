// Kernel B3: the whole motion-only pose LM (points + lines) in one launch.
//
// Replaces _kernel in plslam_tpu/solvers/pose_pallas.py:67 (the solve that
// plslam_tpu/solvers/pose.py:168-179 dispatches to on the TPU). Per
// iteration it builds the Huber-weighted normal equations (21 unique H
// entries, b, robust cost, count of points behind the camera) over up to
// 4096 point and 4096 line observations, solves (H + (lam + 1e-9) I) d = b
// by an unpivoted 6x6 LU, applies T <- exp(d) T and accepts or rejects
// (lam / 3 | lam * nu); rounds follow the given iteration schedule, with
// chi2 re-classification after each round (5.991 mono / 7.815 stereo /
// 5.991 line) and Huber off in the last round.
//
// What bounds it on the H100 is latency, not bytes or FLOPs: 14 dependent
// block-wide reductions and 10 serial 6x6 solves per call. The same launch
// with no valid row (chip_smoke.py's latency floor) takes ~0.09 ms of the
// ~0.10 ms a full problem takes (H100 SXM, 700 W). Design: one block of
// 1024 threads, observation i on thread i mod 1024 (lines on the low
// threads); each thread's 29 partial sums are reduced by warp shuffles,
// then across the 32 warps through shared memory
// in a fixed order (deterministic); thread 0 does the solve, the SE(3)
// update and the accept test, and the pose lives in shared memory. Padded
// rows are skipped before any arithmetic touches their (possibly
// non-finite) values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NACC = 29;  // H upper triangle (21, row-major), b (6), rho sum, behind-camera count
constexpr int MAX_ROUNDS = 8;
constexpr float CHI2_MONO = 5.991f, CHI2_STEREO = 7.815f, CHI2_LINE = 5.991f;
constexpr float TAU = 1e-5f;
constexpr float SMALL_THETA2 = 1e-3f;

struct Obs {
    const float* xw; const float* obs; const float* isig; const uint8_t* stereo; const uint8_t* valid;
    int n;
    const float* sw; const float* ew; const float* l2d; const float* isig_l; const uint8_t* lvalid;
    int nl;
};
struct Cam { float fx, fy, cx, cy, bf; };
struct Sched { int rounds; int iters[MAX_ROUNDS]; };

__device__ __forceinline__ float huber_w(float chi2, float delta2, bool robust) {
    if (!robust) return 1.f;
    return chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
}

__device__ __forceinline__ float huber_rho(float chi2, float delta2, bool robust) {
    if (!robust) return chi2;
    return chi2 <= delta2 ? chi2 : 2.f * sqrtf(delta2 * fmaxf(chi2, 0.f)) - delta2;
}

// H += w J^T J, b -= w J^T r for one residual row.
__device__ __forceinline__ void add_row(float* acc, const float* J, float r, float w) {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float wj = J[i] * w;
#pragma unroll
        for (int j = i; j < 6; ++j) acc[k++] += wj * J[j];
        acc[21 + i] -= wj * r;
    }
}

__device__ __forceinline__ void to_cam(const float* T, float x, float y, float z,
                                       float& X, float& Y, float& Z) {
    X = T[0] * x + T[1] * y + T[2] * z + T[9];
    Y = T[3] * x + T[4] * y + T[5] * z + T[10];
    Z = T[6] * x + T[7] * y + T[8] * z + T[11];
}

// Point residual at pose T: r (stereo row zeroed for mono), depth_ok.
__device__ __forceinline__ bool point_residual(const float* T, const Cam& c, const Obs& o, int i,
                                               float* P, float* r, float& iz) {
    to_cam(T, o.xw[3 * i], o.xw[3 * i + 1], o.xw[3 * i + 2], P[0], P[1], P[2]);
    const bool ok = P[2] > 1e-3f;
    iz = 1.f / (ok ? P[2] : 1.f);
    const float u = c.fx * P[0] * iz + c.cx;
    const float v = c.fy * P[1] * iz + c.cy;
    r[0] = o.obs[3 * i] - u;
    r[1] = o.obs[3 * i + 1] - v;
    r[2] = o.stereo[i] ? o.obs[3 * i + 2] - (u - c.bf * iz) : 0.f;
    return ok;
}

__device__ __forceinline__ void point_terms(const float* T, const Cam& c, const Obs& o, int i, bool active,
                            bool robust, float* acc) {
    const bool valid = o.valid[i];
    if (!valid || !active) return;  // padded / rejected rows: no arithmetic on their values
    float P[3], r[3], iz;
    if (!point_residual(T, c, o, i, P, r, iz)) {
        acc[28] += 1.f;  // behind the camera: raises the cost, not the system
        return;
    }
    const bool st = o.stereo[i];
    const float isig = o.isig[i];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * isig;
    const float delta2 = st ? CHI2_STEREO : CHI2_MONO;
    const float w = huber_w(chi2, delta2, robust) * isig;
    acc[27] += huber_rho(chi2, delta2, robust);
    const float X = P[0], Y = P[1], Z = P[2], iz2 = iz * iz;
    const float du0 = c.fx * iz, du2 = -c.fx * X * iz2;
    const float dv1 = c.fy * iz, dv2 = -c.fy * Y * iz2;
    // J = [-dpred/dP | dpred/dP @ hat(P)]
    const float Ju[6] = {-du0, 0.f, -du2, -du2 * Y, -du0 * Z + du2 * X, du0 * Y};
    const float Jv[6] = {0.f, -dv1, -dv2, dv1 * Z - dv2 * Y, dv2 * X, -dv1 * X};
    add_row(acc, Ju, r[0], w);
    add_row(acc, Jv, r[1], w);
    if (st) {
        const float d2 = du2 + c.bf * iz2;
        const float Jr[6] = {-du0, 0.f, -d2, -d2 * Y, -du0 * Z + d2 * X, du0 * Y};
        add_row(acc, Jr, r[2], w);
    }
}

// Line endpoint: residual r = -(l . pi(P)) and its Jacobian row; returns depth_ok.
__device__ __forceinline__ bool line_endpoint(const float* T, const Cam& c, const float* l,
                                              const float* E, float& r, float* J) {
    float X, Y, Z;
    to_cam(T, E[0], E[1], E[2], X, Y, Z);
    const bool ok = Z > 1e-3f;
    const float iz = 1.f / (ok ? Z : 1.f), iz2 = iz * iz;
    const float u = c.fx * X * iz + c.cx;
    const float v = c.fy * Y * iz + c.cy;
    r = -(l[0] * u + l[1] * v + l[2]);
    const float d0 = l[0] * (c.fx * iz), d1 = l[1] * (c.fy * iz);
    const float d2 = l[0] * (-c.fx * X * iz2) + l[1] * (-c.fy * Y * iz2);
    J[0] = -d0; J[1] = -d1; J[2] = -d2;
    J[3] = d1 * Z - d2 * Y; J[4] = -d0 * Z + d2 * X; J[5] = d0 * Y - d1 * X;
    return ok;
}

__device__ __forceinline__ void line_terms(const float* T, const Cam& c, const Obs& o, int i, bool active,
                           bool robust, float* acc) {
    if (!o.lvalid[i] || !active) return;
    float rs, re, Js[6], Je[6];
    const bool oks = line_endpoint(T, c, o.l2d + 3 * i, o.sw + 3 * i, rs, Js);
    const bool oke = line_endpoint(T, c, o.l2d + 3 * i, o.ew + 3 * i, re, Je);
    if (!(oks && oke)) {
        acc[28] += 1.f;
        return;
    }
    const float isig = o.isig_l[i];
    const float chi2 = (rs * rs + re * re) * isig;
    const float w = huber_w(chi2, CHI2_LINE, robust) * isig;
    acc[27] += huber_rho(chi2, CHI2_LINE, robust);
    add_row(acc, Js, rs, w);
    add_row(acc, Je, re, w);
}

// Block-wide sum of each thread's NACC partials into out[NACC] (fixed order).
__device__ void block_reduce(float* acc, float (*red)[NACC], float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < NACC) {
        float s = 0.f;
        for (int w = 0; w < NWARPS; ++w) s += red[w][threadIdx.x];
        out[threadIdx.x] = s;
    }
    __syncthreads();
}

__device__ __forceinline__ void build(const float* T, const Cam& c, const Obs& o, const uint8_t* pin,
                      const uint8_t* lin, bool robust, float (*red)[NACC], float* out) {
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    for (int i = threadIdx.x; i < o.n; i += NTHREADS) point_terms(T, c, o, i, pin[i], robust, acc);
    for (int i = threadIdx.x; i < o.nl; i += NTHREADS) line_terms(T, c, o, i, lin[i], robust, acc);
    block_reduce(acc, red, out);
}

// (H + (lam + 1e-9) I) d = b by unpivoted LU (H + lam I is SPD when the
// system is not degenerate; a degenerate one gives a non-finite d, which
// the caller rejects). Returns whether d is finite.
__device__ bool solve6(const float* sys, float lam, float* d) {
    float a[6][6];
    int k = 0;
    for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = sys[k++];
    for (int i = 0; i < 6; ++i) {
        a[i][i] += lam + 1e-9f;
        d[i] = sys[21 + i];
    }
    for (int p = 0; p < 6; ++p) {
        const float inv = 1.f / a[p][p];
        for (int i = p + 1; i < 6; ++i) {
            const float f = a[i][p] * inv;
            for (int j = p + 1; j < 6; ++j) a[i][j] -= f * a[p][j];
            d[i] -= f * d[p];
        }
    }
    bool finite = true;
    for (int p = 5; p >= 0; --p) {
        float s = d[p];
        for (int j = p + 1; j < 6; ++j) s -= a[p][j] * d[j];
        d[p] = s / a[p][p];
        finite = finite && isfinite(d[p]);
    }
    return finite;
}

// out = exp(d) * T for twist d = (rho, phi); T, out: R row-major (9), t (3).
__device__ void exp_compose(const float* d, const float* T, float* out) {
    const float p0 = d[3], p1 = d[4], p2 = d[5];
    const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
    const bool small = theta2 < SMALL_THETA2;
    const float t2 = small ? 1.f : theta2;
    const float th = sqrtf(t2);
    const float A = small ? 1.f - theta2 / 6.f + theta2 * theta2 / 120.f : sinf(th) / th;
    const float B = small ? 0.5f - theta2 / 24.f + theta2 * theta2 / 720.f : (1.f - cosf(th)) / t2;
    const float C = small ? 1.f / 6.f - theta2 / 120.f + theta2 * theta2 / 5040.f
                          : (th - sinf(th)) / (t2 * th);
    const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
    float R[3][3], V[3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const float K2 = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
            const float I = i == j ? 1.f : 0.f;
            R[i][j] = I + A * K[i][j] + B * K2;
            V[i][j] = I + B * K[i][j] + C * K2;
        }
    for (int i = 0; i < 3; ++i) {
        const float t = V[i][0] * d[0] + V[i][1] * d[1] + V[i][2] * d[2];
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = R[i][0] * T[j] + R[i][1] * T[3 + j] + R[i][2] * T[6 + j];
        out[9 + i] = R[i][0] * T[9] + R[i][1] * T[10] + R[i][2] * T[11] + t;
    }
}

__global__ void __launch_bounds__(NTHREADS, 1)
pose_lm_kernel(const float* __restrict__ Tcw0, Obs o, Cam c, Sched s, float* __restrict__ Tout,
               uint8_t* __restrict__ pin, uint8_t* __restrict__ lin) {
    __shared__ float red[NWARPS][NACC];
    __shared__ float sys[NACC], sysn[NACC];
    __shared__ float T[12], Tn[12];
    const int tid = threadIdx.x;
    if (tid < 12) T[tid] = tid < 9 ? Tcw0[(tid / 3) * 4 + tid % 3] : Tcw0[(tid - 9) * 4 + 3];
    // active masks start at valid; thread-owned slots, so no races
    for (int i = tid; i < o.n; i += NTHREADS) pin[i] = o.valid[i];
    for (int i = tid; i < o.nl; i += NTHREADS) lin[i] = o.lvalid[i];
    __syncthreads();

    float lam = 0.f, nu = 2.f;  // meaningful on thread 0 only
    for (int rnd = 0; rnd < s.rounds; ++rnd) {
        const bool robust = rnd < s.rounds - 1;
        build(T, c, o, pin, lin, robust, red, sys);
        if (tid == 0) {
            float m = 0.f;
            for (int i = 0, k = 0; i < 6; k += 6 - i, ++i) m = fmaxf(m, fabsf(sys[k]));
            lam = TAU * m;
            nu = 2.f;
        }
        for (int it = 0; it < s.iters[rnd]; ++it) {
            bool finite = false;
            if (tid == 0) {
                float d[6];
                finite = solve6(sys, lam, d);
                exp_compose(d, T, Tn);
            }
            __syncthreads();
            build(Tn, c, o, pin, lin, robust, red, sysn);
            if (tid == 0) {
                const float cost = sys[27] + 1e7f * sys[28];
                const float cost_new = sysn[27] + 1e7f * sysn[28];
                if (cost_new < cost && finite) {
                    for (int k = 0; k < 12; ++k) T[k] = Tn[k];
                    for (int k = 0; k < NACC; ++k) sys[k] = sysn[k];
                    lam = lam / 3.f;
                    nu = 2.f;
                } else {
                    lam = lam * nu;
                    nu = nu * 2.f;
                }
            }
            __syncthreads();
        }
        // chi2 re-classification at the round's pose (padded rows stay out)
        for (int i = tid; i < o.n; i += NTHREADS) {
            float P[3], r[3], iz;
            bool in = false;
            if (o.valid[i] && point_residual(T, c, o, i, P, r, iz)) {
                const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * o.isig[i];
                in = chi2 <= (o.stereo[i] ? CHI2_STEREO : CHI2_MONO);
            }
            pin[i] = in;
        }
        for (int i = tid; i < o.nl; i += NTHREADS) {
            float rs, re, J[6];
            bool in = false;
            if (o.lvalid[i]) {
                const bool oks = line_endpoint(T, c, o.l2d + 3 * i, o.sw + 3 * i, rs, J);
                const bool oke = line_endpoint(T, c, o.l2d + 3 * i, o.ew + 3 * i, re, J);
                in = oks && oke && (rs * rs + re * re) * o.isig_l[i] <= CHI2_LINE;
            }
            lin[i] = in;
        }
        __syncthreads();
    }
    if (tid < 16) {
        const int i = tid / 4, j = tid % 4;
        float v;
        if (i == 3) v = j == 3 ? 1.f : 0.f;
        else v = j < 3 ? T[3 * i + j] : T[9 + i];
        Tout[tid] = v;
    }
}

}  // namespace

extern "C" int plslam_pose_lm(const float* Tcw0, const float* xw, const float* obs, const float* isig,
                              const uint8_t* stereo, const uint8_t* valid, int n,
                              const float* sw, const float* ew, const float* l2d, const float* isig_l,
                              const uint8_t* lvalid, int nl,
                              float fx, float fy, float cx, float cy, float bf,
                              int rounds, const int* iters, float* Tout, uint8_t* pin, uint8_t* lin,
                              void* stream) {
    if (n < 0 || nl < 0 || rounds < 1 || rounds > MAX_ROUNDS) return static_cast<int>(cudaErrorInvalidValue);
    Obs o{xw, obs, isig, stereo, valid, n, sw, ew, l2d, isig_l, lvalid, nl};
    Cam c{fx, fy, cx, cy, bf};
    Sched s{};
    s.rounds = rounds;
    for (int r = 0; r < rounds; ++r) s.iters[r] = iters[r];
    pose_lm_kernel<<<1, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(Tcw0, o, c, s, Tout, pin, lin);
    return static_cast<int>(cudaGetLastError());
}
