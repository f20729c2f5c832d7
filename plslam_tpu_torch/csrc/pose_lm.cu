// Kernel B3: the whole motion-only pose LM (points + lines) in one launch,
// one block per problem, up to MAX_PROBLEMS independent problems per launch.
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
// What bounds it on the H100 is latency, not bytes or FLOPs: a solve is a
// chain of 14 dependent block-wide reductions, each followed by a serial
// 6x6 solve, over ~35 KB of inputs (3.3 M float32 operations in all). So
// the design cuts the fixed cost of each pass:
//  - the inputs are staged once into shared memory by bulk async copies
//    (cp.async.bulk, one per array, issued by one thread, completing on an
//    mbarrier armed with the byte count), so no pass reads global memory;
//  - 512 threads, each owning rows tid + k * 512; a row's inlier flag lives
//    in a register bit of its owner, and the chi2 re-classification after
//    a round is fused into the first build of the next round (same pose),
//    so no pass exists only to re-classify;
//  - one __syncthreads per build: a transpose-reduce inside each warp
//    (31 shuffles) leaves lane k with the warp's sum k; the warps write
//    their partials to a double-buffered shared array, meet at one
//    barrier, and then EVERY warp sums the 16 partials in the same fixed
//    order into its own shared row and runs the damped solve, exp(d) T
//    and the accept / lambda update itself. Identical instructions on
//    identical data give every warp the same pose and lambda, so nothing
//    is broadcast and the sums stay deterministic; each warp keeps the
//    current and the candidate system in two shared rows and an accept
//    only swaps them;
//  - 512 threads (not 1024) so that each may hold 128 registers: the 29
//    accumulators, two poses and a row's Jacobian fit without spilling
//    (256 threads measured slower with rows, faster only on empty ones).
// The solve reuses its pivots' reciprocals in the back substitution and
// exp(d) one reciprocal of |phi|, which moves results by float32 rounding
// only.
// Padded rows are skipped before any arithmetic touches their (possibly
// non-finite) values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_ROUNDS = 8;
constexpr int MAX_PROBLEMS = 8;
constexpr int MAX_ROWS = 4096;  // points or lines per problem: 8 rows per thread, one flag bit each
constexpr float CHI2_MONO = 5.991f, CHI2_STEREO = 7.815f, CHI2_LINE = 5.991f;
constexpr float TAU = 1e-5f;
constexpr float SMALL_THETA2 = 1e-3f;
constexpr unsigned FULL = 0xffffffffu;

// The inputs of problem 0; problem p's array k starts st[k] elements
// further (0 for an array every problem shares).
struct Obs {
    const float* xw; const float* obs; const float* isig; const uint8_t* stereo; const uint8_t* valid;
    int n;
    const float* sw; const float* ew; const float* l2d; const float* isig_l; const uint8_t* lvalid;
    int nl;
    long long st[10];  // xw, obs, isig, stereo, valid, sw, ew, l2d, isig_l, lvalid
};
struct Cam { float fx, fy, cx, cy, bf; };
struct Sched { int rounds; unsigned iters; };  // iterations of round r in bits 4r..4r+3

// The same arrays, staged in shared memory.
struct Rows {
    const float* xw; const float* obs; const float* isig; const uint8_t* stereo; const uint8_t* valid;
    const float* sw; const float* ew; const float* l2d; const float* isig_l; const uint8_t* lvalid;
};

// Shared-memory layout: float arrays first, then bytes; every offset and
// size a multiple of 16 because n and nl are (checked by the host entry).
__host__ __device__ inline int smem_bytes(int n, int nl) { return n * (12 + 12 + 4 + 1 + 1) + nl * (12 * 3 + 4 + 1); }

struct Pose { float r[12]; };  // R row-major (9), t (3)

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

__device__ __forceinline__ void to_cam(const Pose& T, float x, float y, float z, float& X, float& Y, float& Z) {
    X = T.r[0] * x + T.r[1] * y + T.r[2] * z + T.r[9];
    Y = T.r[3] * x + T.r[4] * y + T.r[5] * z + T.r[10];
    Z = T.r[6] * x + T.r[7] * y + T.r[8] * z + T.r[11];
}

// Point residual at pose T: r (stereo row zeroed for mono), depth_ok.
__device__ __forceinline__ bool point_residual(const Pose& T, const Cam& c, const Rows& o, int i, bool st,
                                               float* P, float* r, float& iz) {
    to_cam(T, o.xw[3 * i], o.xw[3 * i + 1], o.xw[3 * i + 2], P[0], P[1], P[2]);
    const bool ok = P[2] > 1e-3f;
    iz = 1.f / (ok ? P[2] : 1.f);
    const float u = c.fx * P[0] * iz + c.cx;
    const float v = c.fy * P[1] * iz + c.cy;
    r[0] = o.obs[3 * i] - u;
    r[1] = o.obs[3 * i + 1] - v;
    r[2] = st ? o.obs[3 * i + 2] - (u - c.bf * iz) : 0.f;
    return ok;
}

// One point row at pose T. kClassify: the row is re-classified at T first
// (valid, in front and chi2 under its threshold), the verdict left in
// `in`; otherwise `in` says whether the row is active. kBuild: an active
// row is added to the system.
template <bool kClassify, bool kBuild>
__device__ __forceinline__ void point_row(const Pose& T, const Cam& c, const Rows& o, int i, bool& in,
                                          bool robust, float* acc) {
    if (kClassify) in = o.valid[i] != 0;
    if (!in) return;  // padded / rejected rows: no arithmetic on their values
    const bool st = o.stereo[i];
    float P[3], r[3], iz;
    const bool ok = point_residual(T, c, o, i, st, P, r, iz);
    const float isig = o.isig[i];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * isig;
    const float delta2 = st ? CHI2_STEREO : CHI2_MONO;
    if (kClassify) in = ok && chi2 <= delta2;
    if (!kBuild || !in) return;
    if (!ok) {
        acc[28] += 1.f;  // behind the camera: raises the cost, not the system
        return;
    }
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
__device__ __forceinline__ bool line_endpoint(const Pose& T, const Cam& c, const float* l, const float* E,
                                              float& r, float* J) {
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

template <bool kClassify, bool kBuild>
__device__ __forceinline__ void line_row(const Pose& T, const Cam& c, const Rows& o, int i, bool& in,
                                         bool robust, float* acc) {
    if (kClassify) in = o.lvalid[i] != 0;
    if (!in) return;
    float rs, re, Js[6], Je[6];
    const bool oks = line_endpoint(T, c, o.l2d + 3 * i, o.sw + 3 * i, rs, Js);
    const bool oke = line_endpoint(T, c, o.l2d + 3 * i, o.ew + 3 * i, re, Je);
    const float isig = o.isig_l[i];
    const float chi2 = (rs * rs + re * re) * isig;
    if (kClassify) in = oks && oke && chi2 <= CHI2_LINE;
    if (!kBuild || !in) return;
    if (!(oks && oke)) {
        acc[28] += 1.f;
        return;
    }
    const float w = huber_w(chi2, CHI2_LINE, robust) * isig;
    acc[27] += huber_rho(chi2, CHI2_LINE, robust);
    add_row(acc, Js, rs, w);
    add_row(acc, Je, re, w);
}

// One step of the warp's transpose-reduce: each lane keeps the half of its
// 2S live slots selected by its lane bit S and adds the partner lane's copy
// of that half. After the steps 16, 8, 4, 2, 1 lane k holds the warp's sum
// of slot k.
template <int S>
__device__ __forceinline__ void transpose_step(float* acc, int lane) {
    const bool upper = lane & S;
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const float lo = acc[j], hi = acc[j + S];
        acc[j] = (upper ? hi : lo) + __shfl_xor_sync(FULL, upper ? lo : hi, S);
    }
}

// One build pass over the thread's rows at pose T, the active ones given
// by the flag bits (bit k: row tid + k * NTHREADS); kClassify re-classifies
// every row at T first and updates the bits. Every warp leaves the block's
// 29 sums in its own shared row `out` (lane k sums slot k over the warps'
// partials in `red`, in warp order). One __syncthreads.
template <bool kClassify>
__device__ __forceinline__ void build(const Pose& T, const Cam& c, const Rows& o, int n, int nl, bool robust,
                                      uint32_t& pbits, uint32_t& lbits, float (*red)[32], float* out) {
    float acc[32];  // H upper triangle (21, row-major), b (6), rho sum, behind-camera count, 3 unused
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    const int tid = threadIdx.x;
#pragma unroll 1
    for (int k = 0, i = tid; i < n; ++k, i += NTHREADS) {
        bool in = (pbits >> k) & 1u;
        point_row<kClassify, true>(T, c, o, i, in, robust, acc);
        pbits = (pbits & ~(1u << k)) | (static_cast<uint32_t>(in) << k);
    }
#pragma unroll 1
    for (int k = 0, i = tid; i < nl; ++k, i += NTHREADS) {
        bool in = (lbits >> k) & 1u;
        line_row<kClassify, true>(T, c, o, i, in, robust, acc);
        lbits = (lbits & ~(1u << k)) | (static_cast<uint32_t>(in) << k);
    }
    const int lane = tid & 31;
    transpose_step<16>(acc, lane);
    transpose_step<8>(acc, lane);
    transpose_step<4>(acc, lane);
    transpose_step<2>(acc, lane);
    transpose_step<1>(acc, lane);
    red[tid >> 5][lane] = acc[0];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][lane];
    out[lane] = sum;
    __syncwarp();
}

// (H + (lam + 1e-9) I) d = b by unpivoted LU, from the warp's shared copy
// of the system (H + lam I is SPD when the system is not degenerate; a
// degenerate one gives a non-finite d, which the caller rejects); the
// back substitution multiplies by the pivots' reciprocals. Returns whether
// d is finite.
__device__ __forceinline__ bool solve6(const float* sys, float lam, float* d) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const float4 q = reinterpret_cast<const float4*>(sys)[k];
        v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z; v[4 * k + 3] = q.w;
    }
    float a[6][6], inv[6];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = v[k++];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        a[i][i] += lam + 1e-9f;
        d[i] = v[21 + i];
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) {
        inv[p] = 1.f / a[p][p];
#pragma unroll
        for (int i = p + 1; i < 6; ++i) {
            const float f = a[i][p] * inv[p];
#pragma unroll
            for (int j = p + 1; j < 6; ++j) a[i][j] -= f * a[p][j];
            d[i] -= f * d[p];
        }
    }
    bool finite = true;
#pragma unroll
    for (int p = 5; p >= 0; --p) {
        float s = d[p];
#pragma unroll
        for (int j = p + 1; j < 6; ++j) s -= a[p][j] * d[j];
        d[p] = s * inv[p];
        finite = finite && isfinite(d[p]);
    }
    return finite;
}

// out = exp(d) * T for twist d = (rho, phi).
__device__ __forceinline__ void exp_compose(const float* d, const Pose& T, Pose& out) {
    const float p0 = d[3], p1 = d[4], p2 = d[5];
    const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
    const bool small = theta2 < SMALL_THETA2;
    const float t2 = small ? 1.f : theta2;
    const float th = sqrtf(t2), ith = 1.f / th;
    float sn, cs;
    sincosf(th, &sn, &cs);
    const float A = small ? 1.f - theta2 / 6.f + theta2 * theta2 / 120.f : sn * ith;
    const float B = small ? 0.5f - theta2 / 24.f + theta2 * theta2 / 720.f : (1.f - cs) * (ith * ith);
    const float C = small ? 1.f / 6.f - theta2 / 120.f + theta2 * theta2 / 5040.f : (th - sn) * (ith * ith * ith);
    const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
    float R[3][3], V[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float K2 = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
            const float I = i == j ? 1.f : 0.f;
            R[i][j] = I + A * K[i][j] + B * K2;
            V[i][j] = I + B * K[i][j] + C * K2;
        }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float t = V[i][0] * d[0] + V[i][1] * d[1] + V[i][2] * d[2];
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out.r[3 * i + j] = R[i][0] * T.r[j] + R[i][1] * T.r[3 + j] + R[i][2] * T.r[6 + j];
        out.r[9 + i] = R[i][0] * T.r[9] + R[i][1] * T.r[10] + R[i][2] * T.r[11] + t;
    }
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

__device__ __forceinline__ void bulk_copy(const void* dst, const void* src, int bytes, uint32_t bar) {
    if (bytes == 0) return;
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src), "r"(bytes), "r"(bar)
                 : "memory");
}

__global__ void __launch_bounds__(NTHREADS, 1)
pose_lm_kernel(const float* __restrict__ Tcw0, long long t0_stride, Obs g, Cam c, Sched s, float* __restrict__ Tout,
               uint8_t* __restrict__ pin, uint8_t* __restrict__ lin) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ float red[2][NWARPS][32];
    __shared__ __align__(16) float sysw[NWARPS][2][32];  // each warp's copy of the current and candidate systems
    __shared__ __align__(8) uint64_t bar_mem;
    const int tid = threadIdx.x, prob = blockIdx.x;
    const int n = g.n, nl = g.nl;

    // ---- stage this problem's rows: one bulk copy per array
    Rows o;
    o.xw = reinterpret_cast<const float*>(smem);
    o.obs = o.xw + 3 * n;
    o.isig = o.obs + 3 * n;
    o.sw = o.isig + n;
    o.ew = o.sw + 3 * nl;
    o.l2d = o.ew + 3 * nl;
    o.isig_l = o.l2d + 3 * nl;
    o.stereo = reinterpret_cast<const uint8_t*>(o.isig_l + nl);
    o.valid = o.stereo + n;
    o.lvalid = o.valid + n;
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&bar_mem));
    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(bar), "r"(smem_bytes(n, nl)) : "memory");
        bulk_copy(o.xw, g.xw + prob * g.st[0], 12 * n, bar);
        bulk_copy(o.obs, g.obs + prob * g.st[1], 12 * n, bar);
        bulk_copy(o.isig, g.isig + prob * g.st[2], 4 * n, bar);
        bulk_copy(o.stereo, g.stereo + prob * g.st[3], n, bar);
        bulk_copy(o.valid, g.valid + prob * g.st[4], n, bar);
        if (nl > 0) {
            bulk_copy(o.sw, g.sw + prob * g.st[5], 12 * nl, bar);
            bulk_copy(o.ew, g.ew + prob * g.st[6], 12 * nl, bar);
            bulk_copy(o.l2d, g.l2d + prob * g.st[7], 12 * nl, bar);
            bulk_copy(o.isig_l, g.isig_l + prob * g.st[8], 4 * nl, bar);
            bulk_copy(o.lvalid, g.lvalid + prob * g.st[9], nl, bar);
        }
    }
    Pose T;
    const float* T0 = Tcw0 + prob * t0_stride;
#pragma unroll
    for (int k = 0; k < 9; ++k) T.r[k] = T0[(k / 3) * 4 + k % 3];
#pragma unroll
    for (int k = 0; k < 3; ++k) T.r[9 + k] = T0[k * 4 + 3];
    __syncthreads();  // the mbarrier is initialised before anyone waits on it
    mbar_wait(bar, 0);

    // this thread's rows' inlier flags, starting at valid
    uint32_t pbits = 0u, lbits = 0u;
    for (int k = 0, i = tid; i < n; ++k, i += NTHREADS) pbits |= static_cast<uint32_t>(o.valid[i] != 0) << k;
    for (int k = 0, i = tid; i < nl; ++k, i += NTHREADS) lbits |= static_cast<uint32_t>(o.lvalid[i] != 0) << k;
    int buf = 0;  // which half of `red` the next build writes
    int cur = 0;  // which of the warp's two system rows holds the current system
    float* mine = sysw[tid >> 5][0];
    for (int rnd = 0; rnd < s.rounds; ++rnd) {
        const bool robust = rnd < s.rounds - 1;
        // the round's first build, at the pose the last round ended on,
        // re-classifies the rows there first (round 0 starts from valid)
        if (rnd == 0) build<false>(T, c, o, n, nl, robust, pbits, lbits, red[buf], mine + 32 * cur);
        else build<true>(T, c, o, n, nl, robust, pbits, lbits, red[buf], mine + 32 * cur);
        buf ^= 1;
        const float* sys = mine + 32 * cur;
        float lam = TAU * fmaxf(fmaxf(fmaxf(fabsf(sys[0]), fabsf(sys[6])), fmaxf(fabsf(sys[11]), fabsf(sys[15]))),
                                fmaxf(fabsf(sys[18]), fabsf(sys[20])));
        float nu = 2.f;
        for (int it = 0; it < static_cast<int>((s.iters >> (4 * rnd)) & 15u); ++it) {
            float d[6];
            const bool finite = solve6(mine + 32 * cur, lam, d);
            Pose Tn;
            exp_compose(d, T, Tn);
            build<false>(Tn, c, o, n, nl, robust, pbits, lbits, red[buf], mine + 32 * (cur ^ 1));
            buf ^= 1;
            const float* so = mine + 32 * cur;
            const float* sn = mine + 32 * (cur ^ 1);
            const float cost = so[27] + 1e7f * so[28];
            const float cost_new = sn[27] + 1e7f * sn[28];
            if (cost_new < cost && finite) {
                T = Tn;
                cur ^= 1;
                lam = lam / 3.f;
                nu = 2.f;
            } else {
                lam = lam * nu;
                nu = nu * 2.f;
            }
        }
    }
    // ---- final re-classification at the solved pose; no reduction
    const size_t pn = static_cast<size_t>(prob) * n, pl = static_cast<size_t>(prob) * nl;
    for (int i = tid; i < n; i += NTHREADS) {
        bool in;
        point_row<true, false>(T, c, o, i, in, false, nullptr);
        pin[pn + i] = in;
    }
    for (int i = tid; i < nl; i += NTHREADS) {
        bool in;
        line_row<true, false>(T, c, o, i, in, false, nullptr);
        lin[pl + i] = in;
    }
    if (tid == 0) {
        float* out = Tout + 16 * prob;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) out[4 * i + j] = T.r[3 * i + j];
            out[4 * i + 3] = T.r[9 + i];
        }
        out[12] = out[13] = out[14] = 0.f;
        out[15] = 1.f;
    }
}

// The dynamic shared memory one block may stage rows in: the device's
// opt-in limit per block less the kernel's static shared memory. Queried
// once per process (one device).
cudaError_t smem_limit(int* out) {
    static int limit = -1;
    if (limit < 0) {
        int dev = 0, optin = 0;
        cudaFuncAttributes attr;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, pose_lm_kernel);
        if (e != cudaSuccess) return e;
        limit = optin - static_cast<int>(attr.sharedSizeBytes);
    }
    *out = limit;
    return cudaSuccess;
}

}  // namespace

// -> in *bytes, the most row bytes (30 N + 41 L) one problem may have.
extern "C" int plslam_pose_lm_smem_limit(int* bytes) { return static_cast<int>(smem_limit(bytes)); }

// Tcw0 f32[P, 4, 4]; points f32[P, N, 3] x2, f32[P, N], u8[P, N] x2;
// lines f32[P, L, 3] x3, f32[P, L], u8[P, L] (or L = 0 and null
// pointers) -> Tout f32[P, 4, 4], pin u8[P, N], lin u8[P, L]. strides[k]:
// the problem stride in elements of Tcw0 and of the ten input arrays in
// argument order, each 0 (shared by all problems) or a whole number of
// 16-byte units.
extern "C" int plslam_pose_lm(const float* Tcw0, const float* xw, const float* obs, const float* isig,
                              const uint8_t* stereo, const uint8_t* valid, int n,
                              const float* sw, const float* ew, const float* l2d, const float* isig_l,
                              const uint8_t* lvalid, int nl, int problems, const long long* strides,
                              float fx, float fy, float cx, float cy, float bf,
                              int rounds, const int* iters, float* Tout, uint8_t* pin, uint8_t* lin,
                              void* stream) {
    const int bytes = smem_bytes(n, nl);
    int limit = 0;
    const cudaError_t le = smem_limit(&limit);
    if (le != cudaSuccess) return static_cast<int>(le);
    if (n < 16 || n > MAX_ROWS || n % 16 || nl < 0 || nl > MAX_ROWS || nl % 16 || problems < 1 ||
        problems > MAX_PROBLEMS || rounds < 1 || rounds > MAX_ROUNDS || bytes > limit)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* ptrs[] = {xw, obs, isig, stereo, valid, sw, ew, l2d, isig_l, lvalid};
    const int esize[] = {4, 4, 4, 1, 1, 4, 4, 4, 4, 1};
    Obs o{xw, obs, isig, stereo, valid, n, sw, ew, l2d, isig_l, lvalid, nl, {}};
    for (int k = 0; k < 10; ++k) {
        o.st[k] = strides[1 + k];
        if (k >= 5 && nl == 0) continue;
        if (reinterpret_cast<uintptr_t>(ptrs[k]) % 16 || (o.st[k] * esize[k]) % 16 || o.st[k] < 0)
            return static_cast<int>(cudaErrorMisalignedAddress);
    }
    Cam c{fx, fy, cx, cy, bf};
    Sched s{};
    s.rounds = rounds;
    for (int r = 0; r < rounds; ++r) {
        if (iters[r] < 0 || iters[r] > 15) return static_cast<int>(cudaErrorInvalidValue);
        s.iters |= static_cast<unsigned>(iters[r]) << (4 * r);
    }
    static int opted_in = 48 * 1024;  // dynamic shared memory the kernel may take without opting in
    if (bytes > opted_in) {
        cudaError_t e = cudaFuncSetAttribute(pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = bytes;
    }
    pose_lm_kernel<<<problems, NTHREADS, bytes, static_cast<cudaStream_t>(stream)>>>(Tcw0, strides[0], o, c, s, Tout, pin, lin);
    return static_cast<int>(cudaGetLastError());
}
