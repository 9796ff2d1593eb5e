// The bundle adjustment's Levenberg-Marquardt body for Hopper (sm_90a):
// the λ-free system at an iterate, the damped Schur reduction, and the
// back-substitution, candidate cost and LM update, a launch each.
//
// Replaces what the JAX package's jitted lm_loop runs as XLA fusions in each
// body (stereo_vo_tpu/backend/schur.py): _build_system :438 (with
// reprojection_jacobians, backend/residuals.py), _damp_reduce :519, the
// back-substitution of _solve_from_system :596, _lm_major_cost :383 on the
// candidate and the body's scalar bookkeeping in lm_loop :661. None is a
// Pallas kernel there. The plain versions are
// stereo_vo_tpu_torch/backend/schur.py::_build_system, ::_reduced_system
// (_damp_reduce and the solve's 1e-10 I), ::_ba_step_ref and
// ::_lm_major_cost_ref. The reduced [6W, 6W] LU solve between the second
// and the third kernel stays a library call, as it is XLA's LU custom call
// in the reference.
//
// Entry points (each launch writes what it returns; nothing is read back):
//  svo_ba_build        v [L,3,3] (prior included), g_l [L,3], wl [L,W,6,3],
//                      lm_active [L], free [W], and u_blocks [W,6,6], g_p
//                      [W,6] summed over the landmarks;
//  svo_ba_damp_reduce  v_inv [L,3,3] of the damped blocks, the [6W+1]^2
//                      Gram msum of [wl | g_l] against v_inv summed over the
//                      landmarks, then s [6W,6W] (damped pose blocks, gauge
//                      identity, -msum, + 1e-10 I), rhs [6W] and a copy of
//                      rhs for the refinement's residual;
//  svo_ba_step         delta_p = (delta + corr) * free, the retracted poses,
//                      delta_l = v_inv (g_l - wl^T delta_p), the candidate's
//                      Huber cost plus prior, the predicted decrease, then
//                      the accept test and the new carry (poses, lm_pos,
//                      lam, nu, cost, rel, done, accepted, it, ok);
//  svo_ba_cost         the Huber cost plus prior at an iterate.
// A landmark-sharded solve (a process group) sums u_blocks / g_p, msum and
// (cost, pred_l) over its ranks between launches: svo_ba_damp_reduce and
// svo_ba_step then run in two modes, the landmark part writing the sums and
// a one-block launch finishing from the all-reduced ones.
//
// Rounding: every elementwise step is the plain version's, in its order,
// each product and sum rounded on its own (this file is built with
// --fmad=false, as torch's CUDA kernels round) and IEEE division and square
// root (torch.sqrt, sqrt_f32's root on the card). A sum over the landmarks
// (u_blocks, g_p, the Gram msum, the costs and the predicted decrease) adds
// each landmark's float32 term, rounded as the plain version rounds it, in
// double and rounds once: within a warp a fixed shuffle tree, then warps,
// then blocks in index order, so its float32 result hardly depends on the
// order (torch's reductions take orders of their own). There is no
// floating-point atomic: each block writes its partial sums, and the last
// block to finish (a ticket counter that it resets itself, so graph replays
// find it at zero) adds them. Every launch gives the same bits.
//
// What bounds it on this card: neither bytes nor operations, at the shipped
// shapes (W = 5, L = 512 or 2048). ba_build reads 40 B and writes 448 B per
// landmark (1 MB at L = 2048, 0.3 us at 3.35 TB/s) and does about 3,000 f32
// operations per landmark (6 MFLOP, 0.1 us at 67 TFLOP/s); the other kernels
// less. The time is the chain of dependent steps: a landmark's W Jacobians
// in one thread, the warp and block trees, and the last block's sum over
// the blocks and its serial epilogue. The design keeps the body to these
// launches (with the LU's library kernels) where the plain version
// launches hundreds of small torch kernels, and keeps every intermediate
// per landmark in registers or shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWMax = 32;             // window sizes handled (shipped: 5)
constexpr int kBuildThreads = 128;    // one landmark per thread
constexpr int kStepThreads = 128;
constexpr int kDampThreads = 256;
constexpr int kDampMaxBlocks = 256;
constexpr int kDampSmem = 48 * 1024;  // static limit, no attribute needed
constexpr int kUniq = 21;             // upper triangle of a 6 x 6 block
constexpr int kPerPose = kUniq + 6;   // and the pose gradient
constexpr int kWarps = kBuildThreads / 32;

enum { kTicketBuild, kTicketDamp, kTicketStep, kTicketCost, kTickets };
__device__ unsigned int g_tickets[kTickets];

__constant__ int kTriA[kUniq] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int kTriB[kUniq] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

enum { kModeFull = 0, kModeSums = 1, kModeFinish = 2 };

}  // namespace

// The landmark-major problem (backend/schur.py::LandmarkMajorProblem) and
// the camera and config constants the kernels read; bools are bytes.
struct SvoBAProblem {
    const float* obs_uv;              // [L, W, 2]
    const unsigned char* obs_valid;   // [L, W]
    const unsigned char* pose_valid;  // [W]
    const unsigned char* lm_valid;    // [L]
    const float* lm_prior;            // [L, 3]
    const float* lm_prior_w;          // [L]
    int L, W;
    float focal, cx, cy, min_depth, huber;
};

// backend/schur.py::BASystem
struct SvoBASystem {
    float* v;                  // [L, 3, 3]
    float* g_l;                // [L, 3]
    float* wl;                 // [L, W, 6, 3]
    float* u_blocks;           // [W, 6, 6]
    float* g_p;                // [W, 6]
    unsigned char* lm_active;  // [L]
    unsigned char* free_;      // [W]
};

// backend/schur.py::_LMCarry without its system: ``in`` the carry a body
// starts from, ``out`` the one it hands on (and ok, the accept flag)
struct SvoLMCarry {
    float* poses;          // [W, 7]
    float* lm_pos;         // [L, 3]
    float* lam;            // each []
    float* nu;
    float* cost;
    float* rel;
    unsigned char* done;
    int* accepted;
    int* it;
    unsigned char* ok;     // out only
};

struct SvoLMConfig {
    float tol, min_damping, max_damping;
};

namespace {

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : (x < lo ? lo : x);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    if (isnan(x)) return x;
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
}

__device__ __forceinline__ double warp_sum(double x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    return x;  // in lane 0
}

// Every thread's write before this is visible to the block that finds it
// last; that block alone returns true.
__device__ bool arrive_last(unsigned int* ticket) {
    __shared__ unsigned int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    return last != 0;
}

// sum of K values over the block (kStepThreads threads), in thread 0
template <int K>
__device__ void block_sums(const float (&x)[K], double* out) {
    __shared__ double red[kStepThreads / 32][K];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int k = 0; k < K; ++k) {
        const double s = warp_sum(x[k]);
        if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < K) {
        double s = red[0][threadIdx.x];
        for (int w = 1; w < kStepThreads / 32; ++w) s += red[w][threadIdx.x];
        out[threadIdx.x] = s;
    }
}

// sum over the blocks, in block order, of one partial per block (entry k of
// each block's partials)
__device__ double blocks_sum(const double* partial, int k, int stride, int nb) {
    double s = __ldcg(partial + k);
    for (int b = 1; b < nb; ++b) s += __ldcg(partial + (size_t)b * stride + k);
    return s;
}

// rot_apply(q, p) + t (core/geometry.py) for a pose [q(4), t(3)]
__device__ void transform(const float* pose, const float* p, float* g) {
    const float w = pose[0];
    const float v[3] = {pose[1], pose[2], pose[3]};
    const float n2 = ((w * w + v[0] * v[0]) + v[1] * v[1]) + v[2] * v[2];
    const float vxp[3] = {v[1] * p[2] - v[2] * p[1], v[2] * p[0] - v[0] * p[2],
                          v[0] * p[1] - v[1] * p[0]};
    const float vdotp = (v[0] * p[0] + v[1] * p[1]) + v[2] * p[2];
    const float vdotv = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
    const float a = 2.0f * vdotp, b = w * w - vdotv, c = 2.0f * w;
    for (int k = 0; k < 3; ++k) g[k] = ((a * v[k] + b * p[k]) + c * vxp[k]) / n2 + pose[4 + k];
}

// _huber_rho of a masked-in observation (reprojection_residual, the Huber
// loss on |r|; huber <= 0: squares)
__device__ float obs_rho(const float* pose, const float* p, const float* obs,
                         const SvoBAProblem& pr, bool valid) {
    float g[3];
    transform(pose, p, g);
    if (!(valid && g[2] > pr.min_depth)) return 0.0f;   // masked: r = 0, rho 0
    const float r0 = ((g[0] / g[2]) * pr.focal + pr.cx) - obs[0];
    const float r1 = ((g[1] / g[2]) * pr.focal + pr.cy) - obs[1];
    const float sq = r0 * r0 + r1 * r1;
    if (pr.huber <= 0.0f) return 0.5f * sq;
    const float norm = sqrtf(sq + 1e-12f);
    return norm <= pr.huber ? 0.5f * sq : pr.huber * (norm - 0.5f * pr.huber);
}

// landmark l's Huber sum over its observations and its prior term
// (pw dp dp summed over xyz) at poses (shared) and point p
__device__ void landmark_cost(const float* poses, const float* p, int l,
                              const SvoBAProblem& pr, float& huber, float& prior) {
    const bool lv = pr.lm_valid[l] != 0;
    huber = 0.0f;
    for (int w = 0; w < pr.W; ++w) {
        const size_t o = (size_t)l * pr.W + w;
        const bool valid = pr.obs_valid[o] && pr.pose_valid[w] && lv;
        const float rho = obs_rho(poses + 7 * w, p, pr.obs_uv + 2 * o, pr, valid);
        huber += rho;
    }
    const float pw = lv ? pr.lm_prior_w[l] : 0.0f;
    prior = 0.0f;
    for (int c = 0; c < 3; ++c) {
        const float dp = p[c] - pr.lm_prior[3 * l + c];
        prior += (pw * dp) * dp;
    }
}

// One observation's rows of [jp6 | jl | r] as _build_system forms them:
// reprojection_jacobians (backend/residuals.py), the mask, the square root
// of the Huber weight on both rows, the quaternion lift; zero when masked.
__device__ void obs_rows(const float* pose, const float* p, const float* obs, bool valid,
                         const SvoBAProblem& pr, float rows[2][10]) {
    const float w = pose[0];
    const float q[4] = {pose[0], pose[1], pose[2], pose[3]};
    const float v[3] = {pose[1], pose[2], pose[3]};
    const float n2 = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3];
    const float vdotp = (v[0] * p[0] + v[1] * p[1]) + v[2] * p[2];
    const float vdotv = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
    const float vxp[3] = {v[1] * p[2] - v[2] * p[1], v[2] * p[0] - v[0] * p[2],
                          v[0] * p[1] - v[1] * p[0]};
    const float ww_vv = w * w - vdotv;
    float u[3], g[3];
    for (int k = 0; k < 3; ++k) {
        u[k] = ((2.0f * vdotp) * v[k] + ww_vv * p[k]) + (2.0f * w) * vxp[k];
        g[k] = u[k] / n2 + pose[4 + k];
    }
    if (!(valid && g[2] > pr.min_depth)) {
        for (int r = 0; r < 2; ++r)
            for (int k = 0; k < 10; ++k) rows[r][k] = 0.0f;
        return;
    }
    const float f = pr.focal;
    const float inv_z = 1.0f / g[2];
    const float dr_dg[2][3] = {{f * inv_z, 0.0f, (-f) * g[0] * inv_z * inv_z},
                               {0.0f, f * inv_z, (-f) * g[1] * inv_z * inv_z}};
    const float eye[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    const float skew_p[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
    const float skew_v[3][3] = {{0.0f, -v[2], v[1]}, {v[2], 0.0f, -v[0]}, {-v[1], v[0], 0.0f}};
    const float n2n2 = n2 * n2;
    float dg_dq[3][4], rmat[3][3];
    for (int i = 0; i < 3; ++i) {
        float du_dq[4];
        du_dq[0] = 2.0f * (w * p[i] + vxp[i]);
        for (int j = 0; j < 3; ++j)
            du_dq[1 + j] = 2.0f * (((v[i] * p[j] + vdotp * eye[i][j]) - p[i] * v[j])
                                   - w * skew_p[i][j]);
        for (int j = 0; j < 4; ++j) dg_dq[i][j] = du_dq[j] / n2 - ((2.0f * u[i]) * q[j]) / n2n2;
        for (int j = 0; j < 3; ++j)
            rmat[i][j] = ((2.0f * (v[i] * v[j]) + ww_vv * eye[i][j]) + (2.0f * w) * skew_v[i][j])
                         / n2;
    }
    const float lift[4][3] = {{-q[1], -q[2], -q[3]}, {w, q[3], -q[2]},
                              {-q[3], w, q[1]}, {q[2], -q[1], w}};
    float r[2] = {((g[0] * inv_z) * f + pr.cx) - obs[0], ((g[1] * inv_z) * f + pr.cy) - obs[1]};
    float sw = 1.0f;
    if (pr.huber > 0.0f) {
        const float norm = sqrtf((r[0] * r[0] + r[1] * r[1]) + 1e-12f);
        float wt = pr.huber / norm;
        wt = wt > 1.0f ? 1.0f : wt;
        sw = sqrtf(wt);
    }
    for (int k = 0; k < 2; ++k) {
        float jq7[4];
        for (int j = 0; j < 4; ++j)
            jq7[j] = (dr_dg[k][0] * dg_dq[0][j] + dr_dg[k][1] * dg_dq[1][j])
                     + dr_dg[k][2] * dg_dq[2][j];
        for (int c = 0; c < 3; ++c) {
            const float jq = ((jq7[0] * lift[0][c] + jq7[1] * lift[1][c]) + jq7[2] * lift[2][c])
                             + jq7[3] * lift[3][c];
            rows[k][c] = jq * sw;
            rows[k][3 + c] = dr_dg[k][c] * sw;
            const float jl = (dr_dg[k][0] * rmat[0][c] + dr_dg[k][1] * rmat[1][c])
                             + dr_dg[k][2] * rmat[2][c];
            rows[k][6 + c] = jl * sw;
        }
        rows[k][9] = r[k] * sw;
    }
}

// ---------------------------------------------------------------------------
// ba_build: one thread per landmark over its W observations

__global__ void __launch_bounds__(kBuildThreads)
ba_build_kernel(const float* __restrict__ poses, const float* __restrict__ lm_pos,
                SvoBAProblem pr, SvoBASystem sys, double* __restrict__ partial) {
    extern __shared__ double red[];    // [kWarps][W * kPerPose]
    const int W = pr.W, L = pr.L, per = W * kPerPose;
    const int l = blockIdx.x * kBuildThreads + threadIdx.x;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool live = l < L;
    float p[3] = {0.0f, 0.0f, 0.0f};
    bool lv = false;
    if (live) {
        for (int c = 0; c < 3; ++c) p[c] = lm_pos[3 * l + c];
        lv = pr.lm_valid[l] != 0;
    }
    float vacc[3][3] = {}, gacc[3] = {};
    for (int w = 0; w < W; ++w) {
        float rows[2][10];
        if (live) {
            const size_t o = (size_t)l * W + w;
            const bool valid = pr.obs_valid[o] && pr.pose_valid[w] && lv;
            obs_rows(poses + 7 * w, p, pr.obs_uv + 2 * o, valid, pr, rows);
            float* wl = sys.wl + o * 18;
            for (int a = 0; a < 6; ++a)
                for (int c = 0; c < 3; ++c)
                    wl[3 * a + c] = rows[0][a] * rows[0][6 + c] + rows[1][a] * rows[1][6 + c];
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 3; ++j)
                    vacc[i][j] += rows[0][6 + i] * rows[0][6 + j] + rows[1][6 + i] * rows[1][6 + j];
                gacc[i] += rows[0][6 + i] * rows[0][9] + rows[1][6 + i] * rows[1][9];
            }
        } else {
            for (int r = 0; r < 2; ++r)
                for (int k = 0; k < 10; ++k) rows[r][k] = 0.0f;
        }
        // the pose blocks' entries (upper triangle, then the gradient), in
        // kTriA / kTriB's order; unrolled, so the rows stay in registers
        double* mine = red + warp * per + w * kPerPose;
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
            for (int b = a; b < 6; ++b, ++k) {
                const double s = warp_sum(rows[0][a] * rows[0][b] + rows[1][a] * rows[1][b]);
                if (lane == 0) mine[k] = s;
            }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
            const double s = warp_sum(rows[0][a] * rows[0][9] + rows[1][a] * rows[1][9]);
            if (lane == 0) mine[kUniq + a] = s;
        }
    }
    if (live) {
        const float pw = lv ? pr.lm_prior_w[l] : 0.0f;
        float* v = sys.v + 9 * l;
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) v[3 * i + j] = vacc[i][j] + pw * (i == j ? 1.0f : 0.0f);
        for (int c = 0; c < 3; ++c)
            sys.g_l[3 * l + c] = -gacc[c] + pw * (pr.lm_prior[3 * l + c] - p[c]);
        const float trace = (v[0] + v[4]) + v[8];
        sys.lm_active[l] = lv && trace > 0.0f;
    }
    if (blockIdx.x == 0 && threadIdx.x < W) sys.free_[threadIdx.x] = pr.pose_valid[threadIdx.x] && threadIdx.x > 0;
    __syncthreads();
    for (int k = threadIdx.x; k < per; k += kBuildThreads) {
        double s = red[k];
        for (int wp = 1; wp < kWarps; ++wp) s += red[wp * per + k];
        partial[(size_t)blockIdx.x * per + k] = s;
    }
    if (!arrive_last(&g_tickets[kTicketBuild])) return;
    for (int k = threadIdx.x; k < per; k += kBuildThreads) {
        const float s = static_cast<float>(blocks_sum(partial, k, per, gridDim.x));
        const int w = k / kPerPose, e = k % kPerPose;
        if (e < kUniq) {
            const int a = kTriA[e], b = kTriB[e];
            sys.u_blocks[36 * w + 6 * a + b] = s;
            sys.u_blocks[36 * w + 6 * b + a] = s;
        } else {
            sys.g_p[6 * w + e - kUniq] = -s;
        }
    }
    if (threadIdx.x == 0) g_tickets[kTicketBuild] = 0;
}

// ---------------------------------------------------------------------------
// ba_damp_reduce: blocks stride over chunks of `lpb` landmarks

// _inv3x3 of the damped block (_damp: lam * clamp(diag, 1e-8, 1e32) on
// the diagonal), eps 1e-6, zero for an inactive landmark
__device__ void damped_inverse(const float* v, float lam, bool active, float* out) {
    float m[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const float dd = lam * clamp(v[4 * j], 1e-8f, 1e32f);
            m[3 * i + j] = v[3 * i + j] + (i == j ? 1.0f : 0.0f) * dd;
            m[3 * i + j] = m[3 * i + j] + 1e-6f * (i == j ? 1.0f : 0.0f);
        }
    const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];
    const float g = m[6], h = m[7], i = m[8];
    const float co_a = e * i - f * h;
    const float co_b = -(d * i - f * g);
    const float co_c = d * h - e * g;
    const float det = (a * co_a + b * co_b) + c * co_c;
    const float inv_det = 1.0f / det;
    const float adj[9] = {co_a, -(b * i - c * h), b * f - c * e,
                          co_b, a * i - c * g, -(a * f - c * d),
                          co_c, -(a * h - b * g), a * e - b * d};
    for (int k = 0; k < 9; ++k) out[k] = active ? adj[k] * inv_det : 0.0f;
}

// the damped, gauge-fixed s [n6, n6] (+ 1e-10 I), rhs and its copy from msum
__device__ void assemble(const float* msum, const SvoBASystem& sys, float lam, int W,
                         float* s, float* rhs, float* resid) {
    const int n6 = 6 * W, n1 = n6 + 1;
    for (int idx = threadIdx.x; idx < n6 * n6; idx += blockDim.x) {
        const int row = idx / n6, col = idx % n6;
        const int w = row / 6, a = row % 6, wv = col / 6, b = col % 6;
        float x = -msum[row * n1 + col];
        if (w == wv) {
            const float* u = sys.u_blocks + 36 * w;
            const float dd = lam * clamp(u[7 * b], 1e-8f, 1e32f);
            x = x + (u[6 * a + b] + (a == b ? 1.0f : 0.0f) * dd);
        }
        const float fw = sys.free_[w] ? 1.0f : 0.0f, fv = sys.free_[wv] ? 1.0f : 0.0f;
        x = (x * fw) * fv;
        x = x + ((w == wv && a == b) ? 1.0f - fw : 0.0f);
        if (row == col) x = x + 1e-10f;
        s[idx] = x;
    }
    for (int row = threadIdx.x; row < n6; row += blockDim.x) {
        const float fw = sys.free_[row / 6] ? 1.0f : 0.0f;
        const float r = (sys.g_p[row] - msum[row * n1 + n6]) * fw;
        rhs[row] = r;
        if (resid) resid[row] = r;
    }
}

__global__ void __launch_bounds__(kDampThreads)
ba_damp_reduce_kernel(SvoBASystem sys, const float* __restrict__ lam_p, int L, int W, int lpb,
                      int mode, float* __restrict__ v_inv, double* __restrict__ partial,
                      float* __restrict__ msum, float* __restrict__ s, float* __restrict__ rhs,
                      float* __restrict__ resid) {
    const float lam = *lam_p;
    const int n6 = 6 * W, n1 = n6 + 1, nn = n1 * n1;
    if (mode != kModeFinish) {
        extern __shared__ float smem[];
        float* wlg = smem;                          // [lpb][n1][3]
        float* av = wlg + (size_t)lpb * n1 * 3;     // [lpb][n1][3]: wlg v_inv
        float* vi = av + (size_t)lpb * n1 * 3;      // [lpb][9]
        double* mine = partial + (size_t)blockIdx.x * nn;
        const int chunks = (L + lpb - 1) / lpb;
        bool first = true;
        for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
            const int l0 = chunk * lpb, nl = min(lpb, L - l0);
            for (int idx = threadIdx.x; idx < nl * n1 * 3; idx += kDampThreads) {
                const int t = idx / (n1 * 3), rem = idx % (n1 * 3), i = rem / 3, c = rem % 3;
                const int l = l0 + t;
                wlg[idx] = i < n6 ? sys.wl[((size_t)l * n6 + i) * 3 + c] : sys.g_l[3 * l + c];
            }
            for (int t = threadIdx.x; t < nl; t += kDampThreads) {
                const int l = l0 + t;
                damped_inverse(sys.v + 9 * l, lam, sys.lm_active[l] != 0, vi + 9 * t);
                for (int k = 0; k < 9; ++k) v_inv[9 * (size_t)l + k] = vi[9 * t + k];
            }
            __syncthreads();
            for (int idx = threadIdx.x; idx < nl * n1 * 3; idx += kDampThreads) {
                const int t = idx / (n1 * 3), c = idx % 3;
                const float* row = wlg + (idx - c);
                const float* m = vi + 9 * t;
                av[idx] = (row[0] * m[c] + row[1] * m[3 + c]) + row[2] * m[6 + c];
            }
            __syncthreads();
            for (int e = threadIdx.x; e < nn; e += kDampThreads) {
                const int i = e / n1, j = e % n1;
                double acc = first ? 0.0 : mine[e];
                for (int t = 0; t < nl; ++t) {
                    const float* ai = av + ((size_t)t * n1 + i) * 3;
                    const float* wj = wlg + ((size_t)t * n1 + j) * 3;
                    acc += (ai[0] * wj[0] + ai[1] * wj[1]) + ai[2] * wj[2];
                }
                mine[e] = acc;
            }
            first = false;
            __syncthreads();
        }
        // (every block has a chunk: damp_blocks launches no more blocks)
        if (!arrive_last(&g_tickets[kTicketDamp])) return;
        for (int e = threadIdx.x; e < nn; e += kDampThreads)
            msum[e] = static_cast<float>(blocks_sum(partial, e, nn, gridDim.x));
        if (threadIdx.x == 0) g_tickets[kTicketDamp] = 0;
        __syncthreads();
        if (mode == kModeSums) return;
    }
    assemble(msum, sys, lam, W, s, rhs, resid);
}

// ---------------------------------------------------------------------------
// ba_step and ba_cost: one thread per landmark

// the candidate poses: pose_retract (core/geometry.py) where free
__device__ void retract(const float* pose, const float* d, bool free_, float* out) {
    if (!free_) {
        for (int k = 0; k < 7; ++k) out[k] = pose[k];
        return;
    }
    const float n2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
    const float n = sqrtf(n2);
    const bool small = n < 1e-8f;
    const float nc = clamp_min(n, 1e-20f);
    // torch divides a CUDA tensor by a scalar as a product with its reciprocal
    const float ew = small ? 1.0f - n2 * (1.0f / 2.0f) : cosf(n);
    const float s = small ? 1.0f - n2 * (1.0f / 6.0f) : sinf(nc) / nc;
    const float aw = ew, ax = s * d[0], ay = s * d[1], az = s * d[2];
    const float bw = pose[0], bx = pose[1], by = pose[2], bz = pose[3];
    out[0] = ((aw * bw - ax * bx) - ay * by) - az * bz;
    out[1] = ((aw * bx + ax * bw) + ay * bz) - az * by;
    out[2] = ((aw * by - ax * bz) + ay * bw) + az * bx;
    out[3] = ((aw * bz + ax * by) - ay * bx) + az * bw;
    for (int k = 0; k < 3; ++k) out[4 + k] = pose[4 + k] + d[3 + k];
}

__global__ void __launch_bounds__(kStepThreads)
ba_step_kernel(const float* __restrict__ delta, const float* __restrict__ corr, SvoBAProblem pr,
               SvoBASystem sys, const float* __restrict__ v_inv, SvoLMCarry in, SvoLMCarry out,
               SvoLMConfig cfg, int mode, double* __restrict__ partial, float* __restrict__ sums) {
    __shared__ float dp[6 * kWMax], cand[7 * kWMax], fm[kWMax];
    __shared__ float total[3];   // each landmark sum rounded once
    __shared__ bool ok_s;
    const int W = pr.W, L = pr.L, n6 = 6 * W;
    const float lam = *in.lam;
    for (int w = threadIdx.x; w < W; w += kStepThreads) fm[w] = sys.free_[w] ? 1.0f : 0.0f;
    __syncthreads();
    for (int k = threadIdx.x; k < n6; k += kStepThreads) {
        float d = delta[k];
        if (corr) d = d + corr[k];
        dp[k] = d * fm[k / 6];
    }
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += kStepThreads)
        retract(in.poses + 7 * w, dp + 6 * w, sys.free_[w] != 0, cand + 7 * w);
    __syncthreads();

    float cand_cost, pred_l;
    if (mode != kModeFinish) {
        const int l = blockIdx.x * kStepThreads + threadIdx.x;
        float x[3] = {0.0f, 0.0f, 0.0f};   // huber, prior, pred_l
        if (l < L) {
            float wt[3] = {0.0f, 0.0f, 0.0f};
            const float* wl = sys.wl + (size_t)l * n6 * 3;
            for (int k = 0; k < n6; ++k)
                for (int c = 0; c < 3; ++c) wt[c] += wl[3 * k + c] * dp[k];
            float gw[3], dl[3], p[3];
            for (int c = 0; c < 3; ++c) gw[c] = sys.g_l[3 * l + c] - wt[c];
            const float* vi = v_inv + 9 * (size_t)l;
            const bool active = sys.lm_active[l] != 0;
            for (int i = 0; i < 3; ++i) {
                const float s = (vi[3 * i] * gw[0] + vi[3 * i + 1] * gw[1]) + vi[3 * i + 2] * gw[2];
                dl[i] = active ? s : 0.0f;
            }
            for (int c = 0; c < 3; ++c) {
                const float dld = clamp(sys.v[9 * l + 4 * c], 1e-8f, 1e32f);
                x[2] += dl[c] * ((lam * dld) * dl[c] + sys.g_l[3 * l + c]);
                p[c] = in.lm_pos[3 * l + c] + dl[c];
                out.lm_pos[3 * l + c] = p[c];
            }
            landmark_cost(cand, p, l, pr, x[0], x[1]);
        }
        block_sums<3>(x, partial + 3 * blockIdx.x);
        if (!arrive_last(&g_tickets[kTicketStep])) return;
        if (threadIdx.x < 3)
            total[threadIdx.x] = static_cast<float>(blocks_sum(partial, threadIdx.x, 3, gridDim.x));
        if (threadIdx.x == 0) g_tickets[kTicketStep] = 0;
        __syncthreads();
        cand_cost = total[0] + 0.5f * total[1];
        pred_l = 0.5f * total[2];
        if (mode == kModeSums) {
            if (threadIdx.x == 0) {
                sums[0] = cand_cost;
                sums[1] = pred_l;
            }
            return;
        }
    } else {
        cand_cost = sums[0];
        pred_l = sums[1];
    }

    // the body's bookkeeping (backend/schur.py::_lm_update), one thread
    if (threadIdx.x == 0) {
        float pp = 0.0f;
        for (int k = 0; k < n6; ++k) {
            const int w = k / 6, a = k % 6;
            const float dpd = clamp(sys.u_blocks[36 * w + 7 * a], 1e-8f, 1e32f);
            pp += dp[k] * ((lam * dpd) * dp[k] + sys.g_p[k] * fm[w]);
        }
        const float pred = 0.5f * pp + pred_l;
        const float cost = *in.cost, nu = *in.nu;
        const bool done = *in.done != 0, upd = !done;
        const bool ok = (cand_cost < cost) && isfinite(cand_cost) && upd;
        const float cost_new = ok ? cand_cost : cost;
        const float rho = (cost - cand_cost) / clamp_min(pred, 1e-20f);
        // 1 - b^3 as the reference's compiled code rounds it (_lm_update)
        const float b = 2.0f * rho - 1.0f;
        const float shrink = clamp_min(__fmaf_rn(-(b * b), b, 1.0f), 1.0f / 3.0f);
        const float lam_new = upd ? clamp(ok ? lam * shrink : lam * nu, cfg.min_damping,
                                          cfg.max_damping)
                                  : lam;
        const float nu_new = upd ? (ok ? 2.0f : nu * 2.0f) : nu;
        const float rel = upd ? fabsf(cost - cost_new) / clamp_min(cost, 1e-20f) : *in.rel;
        const bool flat = upd && !ok && fabsf(cand_cost - cost) < cfg.tol * clamp_min(cost, 1e-20f);
        const bool done_new = done || (ok && rel < cfg.tol) || flat
                              || (upd && !ok && lam >= cfg.max_damping);
        *out.lam = lam_new;
        *out.nu = nu_new;
        *out.cost = cost_new;
        *out.rel = rel;
        *out.done = done_new;
        *out.accepted = *in.accepted + (ok ? 1 : 0);
        *out.it = *in.it + (upd ? 1 : 0);
        *out.ok = ok;
        ok_s = ok;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 7 * W; k += kStepThreads)
        out.poses[k] = ok_s ? cand[k] : in.poses[k];
    if (!ok_s)
        for (int k = threadIdx.x; k < 3 * L; k += kStepThreads) out.lm_pos[k] = in.lm_pos[k];
}

__global__ void __launch_bounds__(kStepThreads)
ba_cost_kernel(const float* __restrict__ poses, const float* __restrict__ lm_pos,
               SvoBAProblem pr, double* __restrict__ partial, float* __restrict__ cost) {
    __shared__ float pose_s[7 * kWMax];
    for (int k = threadIdx.x; k < 7 * pr.W; k += kStepThreads) pose_s[k] = poses[k];
    __syncthreads();
    const int l = blockIdx.x * kStepThreads + threadIdx.x;
    float x[2] = {0.0f, 0.0f};
    if (l < pr.L) {
        const float p[3] = {lm_pos[3 * l], lm_pos[3 * l + 1], lm_pos[3 * l + 2]};
        landmark_cost(pose_s, p, l, pr, x[0], x[1]);
    }
    block_sums<2>(x, partial + 2 * blockIdx.x);
    if (!arrive_last(&g_tickets[kTicketCost])) return;
    if (threadIdx.x == 0) {
        const float huber = static_cast<float>(blocks_sum(partial, 0, 2, gridDim.x));
        const float prior = static_cast<float>(blocks_sum(partial, 1, 2, gridDim.x));
        *cost = huber + 0.5f * prior;
        g_tickets[kTicketCost] = 0;
    }
}

int blocks(int n, int per) { return (n + per - 1) / per; }

int damp_lpb(int W) {
    const int n1 = 6 * W + 1;
    const int per_lm = (2 * n1 * 3 + 9) * static_cast<int>(sizeof(float));
    return per_lm * 32 <= kDampSmem ? 32 : kDampSmem / per_lm;
}

int damp_blocks(int L, int W) {
    const int chunks = blocks(L, damp_lpb(W));
    return chunks < kDampMaxBlocks ? chunks : kDampMaxBlocks;
}

bool shape_ok(int L, int W) { return L > 0 && W > 0 && W <= kWMax; }

}  // namespace

// Scratch floats of each entry point at L landmarks and W poses (the block
// partials first, as doubles, two floats each): 0 build, 1 damp_reduce (its
// msum after the partials), 2 step (its two sums last), 3 cost; -1 for a
// shape the kernels do not take.
extern "C" long long svo_ba_scratch_floats(int kernel, int L, int W) {
    if (!shape_ok(L, W)) return -1;
    const long long n1 = 6 * W + 1;
    switch (kernel) {
        case 0: return 2LL * blocks(L, kBuildThreads) * W * kPerPose;
        case 1: return (2LL * damp_blocks(L, W) + 1) * n1 * n1;
        case 2: return 2LL * blocks(L, kStepThreads) * 3 + 2;
        case 3: return 2LL * blocks(L, kStepThreads) * 2;
        default: return -1;
    }
}

extern "C" int svo_ba_build(const float* poses, const float* lm_pos, const SvoBAProblem* pr,
                            const SvoBASystem* sys, float* scratch, void* stream) {
    if (!shape_ok(pr->L, pr->W)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(double) * kWarps * pr->W * kPerPose;
    ba_build_kernel<<<blocks(pr->L, kBuildThreads), kBuildThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(poses, lm_pos, *pr, *sys,
                                                           reinterpret_cast<double*>(scratch));
    return static_cast<int>(cudaGetLastError());
}

// mode 0: the whole reduction; 1: up to msum (its sums, to be all-reduced,
// at scratch's end); 2: one block assembling s and rhs from that msum
extern "C" int svo_ba_damp_reduce(const SvoBASystem* sys, const float* lam, int L, int W,
                                  int mode, float* v_inv, float* scratch, float* s, float* rhs,
                                  float* resid, void* stream) {
    if (!shape_ok(L, W) || mode < kModeFull || mode > kModeFinish)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n1 = 6 * W + 1, lpb = damp_lpb(W), nb = damp_blocks(L, W);
    float* msum = scratch + 2 * static_cast<size_t>(nb) * n1 * n1;
    const size_t smem = sizeof(float) * (2 * static_cast<size_t>(lpb) * n1 * 3 + 9 * lpb);
    ba_damp_reduce_kernel<<<mode == kModeFinish ? 1 : nb, kDampThreads,
                            mode == kModeFinish ? 0 : smem, static_cast<cudaStream_t>(stream)>>>(
        *sys, lam, L, W, lpb, mode, v_inv, reinterpret_cast<double*>(scratch), msum, s, rhs,
        resid);
    return static_cast<int>(cudaGetLastError());
}

// mode 0: the whole step; 1: up to (cand_cost, pred_l) at scratch's last two
// floats; 2: one block finishing from those (all-reduced)
extern "C" int svo_ba_step(const float* delta, const float* corr, const SvoBAProblem* pr,
                           const SvoBASystem* sys, const float* v_inv, const SvoLMCarry* in,
                           const SvoLMCarry* out, const SvoLMConfig* cfg, int mode,
                           float* scratch, void* stream) {
    if (!shape_ok(pr->L, pr->W) || mode < kModeFull || mode > kModeFinish)
        return static_cast<int>(cudaErrorInvalidValue);
    const int nb = blocks(pr->L, kStepThreads);
    ba_step_kernel<<<mode == kModeFinish ? 1 : nb, kStepThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        delta, corr, *pr, *sys, v_inv, *in, *out, *cfg, mode, reinterpret_cast<double*>(scratch),
        scratch + 6 * nb);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int svo_ba_cost(const float* poses, const float* lm_pos, const SvoBAProblem* pr,
                           float* scratch, float* cost, void* stream) {
    if (!shape_ok(pr->L, pr->W)) return static_cast<int>(cudaErrorInvalidValue);
    ba_cost_kernel<<<blocks(pr->L, kStepThreads), kStepThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(poses, lm_pos, *pr,
                                                          reinterpret_cast<double*>(scratch), cost);
    return static_cast<int>(cudaGetLastError());
}
