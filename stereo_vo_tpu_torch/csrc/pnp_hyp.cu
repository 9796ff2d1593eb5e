// PnP-RANSAC's hypothesis stage for Hopper (sm_90a): every minimal sample's
// pose in one launch. For hypothesis h, from the 6 correspondences
// hyp_idx[h] of p3 [F,3] and uv [F,2]: the K-normalised rays, Hartley
// normalisation and the 12x12 DLT system, its right null vector (Householder
// QR of A^T, 11 reflectors, a ridge relative to A's scale on the diagonal,
// two inverse-iteration rounds on R R^T, then Q z), the denormalisation, the
// Newton polar fix of M and of -M with the determinant's sign, the
// cheirality pick, Shepperd's quaternion, then pnp_hyp_polish_iters damped
// Gauss-Newton steps on the 6 points (Jacobians, the quaternion lift,
// J^T J + 1e-6 I, an LU solve with partial pivoting, the retraction); ok is
// the polar fix's scale test and every pose component finite.
//
// Replaces what the JAX package computes as XLA fusions in pnp_ransac's
// vmapped one_hypothesis less the draw (stereo_vo_tpu/frontend/pnp.py:346,
// with _dlt_pose, _nullvec_qr, _polar_so3 and _gn_refine); no Pallas kernel
// computes it there. The plain version is
// stereo_vo_tpu_torch/frontend/pnp.py::pnp_hypotheses_ref.
//
// Entry point: svo_pnp_hypotheses (hyp [H,7] and ok [H] out). Built without
// nvcc (g++ -x c++), the same source gives svo_pnp_hypotheses_host, the same
// arithmetic one hypothesis at a time on the host, for the CPU tests.
//
// Rounding: each product and sum rounds on its own (this file is built with
// --fmad=false, as torch's CUDA kernels round), with IEEE division and
// square root, in the plain version's order as torch runs it on the CPU:
// torch.sum's interleaved partial sums (tsum below), einsum's small batched
// products summed in order from zero, and the cross product's first product
// fused into its difference, as the CPU's kernel fuses it. Where the plain
// version leaves the order to a library (the polish's J^T J and J^T r, a
// gemm: MKL's order on the CPU, cuBLAS's on the card), the 12 exact products
// are summed in double and rounded once, as ba_lm.cu sums over landmarks, so
// the result hardly depends on an order. The LU is LAPACK's getrf / getrs
// (the CPU's), with its pivot choice, the first largest magnitude. sin and
// cos are the device's.
//
// What bounds it on this card: neither bytes nor operations. A launch reads
// 48 B of indices and 120 B of points per hypothesis and writes 29 B (20 KB
// for the shipped 99 hypotheses), and does about 14,500 f32 operations per
// hypothesis (1.4 MFLOP). The time is one hypothesis's chain of dependent
// steps: 11 reflectors, four 12-step triangular solves, 16 polar iterations
// and the polish. So one warp takes one hypothesis, with its system,
// reflectors and Gram in shared memory: lanes take the columns of each
// reflector's product and the elements of its update, the 12 Jacobian rows
// and the 42 sums of J^T J and J^T r; every lane runs the serial rest on the
// same values, so no lane waits on a branch. Warps are spread over blocks of
// kWarps, so the shipped 99 hypotheses take 25 SMs. No atomics: every launch
// gives the same bits.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SVO_HD __device__ __forceinline__
#define SVO_SYNC() __syncwarp()
#else
#define SVO_HD inline
#define SVO_SYNC() ((void)0)
#endif

namespace {

constexpr int kPoints = 6;            // a minimal sample
constexpr int kN = 2 * kPoints;       // DLT unknowns and rows
constexpr int kWarps = 4;             // hypotheses per block

struct Camera {
    float focal, cx, cy;
};

// one hypothesis's arrays, shared by its warp
struct Work {
    float b[kN][kN];         // A^T, reduced in place to R
    float v[kN - 1][kN];     // reflector k in v[k][0 .. kN - k - 1]
    float w[kN];             // v^T of the block a reflector updates
    float jac[kN][6];        // the polish's Jacobian rows (point-major)
    float res[kN];           // and residuals
    float h[6][6];           // J^T J + 1e-6 I
    float g[6];              // -J^T r
};

// torch.sum of n contiguous float32 values on the CPU. Below 8 values: four
// partial sums interleaved from zero, the tail added to the first, then the
// four in order. From 8 on, in 8-lane vectors: each lane's values summed the
// same way over whole vectors, then the scalar tail from zero, then the
// lanes in order.
SVO_HD float tsum(const float* x, int n, int stride) {
    if (n < 8) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int full = n / 4;
        for (int r = 0; r < full; ++r) {
            for (int k = 0; k < 4; ++k) {
                p[k] = p[k] + x[(4 * r + k) * stride];
            }
        }
        for (int i = 4 * full; i < n; ++i) {
            p[0] = p[0] + x[i * stride];
        }
        return ((p[0] + p[1]) + p[2]) + p[3];
    }
    const int nv = n / 8, full = nv / 4;
    float acc = 0.0f;
    for (int i = 8 * nv; i < n; ++i) {
        acc = acc + x[i * stride];
    }
    for (int l = 0; l < 8; ++l) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int r = 0; r < full; ++r) {
            for (int k = 0; k < 4; ++k) {
                p[k] = p[k] + x[(8 * (4 * r + k) + l) * stride];
            }
        }
        for (int v = 4 * full; v < nv; ++v) {
            p[0] = p[0] + x[(8 * v + l) * stride];
        }
        acc = acc + (((p[0] + p[1]) + p[2]) + p[3]);
    }
    return acc;
}

SVO_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }

SVO_HD float sign_f(float x) { return static_cast<float>((0.0f < x) - (x < 0.0f)); }

SVO_HD float nan_to_num(float x) {
    if (x != x) {
        return 0.0f;
    }
    if (x == INFINITY) {
        return 3.402823466e38f;
    }
    if (x == -INFINITY) {
        return -3.402823466e38f;
    }
    return x;
}

// _polar_so3 (8 Newton steps R <- (R + R^-T) / 2) of m's first 3 columns
// (row stride 4); r out, the signed mean singular value returned
SVO_HD float polar_so3(const float m[12], float r[9]) {
    float sq[9];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            sq[3 * i + j] = m[4 * i + j] * m[4 * i + j];
        }
    }
    const float norm = clamp_min(sqrtf(tsum(sq, 9, 1) / 3.0f), 1e-20f);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            r[3 * i + j] = m[4 * i + j] / norm;
        }
    }
    for (int it = 0; it < 8; ++it) {
        const float a = r[0], b = r[1], c = r[2];
        const float d = r[3], e = r[4], f = r[5];
        const float g = r[6], h = r[7], i = r[8];
        const float co_a = e * i - f * h;
        const float co_b = -(d * i - f * g);
        const float co_c = d * h - e * g;
        const float det = (a * co_a + b * co_b) + c * co_c;
        const float adj[9] = {co_a, -(b * i - c * h), b * f - c * e,
                              co_b, a * i - c * g, -(a * f - c * d),
                              co_c, -(a * h - b * g), a * e - b * d};
        float nr[9];
        for (int p = 0; p < 3; ++p) {
            for (int q = 0; q < 3; ++q) {
                nr[3 * p + q] = 0.5f * (r[3 * p + q] + adj[3 * q + p] / det);
            }
        }
        for (int k = 0; k < 9; ++k) {
            r[k] = nr[k];
        }
    }
    // trace of R^T M, each diagonal entry summed in order from zero
    float s[3];
    for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) {
            acc = acc + r[3 * j + k] * m[4 * j + k];
        }
        s[k] = acc;
    }
    return tsum(s, 3, 1) / 3.0f;
}

// _dlt_pose's fix of one sign of the denormalised M [3,4]: R, t, the points
// in front and the scale test
SVO_HD void fix_sign(const float m[12], const float p3[kPoints][3], float r[9], float t[3],
                     int& npos, bool& ok) {
    float scale = polar_so3(m, r);
    const float det = r[0] * (r[4] * r[8] - r[5] * r[7]) - r[1] * (r[3] * r[8] - r[5] * r[6])
                      + r[2] * (r[3] * r[7] - r[4] * r[6]);
    const float flip = sign_f(det);
    for (int k = 0; k < 9; ++k) {
        r[k] = r[k] * flip;
    }
    scale = scale * flip;
    const float den = fabsf(scale) > 1e-12f ? scale : 1e-12f;
    for (int i = 0; i < 3; ++i) {
        t[i] = m[4 * i + 3] / den;
    }
    npos = 0;
    for (int n = 0; n < kPoints; ++n) {
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) {
            acc = acc + p3[n][j] * r[6 + j];
        }
        npos += (acc + t[2]) > 0.0f;
    }
    ok = fabsf(scale) > 1e-9f;
}

// rotmat_to_quat: Shepperd's method, the first largest pivot (NaN wins, as
// torch.argmax), normalised, w >= 0
SVO_HD void rotmat_to_quat(const float m[9], float q[4]) {
    const float m00 = m[0], m01 = m[1], m02 = m[2];
    const float m10 = m[3], m11 = m[4], m12 = m[5];
    const float m20 = m[6], m21 = m[7], m22 = m[8];
    const float tr = (m00 + m11) + m22;
    const float cands[4][4] = {
        {1.0f + tr, m21 - m12, m02 - m20, m10 - m01},
        {m21 - m12, ((1.0f + m00) - m11) - m22, m01 + m10, m02 + m20},
        {m02 - m20, m01 + m10, ((1.0f - m00) + m11) - m22, m12 + m21},
        {m10 - m01, m02 + m20, m12 + m21, ((1.0f - m00) - m11) + m22},
    };
    int best = 0;
    for (int k = 1; k < 4; ++k) {
        const float c = cands[k][k], bv = cands[best][best];
        if (bv == bv && (c > bv || c != c)) {
            best = k;
        }
    }
    float sq[4];
    for (int k = 0; k < 4; ++k) {
        sq[k] = cands[best][k] * cands[best][k];
    }
    const float n = clamp_min(sqrtf(((sq[0] + sq[1]) + sq[2]) + sq[3]), 1e-12f);
    float qq[4];
    for (int k = 0; k < 4; ++k) {
        qq[k] = cands[best][k] / n;
    }
    const float s = qq[0] < 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 4; ++k) {
        q[k] = qq[k] * s;
    }
}

// one row of the polish's system: point p, observed pixel obs, residual row
// rr (0: u, 1: v); j6 [6] and the residual out, as reprojection_jacobians,
// the quaternion lift and nan_to_num compute them
SVO_HD void polish_row(const float pose[7], const float p[3], const float obs[2], int rr,
                       Camera cam, float j6[6], float& res) {
    const float w = pose[0];
    const float v[3] = {pose[1], pose[2], pose[3]};
    const float q[4] = {pose[0], pose[1], pose[2], pose[3]};
    const float n2 = ((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3];
    const float vdotp = (v[0] * p[0] + v[1] * p[1]) + v[2] * p[2];
    const float vdotv = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
    const float vxp[3] = {fmaf(v[1], p[2], -(v[2] * p[1])), fmaf(v[2], p[0], -(v[0] * p[2])),
                          fmaf(v[0], p[1], -(v[1] * p[0]))};
    const float two_vdotp = 2.0f * vdotp, ww = w * w - vdotv, two_w = 2.0f * w;
    float u[3], g[3];
    for (int i = 0; i < 3; ++i) {
        u[i] = (two_vdotp * v[i] + ww * p[i]) + two_w * vxp[i];
        g[i] = u[i] / n2 + pose[4 + i];
    }
    const float inv_z = 1.0f / g[2];
    const float f = cam.focal;
    const float gr = rr == 0 ? g[0] : g[1];
    // dr/dgamma's row rr
    float dr[3];
    dr[0] = rr == 0 ? f * inv_z : 0.0f;
    dr[1] = rr == 0 ? 0.0f : f * inv_z;
    dr[2] = (((-f) * gr) * inv_z) * inv_z;
    // dgamma/dq [3,4]
    const float skew[3][3] = {{0.0f, -p[2], p[1]}, {p[2], 0.0f, -p[0]}, {-p[1], p[0], 0.0f}};
    const float n4 = n2 * n2;
    float dg[3][4];
    for (int i = 0; i < 3; ++i) {
        float du[4];
        du[0] = 2.0f * (w * p[i] + vxp[i]);
        for (int j = 0; j < 3; ++j) {
            const float eye = i == j ? vdotp * 1.0f : vdotp * 0.0f;
            du[1 + j] = 2.0f * (((v[i] * p[j] + eye) - p[i] * v[j]) - w * skew[i][j]);
        }
        const float two_u = 2.0f * u[i];
        for (int c = 0; c < 4; ++c) {
            dg[i][c] = du[c] / n2 - (two_u * q[c]) / n4;
        }
    }
    float jq4[4];
    for (int c = 0; c < 4; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < 3; ++k) {
            acc = acc + dr[k] * dg[k][c];
        }
        jq4[c] = acc;
    }
    const float x = q[1], y = q[2], z = q[3];
    const float lift[4][3] = {{-x, -y, -z}, {w, z, -y}, {-z, w, x}, {y, -x, w}};
    for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
        for (int j = 0; j < 4; ++j) {
            acc = acc + jq4[j] * lift[j][k];
        }
        j6[k] = nan_to_num(acc);
        j6[3 + k] = nan_to_num(dr[k]);
    }
    const float pp = rr == 0 ? cam.cx : cam.cy;
    res = nan_to_num(((gr * inv_z) * f + pp) - obs[rr]);
}

// h x = g as the CPU's LAPACK solves it: getrf (right-looking, the first
// largest pivot, multipliers scaled by the pivot's reciprocal, each update
// fused) and getrs (the row swaps, then L and U by columns, fused)
SVO_HD void lu_solve6(float a[6][6], float x[6]) {
    int piv[6];
    for (int k = 0; k < 6; ++k) {
        int p = k;
        float best = fabsf(a[k][k]);
        for (int i = k + 1; i < 6; ++i) {
            const float m = fabsf(a[i][k]);
            if (m > best || (m != m && best == best)) {
                best = m;
                p = i;
            }
        }
        piv[k] = p;
        if (p != k) {
            for (int j = 0; j < 6; ++j) {
                const float tmp = a[k][j];
                a[k][j] = a[p][j];
                a[p][j] = tmp;
            }
        }
        const float inv = 1.0f / a[k][k];
        for (int i = k + 1; i < 6; ++i) {
            a[i][k] = a[i][k] * inv;
        }
        for (int i = k + 1; i < 6; ++i) {
            for (int j = k + 1; j < 6; ++j) {
                a[i][j] = fmaf(-a[i][k], a[k][j], a[i][j]);
            }
        }
    }
    for (int k = 0; k < 6; ++k) {
        if (piv[k] != k) {
            const float tmp = x[k];
            x[k] = x[piv[k]];
            x[piv[k]] = tmp;
        }
    }
    for (int j = 0; j < 6; ++j) {
        for (int i = j + 1; i < 6; ++i) {
            x[i] = fmaf(-x[j], a[i][j], x[i]);
        }
    }
    for (int j = 5; j >= 0; --j) {
        x[j] = x[j] / a[j][j];
        for (int i = 0; i < j; ++i) {
            x[i] = fmaf(-x[j], a[i][j], x[i]);
        }
    }
}

// pose_retract: exp(delta[0:3]) (x) q, t + delta[3:6]
SVO_HD void retract(float pose[7], const float d[6]) {
    const float n2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
    const float n = sqrtf(n2);
    const bool small = n < 1e-8f;
    const float ew = small ? 1.0f - n2 / 2.0f : cosf(n);
    const float nc = clamp_min(n, 1e-20f);
    const float s = small ? 1.0f - n2 / 6.0f : sinf(nc) / nc;
    const float ex = s * d[0], ey = s * d[1], ez = s * d[2];
    const float qw = pose[0], qx = pose[1], qy = pose[2], qz = pose[3];
    pose[0] = ((ew * qw - ex * qx) - ey * qy) - ez * qz;
    pose[1] = ((ew * qx + ex * qw) + ey * qz) - ez * qy;
    pose[2] = ((ew * qy - ex * qz) + ey * qw) + ez * qx;
    pose[3] = ((ew * qz + ex * qy) - ey * qx) + ez * qw;
    for (int i = 0; i < 3; ++i) {
        pose[4 + i] = pose[4 + i] + d[3 + i];
    }
}

// _nullvec_qr of the A whose transpose is in s.b (overwritten by R): z out
// on every lane
template <int lanes>
SVO_HD void null_vector(Work& s, int lane, float z[kN]) {
    // the ridge's scale, from A * A in A's row-major order
    float aa[kN * kN];
    for (int j = 0; j < kN; ++j) {
        for (int i = 0; i < kN; ++i) {
            aa[kN * j + i] = s.b[i][j] * s.b[i][j];
        }
    }
    const float eps = 1e-12f * sqrtf(tsum(aa, kN * kN, 1) / 144.0f);

    // Householder QR of A^T
    for (int k = 0; k < kN - 1; ++k) {
        const int m = kN - k;
        float x2[kN], vv[kN];
        for (int i = 0; i < m; ++i) {
            x2[i] = s.b[k + i][k] * s.b[k + i][k];
        }
        const float alpha = sqrtf(tsum(x2, m, 1));
        const float sgn = s.b[k][k] >= 0.0f ? 1.0f : -1.0f;
        for (int i = 0; i < m; ++i) {
            const float xi = i == 0 ? s.b[k][k] + sgn * alpha : s.b[k + i][k];
            vv[i] = xi * xi;
        }
        const float vn = clamp_min(sqrtf(tsum(vv, m, 1)), 1e-30f);
        for (int i = lane; i < m; i += lanes) {
            const float xi = i == 0 ? s.b[k][k] + sgn * alpha : s.b[k + i][k];
            s.v[k][i] = xi / vn;
        }
        SVO_SYNC();
        for (int j = lane; j < m; j += lanes) {
            float acc = 0.0f;
            for (int i = 0; i < m; ++i) {
                acc = acc + s.v[k][i] * s.b[k + i][k + j];
            }
            s.w[j] = acc;
        }
        SVO_SYNC();
        for (int e = lane; e < m * m; e += lanes) {
            const int i = e / m, j = e % m;
            s.b[k + i][k + j] = s.b[k + i][k + j] - (2.0f * s.v[k][i]) * s.w[j];
        }
        SVO_SYNC();
    }

    // inverse iteration on R R^T from e_12, two rounds, then v = Q z
    float diag[kN];
    for (int i = 0; i < kN; ++i) {
        const float dv = s.b[i][i];
        diag[i] = fabsf(dv) > eps ? dv : (dv >= 0.0f ? 1.0f : -1.0f) * eps;
        z[i] = i == kN - 1 ? 1.0f : 0.0f;
    }
    for (int round = 0; round < 2; ++round) {
        float y[kN];
        for (int i = kN - 1; i >= 0; --i) {           // R y = z
            float acc = z[i];
            for (int j = i + 1; j < kN; ++j) {
                acc = acc - s.b[i][j] * y[j];
            }
            y[i] = acc / diag[i];
        }
        for (int i = 0; i < kN; ++i) {                // R^T z = y
            float acc = y[i];
            for (int j = 0; j < i; ++j) {
                acc = acc - s.b[j][i] * z[j];
            }
            z[i] = acc / diag[i];
        }
        float z2[kN];
        for (int i = 0; i < kN; ++i) {
            z2[i] = z[i] * z[i];
        }
        const float zn = clamp_min(sqrtf(tsum(z2, kN, 1)), 1e-30f);
        for (int i = 0; i < kN; ++i) {
            z[i] = z[i] / zn;
        }
    }
    for (int k = kN - 2; k >= 0; --k) {
        const int m = kN - k;
        float vz[kN];
        for (int i = 0; i < m; ++i) {
            vz[i] = s.v[k][i] * z[k + i];
        }
        const float coef = tsum(vz, m, 1);
        for (int i = 0; i < m; ++i) {
            z[k + i] = z[k + i] - (2.0f * s.v[k][i]) * coef;
        }
    }

}

// one damped Gauss-Newton step of the polish on the sample's points
template <int lanes>
SVO_HD void polish_step(Work& s, int lane, const float pts[kPoints][3],
                        const float obs[kPoints][2], Camera cam, float pose[7]) {
    for (int l = lane; l < kN; l += lanes) {
        polish_row(pose, pts[l / 2], obs[l / 2], l % 2, cam, s.jac[l], s.res[l]);
    }
    SVO_SYNC();
    for (int e = lane; e < 36 + 6; e += lanes) {
        // each a sum of 12 exact products in double, rounded once
        if (e < 36) {
            const int i = e / 6, j = e % 6;
            double acc = 0.0;
            for (int l = 0; l < kN; ++l) {
                acc += static_cast<double>(s.jac[l][i]) * static_cast<double>(s.jac[l][j]);
            }
            s.h[i][j] = static_cast<float>(acc) + (i == j ? 1e-6f : 0.0f);
        } else {
            const int i = e - 36;
            double acc = 0.0;
            for (int l = 0; l < kN; ++l) {
                acc += static_cast<double>(s.jac[l][i]) * static_cast<double>(s.res[l]);
            }
            s.g[i] = -static_cast<float>(acc);
        }
    }
    SVO_SYNC();
    float a[6][6], d[6];
    for (int i = 0; i < 6; ++i) {
        for (int j = 0; j < 6; ++j) {
            a[i][j] = s.h[i][j];
        }
        d[i] = s.g[i];
    }
    SVO_SYNC();
    lu_solve6(a, d);
    retract(pose, d);
}

// The whole hypothesis, by `lanes` lanes of which this is `lane`, on one
// Work; pose [7] and ok out on every lane. Index out of [0, f_cap): a NaN
// pose, not ok.
template <int lanes>
SVO_HD void hypothesis(Work& s, int lane, const float* p3, const float* uv, const int64_t* idx,
                       int f_cap, Camera cam, int polish, float pose[7], bool& ok) {
    float pts[kPoints][3], obs[kPoints][2], xn[kPoints][2];
    bool in_range = true;
    for (int k = 0; k < kPoints; ++k) {
        int64_t i = idx[k];
        if (i < 0 || i >= f_cap) {
            in_range = false;
            i = 0;
        }
        for (int j = 0; j < 3; ++j) {
            pts[k][j] = p3[3 * i + j];
        }
        for (int j = 0; j < 2; ++j) {
            obs[k][j] = uv[2 * i + j];
        }
        xn[k][0] = (obs[k][0] - cam.cx) / cam.focal;
        xn[k][1] = (obs[k][1] - cam.cy) / cam.focal;
    }

    // Hartley normalisation: centroid c, scale s (torch.mean: a sum, then / n)
    float c[3];
    for (int j = 0; j < 3; ++j) {
        c[j] = tsum(&pts[0][j], kPoints, 3) / 6.0f;
    }
    float ss[kPoints], pn[kPoints][3];
    for (int n = 0; n < kPoints; ++n) {
        float d2[3];
        for (int j = 0; j < 3; ++j) {
            pn[n][j] = pts[n][j] - c[j];
            d2[j] = pn[n][j] * pn[n][j];
        }
        ss[n] = tsum(d2, 3, 1);
    }
    const float sc = clamp_min(sqrtf((tsum(ss, kPoints, 1) / 6.0f) / 3.0f), 1e-6f);
    for (int n = 0; n < kPoints; ++n) {
        for (int j = 0; j < 3; ++j) {
            pn[n][j] = pn[n][j] / sc;
        }
    }

    // b = A^T: lane j writes A's row j (point j % 6; x rows, then y rows)
    for (int j = lane; j < kN; j += lanes) {
        const int n = j % kPoints, y = j / kPoints;
        const float ph[4] = {pn[n][0], pn[n][1], pn[n][2], 1.0f};
        const float neg = -xn[n][y];
        for (int i = 0; i < 4; ++i) {
            s.b[i][j] = y == 0 ? ph[i] : 0.0f;
            s.b[4 + i][j] = y == 0 ? 0.0f : ph[i];
            s.b[8 + i][j] = neg * ph[i];
        }
    }
    SVO_SYNC();

    float z[kN];
    null_vector<lanes>(s, lane, z);

    // denormalise: M = M_n [[I / s, -c / s], [0, 1]]
    float ma[12], mb[12];
    for (int i = 0; i < 3; ++i) {
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) {
            acc = acc + z[4 * i + j] * c[j];
        }
        for (int j = 0; j < 3; ++j) {
            ma[4 * i + j] = z[4 * i + j] / sc;
        }
        ma[4 * i + 3] = z[4 * i + 3] - acc / sc;
    }
    for (int k = 0; k < 12; ++k) {
        mb[k] = -ma[k];
    }
    float ra[9], ta[3], rb[9], tb[3];
    int npos_a, npos_b;
    bool ok_a, ok_b;
    fix_sign(ma, pts, ra, ta, npos_a, ok_a);
    fix_sign(mb, pts, rb, tb, npos_b, ok_b);
    const bool pick_a = npos_a >= npos_b;
    float r[9];
    for (int k = 0; k < 9; ++k) {
        r[k] = pick_a ? ra[k] : rb[k];
    }
    rotmat_to_quat(r, pose);
    for (int i = 0; i < 3; ++i) {
        pose[4 + i] = pick_a ? ta[i] : tb[i];
    }
    ok = pick_a ? ok_a : ok_b;

    // the polish on the 6 points
    for (int it = 0; it < polish; ++it) {
        polish_step<lanes>(s, lane, pts, obs, cam, pose);
    }
    for (int k = 0; k < 7; ++k) {
        ok = ok && isfinite(pose[k]);
    }
    if (!in_range) {
        for (int k = 0; k < 7; ++k) {
            pose[k] = NAN;
        }
        ok = false;
    }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(32 * kWarps)
pnp_hyp_kernel(const float* __restrict__ p3, const float* __restrict__ uv,
               const int64_t* __restrict__ hyp_idx, int n_hyp, int f_cap, Camera cam,
               int polish, float* __restrict__ hyp, bool* __restrict__ hyp_ok) {
    __shared__ Work work[kWarps];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int h = blockIdx.x * kWarps + warp;
    if (h >= n_hyp) {
        return;
    }
    float pose[7];
    bool ok;
    hypothesis<32>(work[warp], lane, p3, uv, hyp_idx + kPoints * h, f_cap, cam, polish, pose,
                   ok);
    if (lane < 7) {
        hyp[7 * h + lane] = pose[lane];
    }
    if (lane == 0) {
        hyp_ok[h] = ok;
    }
}

#endif

}  // namespace

#ifdef __CUDACC__

// p3 [f_cap, 3] f32, uv [f_cap, 2] f32, hyp_idx [n_hyp, 6] int64; hyp
// [n_hyp, 7] f32 and hyp_ok [n_hyp] bool out. All contiguous on the current
// device. Launches on `stream` and returns the first CUDA error (0 on
// success); it does not synchronise.
extern "C" int svo_pnp_hypotheses(const float* p3, const float* uv, const int64_t* hyp_idx,
                                  int n_hyp, int f_cap, float focal, float cx, float cy,
                                  int polish, float* hyp, bool* hyp_ok, void* stream) {
    if (n_hyp <= 0) {
        return 0;
    }
    const int blocks = (n_hyp + kWarps - 1) / kWarps;
    pnp_hyp_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        p3, uv, hyp_idx, n_hyp, f_cap, Camera{focal, cx, cy}, polish, hyp, hyp_ok);
    return static_cast<int>(cudaGetLastError());
}

#else

// svo_pnp_hypotheses's arithmetic on the host, one hypothesis at a time
extern "C" void svo_pnp_hypotheses_host(const float* p3, const float* uv, const int64_t* hyp_idx,
                                        int n_hyp, int f_cap, float focal, float cx, float cy,
                                        int polish, float* hyp, bool* hyp_ok) {
    Work work;
    for (int h = 0; h < n_hyp; ++h) {
        float pose[7];
        bool ok;
        hypothesis<1>(work, 0, p3, uv, hyp_idx + kPoints * h, f_cap, Camera{focal, cx, cy},
                      polish, pose, ok);
        for (int k = 0; k < 7; ++k) {
            hyp[7 * h + k] = pose[k];
        }
        hyp_ok[h] = ok;
    }
}

#endif
