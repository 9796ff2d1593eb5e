// One pyramidal Lucas-Kanade level pass per launch, for Hopper (sm_90a).
//
// Replaces, on the LK path, the TPU region-extraction kernel
// stereo_vo_tpu/ops/pallas_extract.py::_extract_regions_vmem (pallas_call at
// :168) together with the XLA level pass it fed,
// stereo_vo_tpu/ops/lk.py::_lk_level (:182) -> _gn_pass (:462) ->
// _gn_iterate (:359). Its plain version is
// stereo_vo_tpu_torch/ops/lk.py::lk_level_pass_ref.
//
// Contract, for every feature n (one block each):
//  0. an inactive feature (active[n] false) is not solvable, so it makes no
//     iteration: it writes its guess unchanged, solvable false, in_region of
//     that guess, no update and, in the forward role, its centre (the
//     template region's mean, summed as in 2), and reads nothing else;
//  1. copy the template region (tpl_img at tpl_org[n]) and the iteration
//     region (it_img at it_org[n]), region x region pixels each, from the
//     level images edge-padded by m: padded[y][x] is img[clamp(y - m)][clamp(x
//     - m)], and an origin is placed as jax.lax.dynamic_slice places it (a
//     negative start counts from the end once, then it is clamped);
//  2. subtract the centering constant c[n] from both: the template region's
//     mean when center_given is 0 (forward role; written to center[n]), else
//     center[n] as given (backward role: the forward prev region's mean);
//  3. sample the (win+2)^2 template patch at tpl_pos[n] - 1 bilinearly (rows,
//     then columns, each (1 - f) * v0 + f * v1, samples outside the region
//     read 0), take its in-patch Scharr gradients cropped to win x win, the
//     Gram terms, the min-eigenvalue and determinant gates and the inverse;
//     solvable = eig_ok & det_ok (& active[n], true past 0);
//  4. run at most max_iters Gauss-Newton iterations in the reference's order
//     (clamped position, window sample and di, bx and by, the step,
//     oscillation halving for it > 0, the update, the eps stop, converged |=
//     small | osc | !in_region | !solvable), stopping when the feature
//     converges; a converged feature changes nothing in the reference's
//     masked loop, so the result is that loop's;
//  5. write guess', solvable, in_region(guess') and the update count.
// Every product and sum that the plain version rounds separately is written
// with __fmul_rn / __fadd_rn, so nvcc cannot contract it into an FMA: the
// samples and per-feature scalars round as torch rounds them; the Scharr
// taps fuse with __fmaf_rn where the plain version fuses them, as XLA's code
// does (core/f32.py::tap_sum).
// Only the order of the 441-term and region-mean sums differs.
//
// What bounds it on this card: bytes, then the serial iteration chain. Each
// launch must read both regions of every feature: 2 x N x region^2 x 4 bytes
// at most (56x56: 4.0 MB at N = 160, 11.2 MB at N = 448, i.e. 1.2 and 3.4 us
// at 3.35 TB/s; 88x88: 9.9 and 27.8 MB, 3.0 and 8.3 us; regions overlap and
// the level images are at most 1.9 MB each, so fewer distinct bytes come
// from device memory). The arithmetic is about 6.2 kFLOP per feature and
// iteration: 30 MFLOP a pass at N = 160 even at the 30-iteration cap (83 at
// N = 448), under 1.3 us at the card's 67 TFLOP/s f32 rate. Beyond that
// bound, every iteration is a dependent chain (sample -> block reduction ->
// 2x2 solve -> next position) of about 2 us on one SM, so a pass costs about
// its slowest feature's iteration count times that latency, up to 30
// iterations: 41-73 us a pass at 20-30 iterations on an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 3b), 1-2% of the bound above.
//
// What the design does about it: one 128-thread block per feature; both
// regions are staged once in dynamic shared memory (2 x 56 x 56 x 4 = 25 KB;
// 62 KB at the 88 x 88 top level, over the 48 KB default, so the launch
// raises the block's limit) with coalesced row-major loads, so no region
// ever goes back to device memory; each thread keeps its (at most 8) window
// samples' template value and gradients in registers for the whole loop; an
// iteration costs one block barrier (warp shuffles, then a double-buffered
// per-warp partial in shared memory that every thread sums in the same
// order, so all threads hold the same scalars and leave the loop together).
// Tensor cores have no use here: no product is wider than a dot of 441
// terms. The loads are plain 4-byte loads: rows of a padded level start only
// 4-byte aligned (row stride 5140 B at level 0), so 16-byte cp.async or TMA
// would need a pitched image layout first. An inactive feature's block
// reads at most its template region for the centre and exits, so the tracker
// runs every slot of its capacity through one launch with no compaction.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 8;   // window samples a thread owns: win^2 <= 1024

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// 3 a + 10 b + 3 c as the plain version's tap_sum rounds it: the first product
// fused with the second, rounded; the third fused into that
__device__ __forceinline__ float taps3(float a, float b, float c) {
    return __fmaf_rn(3.0f, c, __fmaf_rn(3.0f, a, mul(10.0f, b)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// dynamic_slice placement of a start along an axis of length dim
__device__ __forceinline__ int place(int o, int dim, int size) {
    if (o < 0) o += dim;
    return clampi(o, 0, dim - size);
}

__device__ __forceinline__ float warp_sum(float v) {
    // xor butterfly: partners add the same two values, so every lane ends
    // with the same sum
    for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Bilinear weights at a continuous region position. The integer start is
// kept finite: past the region every sample reads zero either way.
struct Lerp {
    int x0, y0;
    float fx, fy, wx0, wy0;
};

__device__ __forceinline__ Lerp lerp_at(float px, float py, int size) {
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    Lerp l;
    l.fx = sub(px, x0);
    l.fy = sub(py, y0);
    l.wx0 = sub(1.0f, l.fx);
    l.wy0 = sub(1.0f, l.fy);
    l.x0 = static_cast<int>(fminf(fmaxf(x0, -64.0f), static_cast<float>(size + 64)));
    l.y0 = static_cast<int>(fminf(fmaxf(y0, -64.0f), static_cast<float>(size + 64)));
    return l;
}

// row-interpolated value at column x between rows y and y + 1; rows and
// columns outside the region read zero
__device__ __forceinline__ float row_lerp(const float* reg, int size, int y, int x, const Lerp& l) {
    if (x < 0 || x >= size) return 0.0f;
    const float v0 = (y >= 0 && y < size) ? reg[y * size + x] : 0.0f;
    const float v1 = (y + 1 >= 0 && y + 1 < size) ? reg[(y + 1) * size + x] : 0.0f;
    return add(mul(l.wy0, v0), mul(l.fy, v1));
}

__device__ __forceinline__ float sample(const float* reg, int size, const Lerp& l, int a, int b) {
    const int y = l.y0 + a;
    const int x = l.x0 + b;
    return add(mul(l.wx0, row_lerp(reg, size, y, x, l)),
               mul(l.fx, row_lerp(reg, size, y, x + 1, l)));
}

__device__ __forceinline__ bool in_region(float ux, float uy, float half, float m, float ox,
                                          float oy, float lim) {
    const float px = sub(add(sub(ux, half), m), ox);
    const float py = sub(add(sub(uy, half), m), oy);
    return px >= 0.0f && px <= lim && py >= 0.0f && py <= lim;
}

__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ tpl_img, const float* __restrict__ it_img,
                int h, int w, int m,
                const int* __restrict__ tpl_org, const int* __restrict__ it_org,
                const float* __restrict__ tpl_pos, const float* __restrict__ guess_in,
                const bool* __restrict__ active, float* __restrict__ center, int center_given,
                float* __restrict__ guess_out, bool* __restrict__ solvable_out,
                bool* __restrict__ inside_out, int* __restrict__ iters_out,
                int region, int half, int max_iters, float eps2, float min_eig_threshold) {
    extern __shared__ float smem[];
    __shared__ double red_mean[kWarps];
    __shared__ float red_gram[kWarps][3];
    __shared__ float red_b[2][kWarps][2];

    const int n = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int win = 2 * half + 1;
    const int wt = win + 2;
    const int nwin = win * win;
    const int size = region * region;
    float* tpl = smem;               // template region, centred
    float* itr = smem + size;        // iteration region, centred
    float* patch = smem + 2 * size;  // (win+2)^2 template patch

    // ---- 1-2. stage both regions, centred
    const int hp = h + 2 * m;
    const int wp = w + 2 * m;
    const int tox = place(tpl_org[2 * n], wp, region) - m;
    const int toy = place(tpl_org[2 * n + 1], hp, region) - m;
    const int iox = place(it_org[2 * n], wp, region) - m;
    const int ioy = place(it_org[2 * n + 1], hp, region) - m;
    const bool given = center_given != 0;
    const float halff = static_cast<float>(half);
    const float mf = static_cast<float>(m);
    const float orgx = static_cast<float>(it_org[2 * n]);
    const float orgy = static_cast<float>(it_org[2 * n + 1]);
    const float lim = static_cast<float>(region - win - 1);

    // ---- an inactive feature: not solvable, so no iteration and the guess
    // unchanged; only the forward role's centre (the template region's
    // mean, summed as below) needs its region
    if (!active[n]) {
        if (!given) {
            double part = 0.0;
            for (int i = tid; i < size; i += kThreads) {
                const int r = i / region;
                const int q = i - r * region;
                part += static_cast<double>(
                    tpl_img[static_cast<long long>(clampi(toy + r, 0, h - 1)) * w
                            + clampi(tox + q, 0, w - 1)]);
            }
            part = warp_sum(part);
            if (lane == 0) red_mean[warp] = part;
            __syncthreads();
            if (tid == 0) {
                double total = red_mean[0];
                for (int k = 1; k < kWarps; ++k) total += red_mean[k];
                center[n] = static_cast<float>(total / static_cast<double>(size));
            }
        }
        if (tid == 0) {
            const float ux = guess_in[2 * n];
            const float uy = guess_in[2 * n + 1];
            guess_out[2 * n] = ux;
            guess_out[2 * n + 1] = uy;
            solvable_out[n] = false;
            inside_out[n] = in_region(ux, uy, halff, mf, orgx, orgy, lim);
            iters_out[n] = 0;
        }
        return;
    }

    float c = given ? center[n] : 0.0f;
    double part = 0.0;
    for (int i = tid; i < size; i += kThreads) {
        const int r = i / region;
        const int q = i - r * region;
        const float tv = tpl_img[static_cast<long long>(clampi(toy + r, 0, h - 1)) * w
                                 + clampi(tox + q, 0, w - 1)];
        const float iv = it_img[static_cast<long long>(clampi(ioy + r, 0, h - 1)) * w
                                + clampi(iox + q, 0, w - 1)];
        if (given) {
            tpl[i] = sub(tv, c);
            itr[i] = sub(iv, c);
        } else {
            tpl[i] = tv;
            itr[i] = iv;
            part += static_cast<double>(tv);
        }
    }
    if (!given) {
        part = warp_sum(part);
        if (lane == 0) red_mean[warp] = part;
        __syncthreads();
        double total = red_mean[0];
        for (int k = 1; k < kWarps; ++k) total += red_mean[k];
        c = static_cast<float>(total / static_cast<double>(size));
        if (tid == 0) center[n] = c;
        for (int i = tid; i < size; i += kThreads) {
            tpl[i] = sub(tpl[i], c);
            itr[i] = sub(itr[i], c);
        }
    }
    __syncthreads();

    // ---- 3. template patch, in-patch Scharr, Gram terms and gates
    const Lerp lt = lerp_at(sub(tpl_pos[2 * n], 1.0f), sub(tpl_pos[2 * n + 1], 1.0f), region);
    for (int i = tid; i < wt * wt; i += kThreads) {
        const int a = i / wt;
        patch[i] = sample(tpl, region, lt, a, i - a * wt);
    }
    __syncthreads();

    float t_s[kMaxPerThread], gx_s[kMaxPerThread], gy_s[kMaxPerThread];
    int a_s[kMaxPerThread], b_s[kMaxPerThread];
    float g11 = 0.0f, g12 = 0.0f, g22 = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
        const int i = tid + k * kThreads;
        t_s[k] = gx_s[k] = gy_s[k] = 0.0f;
        a_s[k] = b_s[k] = 0;
        if (i < nwin) {
            const int a = i / win;
            const int b = i - a * win;
            a_s[k] = a;
            b_s[k] = b;
            const float* up = patch + a * wt + b;   // patch rows a, a+1, a+2 around (a+1, b+1)
            const float* mid = up + wt;
            const float* dn = mid + wt;
            t_s[k] = mid[1];
            // Scharr x: rows [3, 10, 3], then columns [-1, 0, 1], / 32
            const float sl = taps3(up[0], mid[0], dn[0]);
            const float sr = taps3(up[2], mid[2], dn[2]);
            gx_s[k] = __fdiv_rn(add(-sl, sr), 32.0f);
            // Scharr y: rows [-1, 0, 1], then columns [3, 10, 3], / 32
            const float dl = add(-up[0], dn[0]);
            const float dc = add(-up[1], dn[1]);
            const float dr = add(-up[2], dn[2]);
            gy_s[k] = __fdiv_rn(taps3(dl, dc, dr), 32.0f);
            g11 = add(g11, mul(gx_s[k], gx_s[k]));
            g12 = add(g12, mul(gx_s[k], gy_s[k]));
            g22 = add(g22, mul(gy_s[k], gy_s[k]));
        }
    }
    g11 = warp_sum(g11);
    g12 = warp_sum(g12);
    g22 = warp_sum(g22);
    if (lane == 0) {
        red_gram[warp][0] = g11;
        red_gram[warp][1] = g12;
        red_gram[warp][2] = g22;
    }
    __syncthreads();
    g11 = red_gram[0][0];
    g12 = red_gram[0][1];
    g22 = red_gram[0][2];
    for (int k = 1; k < kWarps; ++k) {
        g11 = add(g11, red_gram[k][0]);
        g12 = add(g12, red_gram[k][1]);
        g22 = add(g22, red_gram[k][2]);
    }
    const float tr = add(g11, g22);
    const float det = sub(mul(g11, g22), mul(g12, g12));
    float disc = sub(mul(tr, tr), mul(4.0f, det));
    disc = disc < 0.0f ? 0.0f : disc;                       // clamp(min=0) keeps NaN
    const float min_eig = mul(sub(tr, sqrtf(disc)), 0.5f);
    const bool eig_ok = __fdiv_rn(min_eig, static_cast<float>(nwin)) >= min_eig_threshold;
    const bool det_ok = det > 1e-12f;
    const bool solvable = eig_ok && det_ok;
    const float safe_det = det_ok ? det : 1.0f;
    const float inv11 = det_ok ? __fdiv_rn(g22, safe_det) : 0.0f;
    const float inv12 = det_ok ? __fdiv_rn(-g12, safe_det) : 0.0f;
    const float inv22 = det_ok ? __fdiv_rn(g11, safe_det) : 0.0f;

    // ---- 4. the Gauss-Newton loop, until this feature converges
    float ux = guess_in[2 * n];
    float uy = guess_in[2 * n + 1];
    float psx = 0.0f, psy = 0.0f;
    bool converged = !solvable;
    int it = 0;
    for (; it < max_iters && !converged; ++it) {
        float px = sub(add(sub(ux, halff), mf), orgx);
        float py = sub(add(sub(uy, halff), mf), orgy);
        px = px < 0.0f ? 0.0f : px;                          // clamp / minimum keep NaN
        py = py < 0.0f ? 0.0f : py;
        px = px > lim ? lim : px;
        py = py > lim ? lim : py;
        const Lerp l = lerp_at(px, py, region);
        float bx = 0.0f, by = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxPerThread; ++k) {
            if (tid + k * kThreads < nwin) {
                const float di = sub(sample(itr, region, l, a_s[k], b_s[k]), t_s[k]);
                bx = add(bx, mul(di, gx_s[k]));
                by = add(by, mul(di, gy_s[k]));
            }
        }
        bx = warp_sum(bx);
        by = warp_sum(by);
        // double-buffered: the buffer written here was last read before the
        // previous iteration's barrier
        float (*buf)[2] = red_b[it & 1];
        if (lane == 0) {
            buf[warp][0] = bx;
            buf[warp][1] = by;
        }
        __syncthreads();
        bx = buf[0][0];
        by = buf[0][1];
        for (int k = 1; k < kWarps; ++k) {
            bx = add(bx, buf[k][0]);
            by = add(by, buf[k][1]);
        }
        float sx = -add(mul(inv11, bx), mul(inv12, by));
        float sy = -add(mul(inv12, bx), mul(inv22, by));
        bool osc = false;
        if (it > 0) {                                        // OpenCV's oscillation break
            osc = add(mul(sx, psx), mul(sy, psy)) < -0.01f;
            if (osc) {
                sx = mul(0.5f, sx);
                sy = mul(0.5f, sy);
            }
        }
        ux = add(ux, sx);
        uy = add(uy, sy);
        const bool small = add(mul(sx, sx), mul(sy, sy)) < eps2;
        converged = small || osc || !in_region(ux, uy, halff, mf, orgx, orgy, lim);
        psx = sx;
        psy = sy;
    }

    // ---- 5. outputs
    if (tid == 0) {
        guess_out[2 * n] = ux;
        guess_out[2 * n + 1] = uy;
        solvable_out[n] = solvable;
        inside_out[n] = in_region(ux, uy, halff, mf, orgx, orgy, lim);
        iters_out[n] = it;
    }
}

}  // namespace

// tpl_img, it_img [h, w] f32; tpl_org, it_org [n, 2] int32 (x, y) origins in
// coordinates padded by m; tpl_pos, guess_in [n, 2] f32; active [n] bool;
// center [n] f32 (read when center_given, else written); outputs guess_out
// [n, 2] f32, solvable_out and inside_out [n] bool, iters_out [n] int32; all
// contiguous on the current device. Launches on `stream` and returns the
// first CUDA error (0 on success); it does not synchronise.
extern "C" int svo_lk_level_pass(const float* tpl_img, const float* it_img, int h, int w, int m,
                                 const int* tpl_org, const int* it_org, const float* tpl_pos,
                                 const float* guess_in, const bool* active,
                                 float* center, int center_given,
                                 float* guess_out, bool* solvable_out, bool* inside_out,
                                 int* iters_out, int n, int region, int half, int max_iters,
                                 float eps2, float min_eig_threshold, void* stream) {
    if (n <= 0) {
        return 0;
    }
    const int wt = 2 * half + 3;
    const size_t smem = sizeof(float) * (2 * static_cast<size_t>(region) * region
                                         + static_cast<size_t>(wt) * wt);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    lk_level_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        tpl_img, it_img, h, w, m, tpl_org, it_org, tpl_pos, guess_in, active, center,
        center_given, guess_out, solvable_out, inside_out, iters_out, region, half, max_iters,
        eps2, min_eig_threshold);
    return static_cast<int>(cudaGetLastError());
}
