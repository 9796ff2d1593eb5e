// Sparse StereoBM at feature pixels, one launch per call, for Hopper (sm_90a).
//
// Replaces, on the sparse-BM path, the TPU region-extraction kernel
// stereo_vo_tpu/ops/pallas_extract.py::_extract_regions_vmem (pallas_call at
// :168, reached through stereo_vo_tpu/ops/lk.py:76 _extract_regions) together
// with the XLA work it fed, stereo_vo_tpu/ops/stereo_bm.py:176-287
// (_stereo_bm_at_full), the XSobel prefilter at :198-199 included. Its plain
// version is stereo_vo_tpu_torch/ops/stereo_bm.py::stereo_bm_at_ref.
//
// Contract, for every slot n (one block each), with r = block / 2 and P the
// prefiltered image clamp(S + cap, 0, 2 cap), S = sobel_x with reflect-101
// borders, rounded as ops/filters.py rounds it (rows (p0 + 2 p1) + p2, then
// columns (0 - q0) + q2):
//  1. if !valid[n], write -1;
//  2. xi = clamp(trunc(x), 0, w - 1), yi = clamp(trunc(y), 0, h - 1);
//  3. L[a][b] = Pl(clamp(yi - r + a), clamp(xi - r + b)) and
//     R[a][j] = Pr(clamp(yi - r + a), clamp(xi - (D - 1) - r + j)) for
//     a, b < block, j < D + block - 1: edge-clamped reads into the unpadded
//     images, which is what the plain version's pad_edge by m = D + r + 8, its
//     8-aligned regions and its window crop read;
//  4. SAD_d = sum_{a,b} |L[a][b] - R[a][(D - 1 - d) + b]| for d < D; best is
//     the first minimum over ascending d, second the minimum over
//     |d - best| > 1;
//  5. the uniqueness test, the parabola at d0 = clamp(best, 1, D - 2), the
//     texture sum sum |L - cap| and the inside test, as _subpixel_valid and
//     _stereo_bm_at_full write them; out = the disparity where all pass,
//     else -1.
// Every sum and product is written with __fadd_rn / __fsub_rn / __fmul_rn,
// so nvcc cannot contract it into an FMA, and the parabola's division is
// IEEE. On integer-valued images (every image the engine sees is a uint8
// frame as f32) every prefiltered value, SAD and texture sum is an exact f32
// integer, so the result is bitwise the plain version's whatever the order
// of the sums.
//
// What bounds it on this card: bytes, far below the launch and the per-block
// chain. At the defaults (D = 48, block = 21) a valid slot reads 23 x 23 raw
// left and 23 x 70 raw right pixels (8.6 KB), at most both images (2 x 1.87 MB
// at 376x1241) in all: about 2.7 MB at 320 valid slots, plus 9 B in and 4 B
// out per slot, 0.8 us at 3.35 TB/s. The work is about 3 x 48 x 441 operations
// of the SAD and 13 per prefiltered pixel per valid slot, 28 MFLOP at 320
// slots, 0.4 us at the card's 67 TFLOP/s f32 rate. A block's chain (staging
// loads, prefilter, SAD table, per-d sums, one warp's finish) and the launch
// set the time, tens of us (chip_smoke.py phase 3c measures it).
//
// What the design does about it: one 256-thread block per slot, so an invalid
// slot costs one early exit and the live-set compaction of the plain version
// (a sort, a scatter and a host sync) has nothing left to do. The raw rows a
// slot needs, with the 1-pixel Sobel halo, are staged once in dynamic shared
// memory by coalesced row loads (staged column c of a row is raw column
// reflect(x_lo - 1 + c), so the halo of an edge-clamped window reads the
// reflected pixel the whole-image prefilter reads); the prefilter writes L and
// R beside them; the D x block table of per-row SADs spreads over the block's
// threads with lanes on neighbouring d (conflict-free shared reads: odd row
// strides, the left value broadcast); one warp sums nothing twice and finishes
// with shuffles. About 20 KB of shared memory at the defaults, sized from D
// and block at launch; over 48 KB the launch raises the block's limit. No
// tensor cores: the work is |a - b| sums, not products. Plain 4-byte loads:
// image rows start only 4-byte aligned (row stride 4964 B at 1241 columns).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// reflect-101 source index of i in [-1, n] on an axis of length n
__device__ __forceinline__ int reflect(int i, int n) {
    if (n == 1) return 0;
    if (i < 0) return -i;
    return i >= n ? 2 * (n - 1) - i : i;
}

// torch's float -> int64 cast (truncation toward zero), then clamp to
// [0, n - 1]; NaN goes to 0 as in both of torch's casts
__device__ __forceinline__ int trunc_clamp(float v, int n) {
    const float t = fminf(fmaxf(v, -1.0e9f), 1.0e9f);
    return clampi(static_cast<int>(t), 0, n - 1);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// Shared-memory layout of one block, from D and block alone (the host sizes
// the launch with it). Row strides are odd, so lanes on neighbouring rows hit
// different banks.
struct Layout {
    int rows;    // staged raw rows: block + 2
    int raw_l;   // row stride of the raw left tile (>= block + 2 columns)
    int raw_r;   // row stride of the raw right tile (>= D + block + 1 columns)
    int band;    // columns of R: D + block - 1
    int win_l;   // row stride of L
    int win_r;   // row stride of R

    __host__ __device__ Layout(int d, int block)
        : rows(block + 2), raw_l((block + 2) | 1), raw_r((d + block + 1) | 1),
          band(d + block - 1), win_l(block | 1), win_r((d + block - 1) | 1) {}

    // raw left, raw right, L, R, the [block][D] per-row SADs, the [D] SADs
    __host__ __device__ size_t floats(int d, int block) const {
        return static_cast<size_t>(rows) * (raw_l + raw_r)
               + static_cast<size_t>(block) * (win_l + win_r + d) + d;
    }
};

// raw[q][c] = img[reflect(y0 + q)][reflect(x0 + c)] for q < nr, c < nc
__device__ __forceinline__ void stage(const float* __restrict__ img, int h, int w, int y0,
                                      int nr, int x0, int nc, float* tile, int stride) {
#pragma unroll 4
    for (int i = threadIdx.x; i < nr * nc; i += kThreads) {
        const int q = i / nc;
        const int c = i - q * nc;
        tile[q * stride + c] =
            __ldg(img + static_cast<long long>(reflect(y0 + q, h)) * w + reflect(x0 + c, w));
    }
}

// sobel_x's row pass at staged (s, c), taps [1, 2, 1] added in order from 0
__device__ __forceinline__ float rowsum(const float* t, int stride, int s, int c) {
    return add(add(add(0.0f, t[(s - 1) * stride + c]), mul(2.0f, t[s * stride + c])),
               t[(s + 1) * stride + c]);
}

// the column pass, taps [-1, 0, 1] added in order from 0, then
// clamp(. + cap, 0, 2 cap) (NaN passes as torch.clamp passes it)
__device__ __forceinline__ float prefilter(const float* t, int stride, int s, int c, float cap) {
    const float g = add(sub(0.0f, rowsum(t, stride, s, c - 1)), rowsum(t, stride, s, c + 1));
    float v = add(g, cap);
    v = v < 0.0f ? 0.0f : v;
    const float hi = mul(2.0f, cap);
    return v > hi ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
stereo_bm_at_kernel(const float* __restrict__ left, const float* __restrict__ right, int h,
                    int w, const float* __restrict__ xy, const bool* __restrict__ valid,
                    float* __restrict__ out, int num_d, int block, float cap,
                    float texture_threshold, float uniqueness_ratio) {
    extern __shared__ float smem[];
    __shared__ float red_tex[kWarps];

    const int n = blockIdx.x;
    const int tid = threadIdx.x;
    if (!valid[n]) {
        if (tid == 0) out[n] = -1.0f;
        return;
    }
    const Layout lay(num_d, block);
    float* raw_l = smem;
    float* raw_r = raw_l + lay.rows * lay.raw_l;
    float* win_l = raw_r + lay.rows * lay.raw_r;
    float* win_r = win_l + block * lay.win_l;
    float* part = win_r + block * lay.win_r;   // [block][D]
    float* sad = part + block * num_d;         // [D]

    const int r = block / 2;
    const int xi = trunc_clamp(xy[2 * n], w);
    const int yi = trunc_clamp(xy[2 * n + 1], h);

    // ---- 1. stage the raw rows and columns the slot reads, with the halo
    const int y_lo = clampi(yi - r, 0, h - 1);
    const int nr = clampi(yi + r, 0, h - 1) - y_lo + 3;
    const int x_hi = clampi(xi + r, 0, w - 1);
    const int xl_lo = clampi(xi - r, 0, w - 1);
    const int xr_lo = clampi(xi - (num_d - 1) - r, 0, w - 1);
    stage(left, h, w, y_lo - 1, nr, xl_lo - 1, x_hi - xl_lo + 3, raw_l, lay.raw_l);
    stage(right, h, w, y_lo - 1, nr, xr_lo - 1, x_hi - xr_lo + 3, raw_r, lay.raw_r);
    __syncthreads();

    // ---- 2. prefilter into L (with the texture sum) and R
    float tex = 0.0f;
    for (int i = tid; i < block * block; i += kThreads) {
        const int a = i / block;
        const int b = i - a * block;
        const int s = clampi(yi - r + a, 0, h - 1) - y_lo + 1;
        const int c = clampi(xi - r + b, 0, w - 1) - xl_lo + 1;
        const float v = prefilter(raw_l, lay.raw_l, s, c, cap);
        win_l[a * lay.win_l + b] = v;
        tex = add(tex, fabsf(sub(v, cap)));
    }
    for (int i = tid; i < block * lay.band; i += kThreads) {
        const int a = i / lay.band;
        const int j = i - a * lay.band;
        const int s = clampi(yi - r + a, 0, h - 1) - y_lo + 1;
        const int c = clampi(xi - (num_d - 1) - r + j, 0, w - 1) - xr_lo + 1;
        win_r[a * lay.win_r + j] = prefilter(raw_r, lay.raw_r, s, c, cap);
    }
    tex = warp_sum(tex);
    if ((tid & 31) == 0) red_tex[tid >> 5] = tex;
    __syncthreads();

    // ---- 3. the per-row SAD of every (row, d), lanes on neighbouring d
    for (int e = tid; e < block * num_d; e += kThreads) {
        const int a = e / num_d;
        const int d = e - a * num_d;
        const float* lrow = win_l + a * lay.win_l;
        const float* rrow = win_r + a * lay.win_r + (num_d - 1 - d);
        float acc = 0.0f;
        for (int b = 0; b < block; ++b) acc = add(acc, fabsf(sub(lrow[b], rrow[b])));
        part[a * num_d + d] = acc;
    }
    __syncthreads();
    for (int d = tid; d < num_d; d += kThreads) {
        float acc = 0.0f;
        for (int a = 0; a < block; ++a) acc = add(acc, part[a * num_d + d]);
        sad[d] = acc;
    }
    __syncthreads();

    // ---- 4. one warp: first minimum, second minimum, parabola and tests
    if (tid >= 32) return;
    const int lane = tid;
    float best_c = lane < num_d ? sad[lane] : INFINITY;
    int best_d = lane < num_d ? lane : INT_MAX;
    for (int d = lane + 32; d < num_d; d += 32) {
        const float c = sad[d];
        if (c < best_c) {             // ascending d in a lane: keeps the first
            best_c = c;
            best_d = d;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float oc = __shfl_xor_sync(0xffffffffu, best_c, off);
        const int od = __shfl_xor_sync(0xffffffffu, best_d, off);
        if (oc < best_c || (oc == best_c && od < best_d)) {
            best_c = oc;
            best_d = od;
        }
    }
    float second = INFINITY;
    for (int d = lane; d < num_d; d += 32) {
        if (abs(d - best_d) > 1) second = fminf(second, sad[d]);
    }
    for (int off = 16; off > 0; off >>= 1) {
        second = fminf(second, __shfl_xor_sync(0xffffffffu, second, off));
    }
    if (lane != 0) return;

    float texture = red_tex[0];
    for (int k = 1; k < kWarps; ++k) texture = add(texture, red_tex[k]);
    const bool unique_ok = mul(second, 100.0f) >= mul(best_c, add(100.0f, uniqueness_ratio));
    const int d0 = clampi(best_d, 1, num_d - 2);
    const float c_m = sad[d0 - 1];
    const float c_0 = sad[d0];
    const float c_p = sad[d0 + 1];
    float denom = sub(add(c_m, c_p), mul(2.0f, c_0));
    denom = denom < 1e-9f ? 1e-9f : denom;
    float delta = __fdiv_rn(sub(c_m, c_p), mul(2.0f, denom));
    delta = delta < -0.5f ? -0.5f : delta;
    delta = delta > 0.5f ? 0.5f : delta;
    const float best_f = static_cast<float>(best_d);
    const float disp = best_d == d0 ? add(best_f, delta) : best_f;
    const bool tex_ok = texture >= texture_threshold;
    const bool inside = yi >= r && yi < h - r && xi >= num_d + r - 1 && xi < w - r;
    out[n] = (inside && unique_ok && tex_ok) ? disp : -1.0f;
}

}  // namespace

// left, right [h, w] f32; xy [n, 2] f32 (x, y); valid [n] bool; out [n] f32;
// all contiguous on the current device. num_disparities >= 3, block_size odd.
// Launches on `stream` and returns the first CUDA error (0 on success); it
// does not synchronise.
extern "C" int svo_stereo_bm_at(const float* left, const float* right, int h, int w,
                                const float* xy, const bool* valid, float* out, int n,
                                int num_disparities, int block_size, int prefilter_cap,
                                int texture_threshold, int uniqueness_ratio, void* stream) {
    if (n <= 0) {
        return 0;
    }
    const Layout lay(num_disparities, block_size);
    const size_t smem = sizeof(float) * lay.floats(num_disparities, block_size);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            stereo_bm_at_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
    }
    stereo_bm_at_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        left, right, h, w, xy, valid, out, num_disparities, block_size,
        static_cast<float>(prefilter_cap), static_cast<float>(texture_threshold),
        static_cast<float>(uniqueness_ratio));
    return static_cast<int>(cudaGetLastError());
}
