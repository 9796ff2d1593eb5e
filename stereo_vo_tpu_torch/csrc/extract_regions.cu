// Batched region extraction at per-feature origins, for Hopper (sm_90a).
//
// Replaces the TPU kernels of stereo_vo_tpu/ops/pallas_extract.py:
//   _extract_regions_vmem  (body _vmem_kernel, pallas_call at :168) and
//   _extract_regions_tiled (body _tiled_kernel, pallas_call at :107),
// both behind the dispatcher extract_regions (:184). Contract: for every
// feature n and channel c, out[n, c] is an exact f32 copy of
// stack[c, oy:oy+ry, ox:ox+rx], with the start placed the way
// jax.lax.dynamic_slice places it: a negative start counts from the end of
// its axis (+dim, once), then it is clamped to [0, dim - size]. The TPU
// variants' 8/128-aligned lane bands, 32-feature granule, retiled copy and
// one-hot crop matmul exist for the TPU's memory layout and are not carried
// over (their default-precision crop matmul even rounds non-integer pixels
// to bf16 on the TPU; the contract is the exact copy).
//
// What bounds it on this card: bytes moved. It is a pure gather with no
// arithmetic: each call reads and writes N*C*ry*rx*4 bytes (160 LK regions
// of 56x56 are 2 MB each way, 160 of 88x88 5 MB), and the source level
// (<= 2 MB on the main path's shapes) stays in the 50 MB L2. A call is a few
// microseconds, so the card reaches its rate only with many bytes in flight
// on all 132 SMs at once, and every region costs two dependent round trips
// (its origin, then its pixels) besides the launch itself: one region alone
// takes about 1.5 us on the device.
//
// What the design does about it:
// - Work is split into warp tasks: kRows = 4 rows of one (feature, channel)
//   region, kWarps = 4 warps to a block. 160 regions of 56x56 are 2,240
//   tasks in 560 blocks of 128 threads, all resident at once and 4-5 on
//   every SM, where one 256-thread block per region (160 blocks on 132 SMs)
//   left 28 SMs with twice the work of the rest. A task's region and rows
//   come from one division each per warp; no element is divided.
// - Lanes lie along a row's columns and warps along rows, so every load and
//   store of a warp covers 128 consecutive bytes. Each lane loads its
//   ceil(rx / 32) column chunks (kCols, a template parameter) of all kRows
//   rows before its first store: 8 independent loads in flight per lane at
//   56 columns, 12 at 88 and 80, 4 at 32.
// - Stores are 4 bytes, one path for every rx. Source rows start only 4-byte
//   aligned (any ox; the padded widths 1285 and 1373 are not multiples of
//   4), so a 16-byte store must be fed by four 4-byte loads or by aligned
//   16-byte loads joined across lanes with __shfl_down_sync. On the card the
//   shuffled form was slower than this layout at every main-path shape (in
//   separate runs), and the packed form, timed beside it, came within 6% of
//   it either way (faster at two shapes, slower at one): no gain that pays
//   for a second kernel for rx % 4 == 0.
// - TMA is not used: a tensor map needs a row stride that is a multiple of
//   16 bytes, which these levels lack, and a pitched copy of the level would
//   move more bytes than the extraction itself.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;              // warps per block
constexpr int kRows = 4;               // rows per warp task
constexpr int kMaxCols = 4;            // column chunks of 32 a lane holds at once

// one warp task: rows r0 .. r0 + kRows - 1 of region n * channels + c, in
// passes of 32 * kCols columns (one pass unless rx > 96)
template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
extract_regions_kernel(const float* __restrict__ stack, const int* __restrict__ origins,
                       float* __restrict__ out, int channels, int hp, int wp, int ry, int rx,
                       int groups, int tasks) {
    const int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (task >= tasks) {
        return;
    }
    const int lane = threadIdx.x & 31;
    const int region = task / groups;
    const int r0 = (task - region * groups) * kRows;
    const int n = region / channels;
    const int c = region - n * channels;
    int ox = origins[2 * n];
    int oy = origins[2 * n + 1];
    if (ox < 0) ox += wp;
    if (oy < 0) oy += hp;
    ox = min(max(ox, 0), wp - rx);
    oy = min(max(oy, 0), hp - ry);
    const float* src = stack + (static_cast<long long>(c) * hp + oy + r0) * wp + ox;
    float* dst = out + (static_cast<long long>(region) * ry + r0) * rx;
    const int rows = min(kRows, ry - r0);
    for (int c0 = lane; c0 < rx; c0 += 32 * kCols) {
        float v[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                if (i < rows && c0 + 32 * k < rx) {
                    v[i][k] = __ldg(src + static_cast<long long>(i) * wp + c0 + 32 * k);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                if (i < rows && c0 + 32 * k < rx) {
                    dst[i * rx + c0 + 32 * k] = v[i][k];
                }
            }
        }
        if (kCols < kMaxCols) {        // the row fit one pass
            break;
        }
    }
}

template <int kCols>
int launch(const float* stack, const int* origins, float* out, int channels, int hp, int wp,
           int ry, int rx, int groups, int tasks, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((tasks + kWarps - 1) / kWarps);
    extract_regions_kernel<kCols><<<blocks, kWarps * 32, 0, stream>>>(
        stack, origins, out, channels, hp, wp, ry, rx, groups, tasks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stack [C, Hp, Wp] f32, origins [N, 2] int32 (x, y), out [N, C, ry, rx] f32,
// all contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int svo_extract_regions(const float* stack, const int* origins, float* out,
                                   int channels, int hp, int wp, int n, int ry, int rx,
                                   void* stream) {
    if (n <= 0 || channels <= 0) {
        return 0;
    }
    const int groups = (ry + kRows - 1) / kRows;
    const long long tasks = static_cast<long long>(n) * channels * groups;
    if (tasks > INT_MAX - kWarps) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    const int t = static_cast<int>(tasks);
    switch ((rx + 31) / 32) {
        case 1: return launch<1>(stack, origins, out, channels, hp, wp, ry, rx, groups, t, s);
        case 2: return launch<2>(stack, origins, out, channels, hp, wp, ry, rx, groups, t, s);
        case 3: return launch<3>(stack, origins, out, channels, hp, wp, ry, rx, groups, t, s);
        default:
            return launch<kMaxCols>(stack, origins, out, channels, hp, wp, ry, rx, groups, t, s);
    }
}
