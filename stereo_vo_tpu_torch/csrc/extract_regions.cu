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
// of 56x56 are 2 MB each way), so the floor is HBM/L2 bandwidth, and at these
// sizes the source image (<= 2 MB) stays in the 50 MB L2. What the design does
// about it: one block per (feature, channel); the block reads its own origin,
// then its threads walk the region in row-major order so that neighbouring
// threads read neighbouring addresses of one image row and write neighbouring
// addresses of the output: every load and store is coalesced, and nothing is
// staged through shared memory because nothing is reused.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_regions_kernel(const float* __restrict__ stack,
                       const int* __restrict__ origins,
                       float* __restrict__ out,
                       int hp, int wp, int ry, int rx) {
    const int n = blockIdx.x;
    const int c = blockIdx.y;
    const int channels = gridDim.y;
    int ox = origins[2 * n];
    int oy = origins[2 * n + 1];
    if (ox < 0) ox += wp;
    if (oy < 0) oy += hp;
    ox = min(max(ox, 0), wp - rx);
    oy = min(max(oy, 0), hp - ry);
    const float* src = stack + (static_cast<long long>(c) * hp + oy) * wp + ox;
    float* dst = out + (static_cast<long long>(n) * channels + c) * ry * rx;
    const int size = ry * rx;
    for (int i = threadIdx.x; i < size; i += kThreads) {
        const int row = i / rx;
        const int col = i - row * rx;
        dst[i] = src[static_cast<long long>(row) * wp + col];
    }
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
    dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(channels));
    extract_regions_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        stack, origins, out, hp, wp, ry, rx);
    return static_cast<int>(cudaGetLastError());
}
