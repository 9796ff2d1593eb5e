// Greedy min-distance suppression over a sorted candidate pool, one launch
// per call, for Hopper (sm_90a).
//
// Replaces the XLA while_loop of stereo_vo_tpu/ops/shi_tomasi.py:221 (the
// parallel greedy fixpoint of detect_corners, rounds at :208-219). It has no
// Pallas counterpart there: on the TPU the loop is plain XLA, one [C, C]
// mat-vec per round under lax.while_loop. Its plain version, the loop with
// one host read per round, is stereo_vo_tpu_torch/ops/shi_tomasi.py::
// greedy_nms_ref.
//
// Contract, for C <= 1024 candidates sorted by descending response:
//  conflict(j, i) = j < i && valid[j] && valid[i] && d2(j, i) < r2, with
//    d2 = (x_j - x_i)^2 + (y_j - y_i)^2 rounded as the plain version rounds
//    it (two products, one sum, no contraction);
//  from accepted = killed = {} repeat, while some valid candidate is neither:
//    pending = valid & ~accepted & ~killed,
//    blocked[i] = any pending j with conflict(j, i),
//    by_acc[i]  = any accepted j with conflict(j, i),
//    killed   |= pending & by_acc,
//    accepted |= pending & ~by_acc & ~blocked;
//  write accepted. Every round runs on the same sets as the plain version's,
//  so the result is bitwise its (and, as the reference shows, the sequential
//  descending-response sweep's).
//
// What bounds it on this card: neither bytes nor operations. It reads 9 B per
// candidate and writes 1 (10 KB at C = 1024, 3 ns at 3.35 TB/s) and makes
// C^2 / 2 pair tests once (about 4 MFLOP, under 0.1 us at 67 TFLOP/s); the
// rounds are few (the longest suppression chain) and each is a few word ANDs
// per candidate. One block's dependent chain and the launch set the time.
//
// What the design does about it: one block of 1024 threads, thread i owning
// candidate i, so the whole fixpoint runs without a host round trip or a
// second launch. Each thread writes its column of the conflict matrix once as
// bits over the earlier candidates, 32 words of 32 bits, stored word-major
// (word w of thread i at w * 1024 + i) so a warp reads 32 consecutive words:
// 128 KiB of dynamic shared memory (the block's limit is raised at the first
// launch). A round packs pending and accepted into 32-word bit sets with one
// ballot per warp; each thread ANDs them with the words of its column that
// hold a conflict, which a bit mask in a register marks (a few for a real
// candidate pool, whose conflicts are the neighbours within min_distance),
// and __syncthreads_or decides the next round. Coordinates are staged once in
// shared memory and read as broadcasts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ cxy, const unsigned char* __restrict__ cvalid,
                  unsigned char* __restrict__ accepted_out, int c, float r2) {
    extern __shared__ unsigned int conf[];          // [kWords][kThreads]
    __shared__ float xs[kThreads];
    __shared__ float ys[kThreads];
    __shared__ unsigned char vs[kThreads];
    __shared__ unsigned int pend_bits[kWords];
    __shared__ unsigned int acc_bits[kWords];

    const int i = threadIdx.x;
    const int lane = i & 31;
    const int warp = i >> 5;
    const bool live = i < c;
    const float xi = live ? cxy[2 * i] : 0.0f;
    const float yi = live ? cxy[2 * i + 1] : 0.0f;
    const bool valid = live && cvalid[i] != 0;
    xs[i] = xi;
    ys[i] = yi;
    vs[i] = valid ? 1 : 0;
    __syncthreads();

    // this thread's column: bit b of word w is conflict(32 w + b, i); only the
    // words of earlier candidates can be nonzero. Bit w of `words` marks a
    // nonzero word w, and the rounds read only those
    const int last_word = i >> 5;
    unsigned int words = 0u;
    for (int w = 0; w <= last_word; ++w) {
        unsigned int bits = 0u;
        if (valid) {
            for (int b = 0; b < 32; ++b) {
                const int j = 32 * w + b;
                if (j < i && vs[j]) {
                    const float dx = __fsub_rn(xs[j], xi);
                    const float dy = __fsub_rn(ys[j], yi);
                    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
                    bits |= (d2 < r2 ? 1u : 0u) << b;
                }
            }
        }
        conf[w * kThreads + i] = bits;
        words |= (bits != 0u ? 1u : 0u) << w;
    }

    bool acc = false;
    bool killed = false;
    int still = __syncthreads_or(valid);
    while (still) {
        const bool pending = valid && !acc && !killed;
        const unsigned int p = __ballot_sync(0xffffffffu, pending);
        const unsigned int a = __ballot_sync(0xffffffffu, acc);
        if (lane == 0) {
            pend_bits[warp] = p;
            acc_bits[warp] = a;
        }
        __syncthreads();
        bool blocked = false;
        bool by_acc = false;
        if (pending) {
            for (unsigned int m = words; m != 0u; m &= m - 1u) {
                const int w = __ffs(m) - 1;
                const unsigned int col = conf[w * kThreads + i];
                blocked = blocked || (pend_bits[w] & col) != 0u;
                by_acc = by_acc || (acc_bits[w] & col) != 0u;
            }
        }
        killed = killed || (pending && by_acc);
        acc = acc || (pending && !by_acc && !blocked);
        // also the barrier before the next round rewrites the bit sets
        still = __syncthreads_or(valid && !acc && !killed);
    }
    if (live) {
        accepted_out[i] = acc ? 1 : 0;
    }
}

bool g_smem_set = false;

}  // namespace

// cxy [c, 2] f32 (x, y), cvalid [c] bool, accepted [c] bool out; all
// contiguous on the current device; 0 < c <= 1024. Launches on `stream` and
// returns the first CUDA error (0 on success); it does not synchronise.
extern "C" int svo_greedy_nms(const float* cxy, const unsigned char* cvalid,
                              unsigned char* accepted, int c, float r2, void* stream) {
    if (c <= 0) {
        return 0;
    }
    if (c > kThreads) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = sizeof(unsigned int) * kWords * kThreads;
    if (!g_smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            return static_cast<int>(err);
        }
        g_smem_set = true;
    }
    greedy_nms_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        cxy, cvalid, accepted, c, r2);
    return static_cast<int>(cudaGetLastError());
}
