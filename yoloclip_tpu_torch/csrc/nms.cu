// Exact greedy NMS keep mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas   (body _kernel).
//
// Input: per image, K <= 1024 candidate boxes (x1, y1, x2, y2) sorted by
// score, best first, and a valid flag per candidate. Output: keep[i] is
// true iff candidate i is valid and no kept candidate ranked before it
// overlaps it with IoU > threshold -- the greedy result of
// yoloclip_tpu/ops/nms.py::_greedy_keep / _fixpoint_keep.
//
// IoU is yoloclip_tpu/ops/boxes.py::pairwise_iou:
//   inter / (area_a + area_b - inter + 1e-7), compared with a strict '>'.
// Every operation rounds on its own (this file is built with -fmad=false
// and spells the roundings out with __f*_rn), so the mask is bit-identical
// to the plain PyTorch version, whose elementwise ops round separately.
//
// What bounds it on the H100: latency, not bytes or FLOPs. The TPU kernel
// iterates a (1, K) x (K, K) matvec to a fixed point, one sweep per link
// of the longest suppression chain. Here one block per image builds the
// K x K upper-triangular overlap bitmask (K x K/32 words, 128 KB at
// K = 1024) in dynamic shared memory -- one warp per 32-bit word, one IoU
// per lane, combined with __ballot_sync -- and then one warp makes a
// single sequential greedy pass: lane w holds word w of the `removed` set
// in a register, a kept row ORs its bitmask row into it. The pass reads
// only shared memory and costs K short steps, whatever the chain length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_K = 1024;     // one 32-lane warp holds the whole row set
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
nms_keep(const float4* __restrict__ boxes,   // (B, K) boxes
         const uint8_t* __restrict__ valid,  // (B, K) 0/1
         uint8_t* __restrict__ keep,         // (B, K) 0/1
         int K, float thresh) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int W = (K + 31) / 32;
    float4* bx = reinterpret_cast<float4*>(smem_raw);           // [K]
    float* area = reinterpret_cast<float*>(bx + K);             // [K]
    uint32_t* over = reinterpret_cast<uint32_t*>(area + K);     // [K][W]

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int i = tid; i < K; i += THREADS) {
        const float4 v = boxes[(size_t)b * K + i];
        bx[i] = v;
        area[i] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    }
    __syncthreads();

    // over[i][w] bit t  <=>  j = 32 w + t > i  and  IoU(i, j) > thresh
    for (int p = warp; p < K * W; p += THREADS / 32) {
        const int i = p / W;
        const int w = p - i * W;
        const int j = w * 32 + lane;
        bool hit = false;
        if (j > i && j < K) {
            const float4 a = bx[i];
            const float4 c = bx[j];
            const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z),
                                             fmaxf(a.x, c.x)), 0.f);
            const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w),
                                             fmaxf(a.y, c.y)), 0.f);
            const float inter = __fmul_rn(iw, ih);
            const float den = __fadd_rn(
                __fsub_rn(__fadd_rn(area[i], area[j]), inter), 1e-7f);
            hit = __fdiv_rn(inter, den) > thresh;
        }
        const uint32_t word = __ballot_sync(FULL, hit);
        if (lane == 0) over[i * W + w] = word;
    }
    __syncthreads();

    if (warp != 0) return;
    uint32_t valid_w = 0, removed = 0, keep_w = 0;
    if (lane < W) {
        for (int t = 0; t < 32; ++t) {
            const int j = lane * 32 + t;
            if (j < K && valid[(size_t)b * K + j]) valid_w |= 1u << t;
        }
    }
    for (int i = 0; i < K; ++i) {
        const int w = i >> 5;
        const uint32_t bit = 1u << (i & 31);
        const uint32_t vw = __shfl_sync(FULL, valid_w, w);
        const uint32_t rw = __shfl_sync(FULL, removed, w);
        if ((vw & bit) && !(rw & bit)) {        // the same on every lane
            if (lane == w) keep_w |= bit;
            if (lane < W) removed |= over[i * W + lane];
        }
    }
    if (lane < W) {
        for (int t = 0; t < 32; ++t) {
            const int j = lane * 32 + t;
            if (j < K) keep[(size_t)b * K + j] = (keep_w >> t) & 1u;
        }
    }
}

}  // namespace

// Shape contract (checked by the Python wrapper): B > 0, 0 < K <= 1024,
// boxes (B, K, 4) float32 and valid/keep (B, K) one byte each, contiguous.
extern "C" int yc_nms_keep(const void* boxes, const void* valid, void* keep,
                           int B, int K, float thresh, void* stream) {
    if (K > MAX_K) return (int)cudaErrorInvalidValue;
    const int W = (K + 31) / 32;
    const size_t smem = (size_t)K * (sizeof(float4) + sizeof(float))
                        + (size_t)K * W * sizeof(uint32_t);
    cudaFuncSetAttribute(nms_keep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    nms_keep<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep, K,
        thresh);
    return (int)cudaGetLastError();
}

extern "C" const char* yc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
