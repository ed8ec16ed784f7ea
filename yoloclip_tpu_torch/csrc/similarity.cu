// Region-text cosine max/argmax for Hopper (sm_90a), in two modes of one
// kernel.
//
// Folded mode (FOLD = true) replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/similarity.py::fused_projected_similarity_argmax
//   (body _folded_kernel).
// Per image b and anchor a it computes
//   raw[a, c] = h[a] . tp[c] + cb[c]          (c < num_valid)
//   score[a]  = max_c raw[a, c] / max(||h[a] K + bias||, 1e-12)
//   id[a]     = the lowest c that attains the max
// where tp = text K^T and cb = text . bias are built by the Python wrapper
// (ops/kernels/similarity.py), exactly as the JAX function builds them.
// Neither the projected (B, A, E) embeddings nor the (B, A, C) similarity
// ever reach device memory: the only outputs are (B, A) scores and ids.
//
// Unprojected mode (FOLD = false) replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/similarity.py::fused_similarity_argmax
//   (body _kernel).
// The rows are already-projected embeddings obj (B, A, E) and the class
// product contracts over E instead of the hidden width:
//   raw[a, c] = obj[a] . text[c]              (c < num_valid)
//   score[a]  = max_c raw[a, c]  [/ max(||obj[a]||, 1e-12) if normalize]
// The norm is a sum of squares over the resident obj tile, not a second
// product.
//
// What bounds them on the H100: arithmetic. Folded, at batch 32 and
// 640 px, the row norm ||h K + bias|| is an (A x 256) @ (256 x 512)
// product per image (~70 GFLOP over the three levels), about 6x the class
// product at C = 80. Unprojected at C = 1203, the class product is
// 2 B A E C = 331 GFLOP against 551 MB of fp32 obj rows. The bytes are
// small beside the work: the row tile is read once, K and the text stay
// in L2.
//
// This first design runs the products as fp32 FMA loops on the CUDA
// cores, register-tiled: one block per (anchor tile of 64, image), 256
// threads, each thread owns a 4 x 4 output tile. The block keeps its row
// tile in shared memory (transposed, fp32) for the whole kernel (up to 512
// columns: 139 KB), streams K in 32 x 64 tiles for the folded norm, then
// streams the text in 64-class tiles for the scores and keeps a running
// max/argmax per row in registers. Inputs are fp32 or bf16 (template
// parameter); products and sums are fp32. Ties go to the lowest class
// index: each thread scans its columns in index order with a strict '>'
// and the cross-thread reduction breaks ties by index. Tensor cores
// (wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TA = 64;          // anchors per block
constexpr int TN = 64;          // output columns (E or classes) per pass
constexpr int TK = 32;          // contraction step
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int HS_LD = TA + 4;   // padded row of the transposed row tile
constexpr int WS_LD = TN + 4;   // padded row of the streamed K / text tile
constexpr float NEG = -1e30f;   // masked score, as in the Pallas kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// acc[i][j] += sum_kk hs[k0 + kk][ty*4 + i] * ws[kk][tx*4 + j]
__device__ __forceinline__ void tile_fma(const float* hs, const float* ws,
                                         int k0, int tx, int ty,
                                         float acc[4][4]) {
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
        const float4 av =
            *reinterpret_cast<const float4*>(&hs[(k0 + kk) * HS_LD + ty * 4]);
        const float4 bv =
            *reinterpret_cast<const float4*>(&ws[kk * WS_LD + tx * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
}

// FOLD: h (B, A, Kd) hidden rows, tp (B, C, Kd), cb (B, C), kmat (Kd, E),
// bias (E,); the score is always divided by ||h K + bias||.
// !FOLD: h (B, A, Kd) obj rows with Kd = E, tp (B, C, Kd) text; cb, kmat,
// bias and E unused; the score is divided by ||obj|| when normalize != 0.
template <typename T, bool FOLD>
__global__ void __launch_bounds__(THREADS)
similarity_argmax(const T* __restrict__ h, const T* __restrict__ tp,
                  const float* __restrict__ cb, const T* __restrict__ kmat,
                  const float* __restrict__ bias, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int A, int Kd, int C, int E,
                  int nvalid, int normalize) {
    extern __shared__ __align__(16) float smem[];
    float* hs = smem;                   // [Kd][HS_LD]: row tile, transposed
    float* ws = smem + Kd * HS_LD;      // [TK][WS_LD]: K or text^T tile

    const int b = blockIdx.y;
    const int a0 = blockIdx.x * TA;
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    const T* hb = h + (size_t)b * A * Kd;
    for (int idx = tid; idx < TA * Kd; idx += THREADS) {
        const int r = idx / Kd;
        const int k = idx - r * Kd;
        const int a = a0 + r;
        hs[k * HS_LD + r] = a < A ? to_f32(hb[(size_t)a * Kd + k]) : 0.f;
    }
    __syncthreads();

    // Squared row norms: of obj = h K + bias (folded, E in chunks of TN
    // columns), or of the resident obj tile itself (unprojected).
    float ss[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (FOLD) {
        for (int e0 = 0; e0 < E; e0 += TN) {
            float acc[4][4] = {};
            for (int k0 = 0; k0 < Kd; k0 += TK) {
                for (int idx = tid; idx < TK * TN; idx += THREADS) {
                    const int kk = idx / TN;
                    const int e = idx - kk * TN;
                    ws[kk * WS_LD + e] =
                        to_f32(kmat[(size_t)(k0 + kk) * E + e0 + e]);
                }
                __syncthreads();
                tile_fma(hs, ws, k0, tx, ty, acc);
                __syncthreads();
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float bj = bias[e0 + tx * 4 + j];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float v = acc[i][j] + bj;
                    ss[i] = fmaf(v, v, ss[i]);
                }
            }
        }
    } else if (normalize) {
        for (int k = tx; k < Kd; k += 16) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float v = hs[k * HS_LD + ty * 4 + i];
                ss[i] = fmaf(v, v, ss[i]);
            }
        }
    }
    // The 16 threads that share rows ty*4..ty*4+3 are 16 adjacent lanes.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);

    // Class scores with a running max/argmax; classes >= nvalid never win.
    const int cvalid = nvalid < C ? nvalid : C;
    const T* tpb = tp + (size_t)b * C * Kd;
    float best[4] = {NEG, NEG, NEG, NEG};
    int bidx[4] = {0, 0, 0, 0};
    for (int c0 = 0; c0 < cvalid; c0 += TN) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < Kd; k0 += TK) {
            for (int idx = tid; idx < TN * TK; idx += THREADS) {
                const int c = idx / TK;
                const int kk = idx - c * TK;
                ws[kk * WS_LD + c] =
                    c0 + c < cvalid
                        ? to_f32(tpb[(size_t)(c0 + c) * Kd + k0 + kk]) : 0.f;
            }
            __syncthreads();
            tile_fma(hs, ws, k0, tx, ty, acc);
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx * 4 + j;
            if (c < cvalid) {
                float cj = 0.f;
                if constexpr (FOLD) cj = cb[(size_t)b * C + c];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float v = acc[i][j] + cj;
                    if (v > best[i]) {
                        best[i] = v;
                        bidx[i] = c;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
            if (ov > best[i] || (ov == best[i] && oi < bidx[i])) {
                best[i] = ov;
                bidx[i] = oi;
            }
        }
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int a = a0 + ty * 4 + i;
            if (a < A) {
                out_s[(size_t)b * A + a] =
                    FOLD || normalize ? best[i] / fmaxf(sqrtf(ss[i]), 1e-12f)
                                      : best[i];
                out_i[(size_t)b * A + a] = bidx[i];
            }
        }
    }
}

template <typename T, bool FOLD>
int launch(const void* h, const void* tp, const void* cb, const void* kmat,
           const void* bias, void* out_s, void* out_i, int B, int A, int Kd,
           int C, int E, int nvalid, int normalize, void* stream) {
    const size_t smem = ((size_t)Kd * HS_LD + TK * WS_LD) * sizeof(float);
    cudaFuncSetAttribute(similarity_argmax<T, FOLD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const dim3 grid((A + TA - 1) / TA, B);
    similarity_argmax<T, FOLD><<<grid, THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const T*)h, (const T*)tp, (const float*)cb, (const T*)kmat,
        (const float*)bias, (float*)out_s, (int32_t*)out_i, A, Kd, C, E,
        nvalid, normalize);
    return (int)cudaGetLastError();
}

}  // namespace

// Folded mode. Shape contract (checked by the Python wrapper): A > 0,
// B > 0, Kd % 32 == 0 and Kd <= 512, E % 64 == 0, all tensors contiguous.
extern "C" int yc_similarity_f32(const void* h, const void* tp,
                                 const void* cb, const void* kmat,
                                 const void* bias, void* out_s, void* out_i,
                                 int B, int A, int Kd, int C, int E,
                                 int nvalid, void* stream) {
    return launch<float, true>(h, tp, cb, kmat, bias, out_s, out_i, B, A, Kd,
                               C, E, nvalid, 1, stream);
}

extern "C" int yc_similarity_bf16(const void* h, const void* tp,
                                  const void* cb, const void* kmat,
                                  const void* bias, void* out_s, void* out_i,
                                  int B, int A, int Kd, int C, int E,
                                  int nvalid, void* stream) {
    return launch<__nv_bfloat16, true>(h, tp, cb, kmat, bias, out_s, out_i,
                                       B, A, Kd, C, E, nvalid, 1, stream);
}

// Unprojected mode. Shape contract (checked by the Python wrapper): A > 0,
// B > 0, E % 32 == 0 and E <= 512, obj (B, A, E) and text (B, C, E)
// contiguous.
extern "C" int yc_similarity_unprojected_f32(const void* obj,
                                             const void* text, void* out_s,
                                             void* out_i, int B, int A,
                                             int E, int C, int nvalid,
                                             int normalize, void* stream) {
    return launch<float, false>(obj, text, nullptr, nullptr, nullptr, out_s,
                                out_i, B, A, E, C, 0, nvalid, normalize,
                                stream);
}

extern "C" int yc_similarity_unprojected_bf16(const void* obj,
                                              const void* text, void* out_s,
                                              void* out_i, int B, int A,
                                              int E, int C, int nvalid,
                                              int normalize, void* stream) {
    return launch<__nv_bfloat16, false>(obj, text, nullptr, nullptr, nullptr,
                                        out_s, out_i, B, A, E, C, 0, nvalid,
                                        normalize, stream);
}

extern "C" const char* yc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
