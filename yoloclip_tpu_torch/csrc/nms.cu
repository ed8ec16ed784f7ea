// Exact greedy NMS keep mask for Hopper (sm_90a), any number of candidates.
//
// Replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas   (body _kernel).
//
// Input: per image, K >= 1 candidate boxes (x1, y1, x2, y2) sorted by score,
// best first, and a valid flag per candidate. Output: keep[i] is true iff
// candidate i is valid and no kept candidate ranked before it overlaps it
// with IoU > threshold -- the greedy result of
// yoloclip_tpu/ops/nms.py::_greedy_keep / _fixpoint_keep.
//
// IoU is yoloclip_tpu/ops/boxes.py::pairwise_iou:
//   inter / (area_a + area_b - inter + 1e-7), compared with a strict '>'.
// Every operation rounds on its own (this file is built with -fmad=false
// and spells the roundings out with __f*_rn), so the mask is bit-identical
// to the plain PyTorch version, whose elementwise ops round separately.
//
// Two kernels, launched one after the other on the caller's stream:
//
// 1. nms_mask builds the overlap bitmask in device memory, word major:
//    mask[b][w][i] bit t  <=>  j = 32 w + t > i  and  IoU(i, j) > thr, shape
//    (B, W = ceil(K / 32), 32 W) uint32 (rows padded to 32 W, so each word's
//    rows of one 32-candidate chunk are one aligned 128-byte line),
//    allocated by the wrapper. The grid covers the upper triangle of 64 x 64
//    candidate tiles of every image (blockIdx.x numbers the tiles,
//    blockIdx.y the image): 4352 blocks at B = 32, K = 1024, on all 132 SMs,
//    and 136 for a single image. A thread owns one row and one 32-column
//    word of its tile: it keeps its row box in registers, reads the column
//    boxes from shared memory (broadcast), runs the 32 IoUs with no branch
//    (a zero intersection takes no division) and masks j <= i and j >= K
//    once at the end; a warp's 32 rows store as
//    one coalesced 128-byte line. A tile with no valid row or no valid
//    column exits after reading the valid flags, and a warp whose column
//    word or whose 32 rows hold no valid candidate exits before computing,
//    so the work follows the valid candidates, not K^2.
//
// 2. nms_scan makes the greedy pass, one 512-thread block an image, with no
//    block barrier inside its loop. `alive` (one word per 32 candidates in
//    shared memory) starts as the valid bits; chunk c of 32 candidates
//    ends as its keep word. Warp 0 resolves the chunks in order: it clears
//    from word c the kept rows of chunks c - 1 and c - 2 itself (two words
//    a lane, loaded two chunks ahead with the diagonal words), then resolves
//    the chunk in registers -- each lane gathers the 32 diagonal words
//    (__shfl_sync) and walks the bits in order, a live candidate clearing
//    the later ones it overlaps -- and publishes the keep word through a
//    shared counter. Warps 1-15 each own a fixed set of words; as each
//    chunk is published they clear its kept rows from their words c + 3 on,
//    each from the word's 128-byte line of that chunk (loaded a chunk
//    ahead, prefetched into L2 two ahead), and publish their own progress,
//    which warp 0 waits for only when it is three chunks ahead. That is
//    K / 32 dependent steps instead of K, and only the words of kept rows
//    are used.
//
// K has no limit but device memory: the scan keeps 4 bytes of shared
// memory per 32 candidates (K = 1.8M would fill 227 KB), long after the
// (B, W, 32 W) mask has outgrown 80 GB (K ~ 800k for one image).
//
// Words the build leaves unwritten (tiles, column words or row groups with
// no valid candidate, and words left of the diagonal; the reused scratch
// holds stale bits there) are never read for a valid candidate: the scan
// reads no word w < i / 32 of row i, it reads a diagonal word of row i only
// when i is a live candidate, and then its tile has a valid row (i), its
// column word and its row group a valid candidate (i itself), so the word
// was written; it reads word w > i / 32 of row i only when i is kept, hence
// valid, and if that word was skipped, its column word holds no valid
// candidate, so `alive[w]` is already 0 there and clearing bits from it
// changes nothing. Bits for invalid columns in written words are harmless
// for the same reason.
//
// Why two kernels and not one with a per-image completion counter: the
// mask build wants many small blocks and the scan one wide block an
// image; a counter would need zeroing before every call (another launch)
// and would run the scan on whichever build block finished last, at the
// build's block shape. On one stream the second launch waits only for the
// first to drain.
//
// What bounds it on the H100: the mask build is ~30 instructions a pair
// on the CUDA cores (the IEEE division is 8 of them, one on the MUFU
// pipe), spread over every SM, against the 12 operations a pair that the
// roofline counts; the scan is warp 0's chain of K / 32 dependent chunks,
// each a shared-memory read, a warp reduction, 32 shuffles and up to 32
// two-instruction steps, while the loads it needs arrive a chunk ahead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;              // candidates along each side of a tile
constexpr int BUILD_THREADS = 128;    // one per (row, column word) of a tile
constexpr int SCAN_THREADS = 512;     // warp 0 resolves, 15 warps clear
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The 32 rows of one chunk in one word: one aligned 128-byte line.
struct Line {
    uint4 q[8];
};

__device__ __forceinline__ Line load_line(const uint32_t* over, int w,
                                          size_t Kp, int chunk) {
    const uint4* p =
        reinterpret_cast<const uint4*>(over + (size_t)w * Kp + 32 * chunk);
    Line l;
#pragma unroll
    for (int q = 0; q < 8; ++q) l.q[q] = p[q];
    return l;
}

// OR of the line's words whose bit is set in `rows`.
__device__ __forceinline__ uint32_t pick(const Line& l, uint32_t rows) {
    uint32_t hit = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const uint32_t b = rows >> (4 * q);
        hit |= (b & 1u ? l.q[q].x : 0u) | (b & 2u ? l.q[q].y : 0u)
             | (b & 4u ? l.q[q].z : 0u) | (b & 8u ? l.q[q].w : 0u);
    }
    return hit;
}

__global__ void __launch_bounds__(BUILD_THREADS)
nms_mask(const float4* __restrict__ boxes,   // (B, K) boxes
         const uint8_t* __restrict__ valid,  // (B, K) 0/1
         uint32_t* __restrict__ mask,        // (B, W, 32 W) words
         int K, int W, float thresh) {
    __shared__ float4 col_box[TILE];         // zero past K
    __shared__ float col_area[TILE];
    __shared__ uint32_t row_ok[2], col_ok[2];  // valid bits, 32 a word

    // Upper-triangle tile (rt, ct), rt <= ct, numbered ct (ct + 1) / 2 + rt.
    const long long t = blockIdx.x;
    long long ct = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (ct * (ct + 1) / 2 > t) --ct;
    while ((ct + 1) * (ct + 2) / 2 <= t) ++ct;
    const int r0 = (int)(t - ct * (ct + 1) / 2) * TILE;
    const int c0 = (int)ct * TILE;
    const size_t img = (size_t)blockIdx.y * K;

    // Thread (h, r) computes the word of row r0 + r over the 32 columns
    // c0 + 32 h + [0, 32); warp w holds h = w / 2 and 32 consecutive rows.
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h = tid / TILE, r = tid & (TILE - 1);
    // Threads 0-63 read the rows' valid flags, 64-127 the columns'.
    const int k = (h ? c0 : r0) + r;
    const bool ok = k < K && valid[img + k];
    const uint32_t bits = __ballot_sync(FULL, ok);
    if (lane == 0) (h ? col_ok : row_ok)[warp & 1] = bits;
    if (!__syncthreads_or(!h && ok) || !(col_ok[0] | col_ok[1]))
        return;                              // no valid row or no valid column

    if (h) {
        const float4 v = k < K ? boxes[img + k]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        col_box[r] = v;
        col_area[r] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    }
    const int i = r0 + r;
    const float4 a = i < K ? boxes[img + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float aa = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
    __syncthreads();

    const bool row_valid = (row_ok[r >> 5] >> (r & 31)) & 1u;
    // A column word with no valid candidate, 32 rows none of which is
    // valid, or a word left of the rows' own (every j < i) is never read
    // (the note at the top): leave it unwritten.
    const int jb = c0 + 32 * h;
    if (!col_ok[h] || jb < r0 + 32 * (warp & 1)
        || !__any_sync(FULL, row_valid))
        return;
    const bool zero_hit = 0.f > thresh;      // IoU 0 above the threshold
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {           // branch-free: masked below
        const float4 c = col_box[32 * h + b];
        const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)),
                               0.f);
        const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)),
                               0.f);
        const float inter = __fmul_rn(iw, ih);
        const float den = __fadd_rn(
            __fsub_rn(__fadd_rn(aa, col_area[32 * h + b]), inter), 1e-7f);
        // 0 / den is +-0, or NaN when den is 0 or NaN: decided without the
        // division, whose range check (FCHK) would send a zero dividend
        // down its slow path. Other lanes divide as the plain version does.
        const bool meet = inter > 0.f;
        const float q = __fdiv_rn(meet ? inter : 1.f, den);
        const bool hit = meet ? q > thresh
                              : zero_hit && den != 0.f && den == den;
        word |= (uint32_t)hit << b;
    }
    // Only columns j with i < j < K, and nothing for an invalid row.
    const int lo = i - jb + 1, hi = K - jb;  // allowed bits: lo <= b < hi
    const uint32_t from = lo <= 0 ? FULL : lo >= 32 ? 0u : FULL << lo;
    const uint32_t below = hi >= 32 ? FULL : hi <= 0 ? 0u : FULL >> (32 - hi);
    if (i < K)
        mask[((size_t)blockIdx.y * W + (jb >> 5)) * (32 * (size_t)W) + i] =
            row_valid ? word & from & below : 0u;
}

// Spin on a shared-memory counter until it reaches `target`, backing off;
// a counter that never gets there traps rather than hanging the card.
__device__ __forceinline__ int wait_at_least(const volatile int* counter,
                                             int target) {
    int v = *counter;
    for (int spins = 0; v < target; v = *counter) {
        if (++spins > (1 << 24)) __trap();
        __nanosleep(32);
    }
    __threadfence_block();                   // acquire what came before it
    return v;
}

__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan(const uint32_t* __restrict__ mask,  // (B, W, 32 W) words
         const uint8_t* __restrict__ valid,  // (B, K) 0/1
         uint8_t* __restrict__ keep,         // (B, K) 0/1
         int K, int W) {
    extern __shared__ uint32_t alive[];      // [W] live candidates, then keep
    __shared__ int n_words;                  // 1 + last word with a valid one
    __shared__ volatile int resolved;        // chunks warp 0 has resolved
    __shared__ volatile int cleared[SCAN_WARPS];  // chunks each warp applied
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t Kp = 32 * (size_t)W;        // padded row count of a word
    const size_t img = (size_t)blockIdx.x * K;
    const uint32_t* over = mask + (size_t)blockIdx.x * W * Kp;

    if (tid == 0) n_words = resolved = 0;
    if (tid < SCAN_WARPS) cleared[tid] = 0;
    __syncthreads();
#pragma unroll 4
    for (int w = warp; w < W; w += SCAN_WARPS) {
        const int j = w * 32 + lane;
        const uint32_t bits = __ballot_sync(FULL, j < K && valid[img + j]);
        if (lane == 0) {
            alive[w] = bits;
            if (bits) atomicMax(&n_words, w + 1);
        }
    }
    __syncthreads();
    const int hi = n_words;                  // no valid candidate from here

    if (warp == 0) {
        // Chunk c: clear the kept rows of chunks c - 1 and c - 2 from word
        // c (x1, x2: those rows of word c), once warps 1-15 have cleared
        // chunks up to c - 3 from it; resolve; publish the keep word.
        // Chunk c's diagonal word and rows of chunks c - 1, c - 2 in word c
        // (zero where there is no such chunk or it is past hi).
        auto words = [&](int c, uint32_t& diag, uint32_t& x1, uint32_t& x2) {
            const size_t row = (size_t)c * (Kp + 32) + lane;
            diag = c < hi ? over[row] : 0u;
            x1 = c < hi && c >= 1 ? over[row - 32] : 0u;
            x2 = c < hi && c >= 2 ? over[row - 64] : 0u;
        };
        uint32_t k1 = 0, k2 = 0;             // keep words of c - 1, c - 2
        uint32_t diag, x1, x2, diag_n, x1_n, x2_n;   // chunks c, c + 1
        words(0, diag, x1, x2);
        words(1, diag_n, x1_n, x2_n);
        int done = 0;                        // every clearer is past this
        for (int c = 0; c < hi; ++c) {
            uint32_t diag_nn, x1_nn, x2_nn;  // chunk c + 2, two ahead
            words(c + 2, diag_nn, x1_nn, x2_nn);
            if (done < c - 2) {
                const int v = lane && lane < SCAN_WARPS
                    ? wait_at_least(&cleared[lane], c - 2) : hi;
                done = __reduce_min_sync(FULL, v);
                __syncwarp();
                __threadfence_block();       // for the lanes that did not wait
            }
            uint32_t live = alive[c] & ~__reduce_or_sync(
                FULL, ((k1 >> lane) & 1u ? x1 : 0u)
                          | ((k2 >> lane) & 1u ? x2 : 0u));
            if (live) {
                // The greedy order inside the chunk, in registers: every
                // lane holds all 32 diagonal words and walks the bits in
                // order (the same walk on every lane); a live candidate is
                // kept and clears the later ones it overlaps, so what
                // stays live at the end is the kept set. Groups of 8 with
                // no live bit are skipped.
                uint32_t d[32];
#pragma unroll
                for (int b = 0; b < 32; ++b) d[b] = __shfl_sync(FULL, diag, b);
#pragma unroll
                for (int g = 0; g < 32; g += 8) {
                    if (!((live >> g) & 0xffu)) continue;
#pragma unroll
                    for (int b = g; b < g + 8; ++b)
                        if ((live >> b) & 1u) live &= ~d[b];
                }
            }
            if (lane == 0) {
                alive[c] = live;             // now chunk c's keep word
                __threadfence_block();       // release it with the count
                resolved = c + 1;
            }
            k2 = k1;
            k1 = live;
            diag = diag_n;
            x1 = x1_n;
            x2 = x2_n;
            diag_n = diag_nn;
            x1_n = x1_nn;
            x2_n = x2_nn;
        }
    } else {
        // Warps 1-15 own words l, l + NL, ... (l = this lane's index among
        // them, NL = 480), so no two lanes ever write one word. Once chunk c
        // is resolved, clear its kept rows from the owned words w >= c + 3:
        // the first from its 128-byte line, loaded a chunk ahead into
        // registers, further ones (K above 15,360) loaded here after an L2
        // prefetch a chunk ahead.
        constexpr int NL = (SCAN_WARPS - 1) * 32;
        const int l = tid - 32;
        auto first_owned = [&](int from) {   // smallest owned word >= from
            return from <= l ? l : l + (from - l + NL - 1) / NL * NL;
        };
        int w1 = first_owned(3);
        Line line = {};
        if (w1 < hi) line = load_line(over, w1, Kp, 0);
        for (int c = 0; c < hi; ++c) {
            const int w1_n = first_owned(c + 4);
            Line line_n = {};
            if (c + 1 < hi) {
                if (w1_n < hi) line_n = load_line(over, w1_n, Kp, c + 1);
                for (int w = w1_n + NL; w < hi; w += NL)
                    prefetch_l2(over + (size_t)w * Kp + 32 * (c + 1));
            }
            const int w1_nn = first_owned(c + 5);
            if (c + 2 < hi && w1_nn < hi)    // two chunks ahead, into L2
                prefetch_l2(over + (size_t)w1_nn * Kp + 32 * (c + 2));
            wait_at_least(&resolved, c + 1);
            const uint32_t kept = alive[c];
            if (kept) {
                if (w1 < hi) alive[w1] &= ~pick(line, kept);
                for (int w = w1 + NL; w < hi; w += NL)
                    alive[w] &= ~pick(load_line(over, w, Kp, c), kept);
            }
            line = line_n;
            w1 = w1_n;
            __syncwarp();
            if (lane == 0) {
                __threadfence_block();       // release the warp's updates
                cleared[warp] = c + 1;
            }
        }
    }
    __syncthreads();

    for (int j = tid; j < K; j += SCAN_THREADS) {
        const int w = j >> 5;
        keep[img + j] = w < hi ? (uint8_t)((alive[w] >> (j & 31)) & 1u) : 0;
    }
}

}  // namespace

// Shape contract (checked by the Python wrapper): 0 < B <= 65535, K > 0,
// boxes (B, K, 4) float32 16-byte aligned, valid/keep (B, K) one byte each,
// mask (B, W, 32 W) uint32 scratch with W = ceil(K / 32), all contiguous.
// `stages`: 1 runs the mask build, 2 the scan (on the mask already
// there), 3 both.
extern "C" int yc_nms_keep(const void* boxes, const void* valid, void* mask,
                           void* keep, int B, int K, float thresh, int stages,
                           void* stream) {
    const int W = (K + 31) / 32;
    const long long T = (K + TILE - 1) / TILE;
    const cudaStream_t s = (cudaStream_t)stream;
    if (stages & 1) {
        const dim3 grid((unsigned)(T * (T + 1) / 2), B);
        nms_mask<<<grid, BUILD_THREADS, 0, s>>>(
            (const float4*)boxes, (const uint8_t*)valid, (uint32_t*)mask, K,
            W, thresh);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (stages & 2) {
        const size_t smem = (size_t)W * sizeof(uint32_t);
        // Raised once, and again only for a larger K: past 48 KB (K above
        // 393,216) dynamic shared memory needs the opt-in.
        static size_t smem_allowed = 48 * 1024;
        if (smem > smem_allowed) {
            const cudaError_t err = cudaFuncSetAttribute(
                nms_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (err != cudaSuccess) return (int)err;
            smem_allowed = smem;
        }
        nms_scan<<<B, SCAN_THREADS, smem, s>>>(
            (const uint32_t*)mask, (const uint8_t*)valid, (uint8_t*)keep, K,
            W);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* yc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
