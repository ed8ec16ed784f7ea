// Region-text cosine max/argmax for Hopper (sm_90a) on the tensor cores,
// in two modes of one kernel.
//
// Folded mode (FOLD = true) replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/similarity.py::fused_projected_similarity_argmax
//   (body _folded_kernel).
// Per image b and anchor a it computes
//   raw[a, c] = h[a] . tp[c] + cb[c]          (c < num_valid)
//   score[a]  = max_c raw[a, c] / max(||h[a] K + bias||, 1e-12)
//   id[a]     = the lowest c that attains the max
// where tp = text K^T (in the input type) and cb = text . bias (fp32) are
// built by the Python wrapper (ops/kernels/similarity.py) exactly as the
// JAX function builds them; the wrapper also passes K^T (E, Kd), so that
// both products read a K-major B operand. Its raw form (normalize = 0,
// YOLO-World's BatchNorm contrastive head) returns max_c raw[a, c] as it
// is and runs no norm tile.
//
// Unprojected mode (FOLD = false) replaces the Pallas TPU kernel
//   yoloclip_tpu/ops/pallas/similarity.py::fused_similarity_argmax
//   (body _kernel).
// The rows are already-projected embeddings obj (B, A, E):
//   raw[a, c] = obj[a] . text[c]              (c < num_valid)
//   score[a]  = max_c raw[a, c]  [/ max(||obj[a]||, 1e-12) if normalize]
//
// Neither the (B, A, E) projected rows nor the (B, A, C) similarity ever
// reach device memory: the only outputs are (B, A) scores and ids.
//
// What bounds them on the H100: operations. Kernel 1 at batch 32 and 640 px
// (A = 6400 + 1600 + 400, Kd = 256, E = 512) does 2 B A Kd (C + E) =
// 81.5 GFLOP for the three levels at C = 80 and 236 GFLOP at C = 1203 (the
// row norm ||h K + bias|| is the E = 512 part); kernel 3 at C = 1203 does
// 2 B A E C = 331 GFLOP. Their bytes (the row tiles once, text and K from
// L2) are small beside that work.
//
// Design. Both products run on the tensor cores with wgmma (m64nNk16 in
// bf16, m64nNk8 in TF32), accumulating in fp32 registers:
//  - A block owns ROWS = 64 * WM anchor rows of one image and keeps its
//    row tile resident in shared memory for the whole kernel (row-major,
//    16-byte chunks XOR-swizzled by row so ldmatrix is conflict-free).
//    Each warpgroup loads its A fragments from it with ldmatrix and issues
//    wgmma with A in registers (64 rows a warpgroup).
//  - The B operands (K^T for the folded norm, then tp or the text for the
//    class scores) stream in tiles of 128 rows through a ring of STAGES
//    buffers, 256 bytes of K a stage in bf16 and 128 in fp32, filled by
//    cp.async 16-byte copies issued STAGES - 1 tiles ahead, so loads
//    overlap the math. B sits in the 128-byte-swizzled K-major layout that
//    the wgmma descriptor reads (faster on the H100 than the no-swizzle
//    layout). Blocks begin their K loop, and the norm's E tiles, at
//    different tiles.
//  - bf16 inputs are multiplied as they are. fp32 inputs run as 3xTF32:
//    each operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi), both
//    rounded to nearest, and the product is lo.hi + hi.lo + hi.hi (the
//    lo.lo term is below fp32 rounding), which keeps fp32-level error. A is
//    split in registers; each thread splits the B chunks it copied, hi in
//    place and lo into a second plane of the stage.
//  - Epilogues run on the accumulator fragments: the norm adds the bias,
//    squares and sums per row; the scores add cb, mask c >= num_valid and
//    keep a running max/argmax per row. Each thread scans its columns in
//    index order with a strict '>', class tiles go in order, and the quad
//    (and, for WN = 2, the warpgroup pair) reduces with ties to the lower
//    index, so duplicate classes resolve to the lowest id. Unprojected
//    norms are sums of squares of the A fragments.
// Blocks: bf16 folded, four warpgroups on 256 rows (half the B traffic a
// row of 128-row blocks); bf16 unprojected and fp32 folded, two on 128
// rows; fp32 unprojected, whose 512-wide fp32 rows fill 128 KB at 64 rows,
// two on 64 rows that split each B tile's columns. Shared memory stays
// under 227 KB a block; one block runs on an SM at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                 // B rows (E columns or classes) a tile
constexpr int STAGES = 3;               // B ring depth
// B tile: BN rows of K-major operand, CHUNKS 16-byte chunks a row, in
// 128-byte swizzle atoms: chunk c of row n sits in atom c / 8, at
// n * 128 + ((c % 8) ^ (n % 8)) * 16 (the swizzle wgmma's 128B mode reads,
// and conflict-free for the 8 lanes of a cp.async phase); 8-row groups
// are SBO apart.
constexpr int SBO = 1024;
constexpr int ATOM = BN * 128;          // one 128-byte-wide slice of a tile
__device__ __forceinline__ int b_off(int n, int c) {
    return (c / 8) * ATOM + n * 128 + (((c % 8) ^ (n & 7)) * 16);
}
// K step ks (32 bytes of K) of a tile at addr.
__device__ __forceinline__ uint32_t b_kstep(uint32_t addr, int ks) {
    return addr + (ks / 4) * ATOM + (ks % 4) * 32;
}
// wgmma shared-memory descriptor of a B tile at addr: 128-byte swizzle
// (mode 1 in bits 62-63), SBO in bits 32-45, the unused LBO as 1.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(SBO >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr float NEG = -1e30f;           // masked score, as in the Pallas kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled where !pred (src then unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(pred ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32 fragments) (+)= A (64 x K, registers) . B (N x K, smem):
// m64n128k16 bf16, m64n128k8 and m64n64k8 TF32; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                     uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{" 
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
}

template <typename T, int NACC>
__device__ __forceinline__ void wgmma(float (&d)[NACC], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
    if constexpr (sizeof(T) == 2) {
        static_assert(NACC == 64, "bf16 runs m64n128k16");
        wgmma_bf16_n128(d, a, desc, scale_d);
    } else if constexpr (NACC == 64) {
        wgmma_tf32_n128(d, a, desc, scale_d);
    } else {
        wgmma_tf32_n64(d, a, desc, scale_d);
    }
}

__device__ __forceinline__ void ss_add(float& s, uint32_t x, bool bf16) {
    if (bf16) {
        const float lo = __uint_as_float(x << 16);
        const float hi = __uint_as_float(x & 0xffff0000u);
        s = fmaf(lo, lo, s);
        s = fmaf(hi, hi, s);
    } else {
        const float v = __uint_as_float(x);
        s = fmaf(v, v, s);
    }
}

// Max/argmax merge: the larger value wins, ties go to the lower index.
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

// 16-byte chunks of K a B row, a stage: 256 bytes in bf16; 128 in fp32,
// whose stages hold a second (TF32 low) plane and whose rows take twice
// the room.
template <typename T>
__host__ __device__ constexpr int chunks() {
    return sizeof(T) == 2 ? 16 : 8;
}

// FOLD: h (B, A, Kd) hidden rows, bmat = tp (B, C, Kd), cb (B, C),
// kt = K^T (E, Kd), bias (E,); the score is divided by ||h K + bias||
// when normalize != 0 (kt and bias unread otherwise).
// !FOLD: h (B, A, Kd) obj rows with Kd = E, bmat = text (B, C, Kd); cb, kt,
// bias and E unused; the score is divided by ||obj|| when normalize != 0.
// WM warpgroups split the rows (64 each), WN split each B tile's columns.
template <typename T, bool FOLD, int WM, int WN>
__global__ void __launch_bounds__(128 * WM * WN, 1)
similarity_wgmma(const T* __restrict__ h, const T* __restrict__ bmat,
                 const float* __restrict__ cb, const T* __restrict__ kt_mat,
                 const float* __restrict__ bias, float* __restrict__ out_s,
                 int32_t* __restrict__ out_i, int A, int Kd, int C, int E,
                 int nvalid, int normalize) {
    constexpr bool BF16 = sizeof(T) == 2;
    constexpr int NT = 128 * WM * WN;       // threads
    constexpr int NW = BN / WN;             // B rows (columns) a warpgroup
    constexpr int NACC = NW / 2;            // fp32 accumulators a thread
    constexpr int ROWS = 64 * WM;
    constexpr int ESZ = sizeof(T);
    constexpr int CHUNKS = chunks<T>();     // 16-byte chunks a B row, a stage
    constexpr int PLANE = CHUNKS / 8 * ATOM;    // one B tile
    constexpr int BK = CHUNKS * 16 / ESZ;   // K elements a stage
    constexpr int KSTEP = 32 / ESZ;         // K of one wgmma (2 chunks)
    constexpr int KSTEPS = BK / KSTEP;
    constexpr int PLANES = BF16 ? 1 : 2;    // fp32: TF32 hi (in place), lo
    constexpr int PER_THREAD = BN * CHUNKS / NT;   // B chunks a thread copies

    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* a_s = smem;                         // ROWS x Kd
    unsigned char* ring = smem + (size_t)ROWS * Kd * ESZ;

    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int q = lane % 4;
    const int wg_m = wg % WM;
    const int wg_n = wg / WM;
    const int b = blockIdx.y;
    const int a0 = blockIdx.x * ROWS;
    const int row_bytes = Kd * ESZ;
    const int row_chunks = row_bytes / 16;

    // The resident row tile; rows past A are zeros. It lands with stage 0.
    for (int i = tid; i < ROWS * row_chunks; i += NT) {
        const int r = i / row_chunks;
        const int c = i - r * row_chunks;
        const bool ok = a0 + r < A;
        const T* src = ok ? h + ((size_t)b * A + a0 + r) * Kd + c * (16 / ESZ)
                          : h;
        cp_async16(smem_u32(a_s + r * row_bytes + ((c ^ (r & 7)) * 16)), src,
                   ok);
    }

    // Jobs: the E tiles of the folded norm, then the class tiles (at least
    // one, so an all-masked row still gets its norm), in order; each is KT
    // stages. Blocks start their K loop (and the norm's E tiles) at
    // different tiles, so that they do not all read the same B tile at
    // the same time.
    const int cvalid = nvalid < C ? nvalid : C;
    const int n_norm = FOLD && normalize ? E / BN : 0;
    const int n_cls = cvalid > BN ? (cvalid + BN - 1) / BN : 1;
    const int KT = Kd / BK;
    const int total = (n_norm + n_cls) * KT;
    const int rot = blockIdx.x + blockIdx.y;
    auto phys_kt = [&](int kt) { return (kt + rot) % KT; };
    auto phys_norm = [&](int j) { return n_norm ? (j + rot) % n_norm : j; };
    const T* bb = bmat + (size_t)b * C * Kd;

    // Offset of chunk it of this thread's share of a B tile.
    auto chunk_off = [&](int it) {
        const int i = tid + it * NT;
        return b_off(i / CHUNKS, i % CHUNKS);
    };
    auto load_stage = [&](int s) {
        if (s < total) {
            const int j = s / KT;
            const int kt = phys_kt(s - j * KT);
            const bool norm_job = FOLD && j < n_norm;
            const T* src = norm_job ? kt_mat : bb;
            const int row0 = (norm_job ? phys_norm(j) : j - n_norm) * BN;
            const int nrows = norm_job ? E : C;
            const uint32_t st =
                smem_u32(ring + (s % STAGES) * PLANES * PLANE);
#pragma unroll
            for (int it = 0; it < PER_THREAD; ++it) {
                const int i = tid + it * NT;
                const int n = i / CHUNKS;
                const bool ok = row0 + n < nrows;
                const size_t off = ok ? (size_t)(row0 + n) * Kd + kt * BK +
                                            (i % CHUNKS) * (16 / ESZ)
                                      : 0;
                cp_async16(st + chunk_off(it), src + off, ok);
            }
        }
        cp_async_commit();   // empty groups keep the count uniform
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load_stage(s);

    // ldmatrix.x4: lanes 8m..8m+7 address matrix m = (rows +8 if m odd,
    // chunk +1 if m >= 2); registers 0..3 come back in A-fragment order.
    const int mi = lane / 8;
    const int a_row = wg_m * 64 + warp * 16 + (mi & 1) * 8 + lane % 8;
    const uint32_t a_addr = smem_u32(a_s) + a_row * row_bytes;
    const int a_sw = a_row & 7;

    float acc[NACC];
    float best[2] = {NEG, NEG};
    int bidx[2] = {0, 0};
    float ss[2] = {0.f, 0.f};

    for (int s = 0; s < total; ++s) {
        cp_async_wait<STAGES - 2>();     // this thread's copies of stage s
        unsigned char* st = ring + (s % STAGES) * PLANES * PLANE;
        if constexpr (!BF16) {
            // 3xTF32: split the fp32 B chunks this thread copied into the
            // TF32 high part (in place) and the low part (second plane).
#pragma unroll
            for (int it = 0; it < PER_THREAD; ++it) {
                float4* p = reinterpret_cast<float4*>(st + chunk_off(it));
                const float4 x = *p;
                float4 hi, lo;
                hi.x = __uint_as_float(to_tf32(x.x));
                hi.y = __uint_as_float(to_tf32(x.y));
                hi.z = __uint_as_float(to_tf32(x.z));
                hi.w = __uint_as_float(to_tf32(x.w));
                lo.x = __uint_as_float(to_tf32(x.x - hi.x));
                lo.y = __uint_as_float(to_tf32(x.y - hi.y));
                lo.z = __uint_as_float(to_tf32(x.z - hi.z));
                lo.w = __uint_as_float(to_tf32(x.w - hi.w));
                *p = hi;
                *reinterpret_cast<float4*>(
                    reinterpret_cast<unsigned char*>(p) + PLANE) = lo;
            }
        }
        fence_proxy_async();
        __syncthreads();     // stage s is in; stage s - 1 is free
        load_stage(s + STAGES - 1);

        const int j = s / KT;
        const int kt = s - j * KT;
        const uint32_t b_addr = smem_u32(st) + wg_n * (NW / 8) * SBO;
        uint32_t af[KSTEPS][4];
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            const int chunk =
                (phys_kt(kt) * BK + ks * KSTEP) * ESZ / 16 + (mi >> 1);
            ldmatrix_x4(af[ks], a_addr + ((chunk ^ a_sw) * 16));
        }
        if (!FOLD && normalize && j == 0) {
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
                ss_add(ss[0], af[ks][0], BF16);
                ss_add(ss[0], af[ks][2], BF16);
                ss_add(ss[1], af[ks][1], BF16);
                ss_add(ss[1], af[ks][3], BF16);
            }
        }

        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            const uint32_t addr = b_kstep(b_addr, ks);
            const int scale_d = kt > 0 || ks > 0;
            if constexpr (BF16) {
                wgmma<T>(acc, af[ks], b_desc(addr), scale_d);
            } else {
                uint32_t hi[4], lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float x = __uint_as_float(af[ks][r]);
                    hi[r] = to_tf32(x);
                    lo[r] = to_tf32(x - __uint_as_float(hi[r]));
                }
                wgmma<T>(acc, lo, b_desc(addr), scale_d);
                wgmma<T>(acc, hi, b_desc(addr + PLANE), 1);
                wgmma<T>(acc, hi, b_desc(addr), 1);
            }
        }
        wg_commit();
        wg_wait_all();
        fence_acc(acc);

        if (kt == KT - 1) {
            // Fragment (i, e) of column group g: row +8 if i, column
            // 8 g + 2 q + e of this warpgroup's NW.
            if (FOLD && j < n_norm) {
                const int e0 = phys_norm(j) * BN + wg_n * NW + 2 * q;
#pragma unroll
                for (int g = 0; g < NW / 8; ++g) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float bj = __ldg(bias + e0 + 8 * g + e);
                        const float v0 = acc[g * 4 + e] + bj;
                        const float v1 = acc[g * 4 + 2 + e] + bj;
                        ss[0] = fmaf(v0, v0, ss[0]);
                        ss[1] = fmaf(v1, v1, ss[1]);
                    }
                }
            } else {
                const int c0 = (j - n_norm) * BN + wg_n * NW + 2 * q;
#pragma unroll
                for (int g = 0; g < NW / 8; ++g) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = c0 + 8 * g + e;
                        if (c < cvalid) {
                            float v0 = acc[g * 4 + e];
                            float v1 = acc[g * 4 + 2 + e];
                            if constexpr (FOLD) {
                                const float cj = __ldg(cb + (size_t)b * C + c);
                                v0 += cj;
                                v1 += cj;
                            }
                            if (v0 > best[0]) {
                                best[0] = v0;
                                bidx[0] = c;
                            }
                            if (v1 > best[1]) {
                                best[1] = v1;
                                bidx[1] = c;
                            }
                        }
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

    // The quad's four lanes hold the same two rows.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
            const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
            merge(best[i], bidx[i], ov, oi);
        }
    }
    const int r0 = wg_m * 64 + warp * 16 + lane / 4;
    if constexpr (WN == 2) {
        // The second column half hands its max/argmax to the first.
        float* xs = reinterpret_cast<float*>(ring);
        int* xi = reinterpret_cast<int*>(ring + ROWS * sizeof(float));
        __syncthreads();
        if (wg_n == 1 && q == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                xs[r0 + 8 * i] = best[i];
                xi[r0 + 8 * i] = bidx[i];
            }
        }
        __syncthreads();
        if (wg_n == 1) return;
#pragma unroll
        for (int i = 0; i < 2; ++i)
            merge(best[i], bidx[i], xs[r0 + 8 * i], xi[r0 + 8 * i]);
    }
    if (q == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int a = a0 + r0 + 8 * i;
            if (a < A) {
                out_s[(size_t)b * A + a] =
                    normalize ? best[i] / fmaxf(sqrtf(ss[i]), 1e-12f)
                              : best[i];
                out_i[(size_t)b * A + a] = bidx[i];
            }
        }
    }
}

// Largest row width of each mode (the wrapper refuses wider rows).
constexpr int MAX_KD_FOLD = 256;
constexpr int MAX_E_UNPROJECTED = 512;

template <typename T, bool FOLD, int WM, int WN>
int launch(const void* h, const void* bmat, const void* cb, const void* kt,
           const void* bias, void* out_s, void* out_i, int B, int A, int Kd,
           int C, int E, int nvalid, int normalize, void* stream) {
    constexpr int ROWS = 64 * WM;
    // The ring, plus room to align it to the 1024-byte swizzle pattern.
    constexpr size_t RING =
        (size_t)STAGES * (sizeof(T) == 2 ? 1 : 2) * (chunks<T>() / 8) * ATOM +
        1024;
    auto* kernel = similarity_wgmma<T, FOLD, WM, WN>;
    // Once per process and instantiation: room for the widest rows.
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ROWS * (FOLD ? MAX_KD_FOLD : MAX_E_UNPROJECTED) * sizeof(T) +
              RING));
    if (attr != cudaSuccess) return (int)attr;
    const size_t smem = (size_t)ROWS * Kd * sizeof(T) + RING;
    const dim3 grid((A + ROWS - 1) / ROWS, B);
    kernel<<<grid, 128 * WM * WN, smem, (cudaStream_t)stream>>>(
        (const T*)h, (const T*)bmat, (const float*)cb, (const T*)kt,
        (const float*)bias, (float*)out_s, (int32_t*)out_i, A, Kd, C, E,
        nvalid, normalize);
    return (int)cudaGetLastError();
}

}  // namespace

// Folded mode. Shape contract (checked by the Python wrapper): B, A > 0,
// C >= 1, Kd % 128 == 0 and Kd <= 256, E % 128 == 0, tp (B, C, Kd)
// and kt = K^T (E, Kd) in the input type, cb (B, C) and bias (E,) fp32, all
// contiguous and 16-byte aligned. bf16 runs 256-row blocks (four
// warpgroups), fp32 128-row blocks (its rows take twice the room).
extern "C" int yc_similarity_f32(const void* h, const void* tp,
                                 const void* cb, const void* kt,
                                 const void* bias, void* out_s, void* out_i,
                                 int B, int A, int Kd, int C, int E,
                                 int nvalid, void* stream) {
    return launch<float, true, 2, 1>(h, tp, cb, kt, bias, out_s, out_i, B,
                                     A, Kd, C, E, nvalid, 1, stream);
}

extern "C" int yc_similarity_bf16(const void* h, const void* tp,
                                  const void* cb, const void* kt,
                                  const void* bias, void* out_s, void* out_i,
                                  int B, int A, int Kd, int C, int E,
                                  int nvalid, void* stream) {
    return launch<__nv_bfloat16, true, 4, 1>(h, tp, cb, kt, bias, out_s,
                                             out_i, B, A, Kd, C, E, nvalid, 1,
                                             stream);
}

// Folded raw mode: the folded mode's launchers and shape contract, the
// score not divided by the row norm.
extern "C" int yc_similarity_raw_f32(const void* h, const void* tp,
                                     const void* cb, const void* kt,
                                     const void* bias, void* out_s,
                                     void* out_i, int B, int A, int Kd, int C,
                                     int E, int nvalid, void* stream) {
    return launch<float, true, 2, 1>(h, tp, cb, kt, bias, out_s, out_i, B,
                                     A, Kd, C, E, nvalid, 0, stream);
}

extern "C" int yc_similarity_raw_bf16(const void* h, const void* tp,
                                      const void* cb, const void* kt,
                                      const void* bias, void* out_s,
                                      void* out_i, int B, int A, int Kd,
                                      int C, int E, int nvalid, void* stream) {
    return launch<__nv_bfloat16, true, 4, 1>(h, tp, cb, kt, bias, out_s,
                                             out_i, B, A, Kd, C, E, nvalid, 0,
                                             stream);
}

// Unprojected mode. Shape contract (checked by the Python wrapper): B, A > 0,
// C >= 1, E % 128 == 0 and E <= 512, obj (B, A, E) and text (B, C, E)
// in the input type, contiguous and 16-byte aligned. bf16 runs 128-row
// blocks; fp32 runs 64-row blocks whose two warpgroups split each class
// tile (a 128-row fp32 tile at E = 512 would not fit).
extern "C" int yc_similarity_unprojected_f32(const void* obj,
                                             const void* text, void* out_s,
                                             void* out_i, int B, int A,
                                             int E, int C, int nvalid,
                                             int normalize, void* stream) {
    return launch<float, false, 1, 2>(obj, text, nullptr, nullptr, nullptr,
                                      out_s, out_i, B, A, E, C, 0, nvalid,
                                      normalize, stream);
}

extern "C" int yc_similarity_unprojected_bf16(const void* obj,
                                              const void* text, void* out_s,
                                              void* out_i, int B, int A,
                                              int E, int C, int nvalid,
                                              int normalize, void* stream) {
    return launch<__nv_bfloat16, false, 2, 1>(obj, text, nullptr, nullptr,
                                               nullptr, out_s, out_i, B, A,
                                               E, C, 0, nvalid, normalize,
                                               stream);
}

extern "C" const char* yc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
