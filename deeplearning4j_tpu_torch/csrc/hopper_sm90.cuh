// Hopper (sm_90a) building blocks of the redesigned bf16 flash-attention
// kernels (flash_attention_fwd.cu's and flash_attention_bwd.cu's wgmma
// kernels): TMA tensor maps and loads, mbarriers, wgmma with shared-memory
// matrix descriptors, named barriers and setmaxnreg. Inline PTX only; no
// CUTLASS.
//
// * Tensor maps. cuTensorMapEncodeTiled lives in libcuda, which the
//   libraries do not link, so it is fetched once through
//   cudaGetDriverEntryPoint. A head tensor [bh, t, dh] bf16 is mapped as 3
//   dimensions (dh, t, bh), boxes of {64, rows, 1}: a load that runs past
//   a head's last row is zero-filled instead of reading the next head, and
//   64 bf16 are one 128-byte row, the width of the 128-byte swizzle.
// * Shared-memory tiles as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B:
//   [rows][64] bf16, row r at r * 128 bytes, its 16-byte chunk c stored at
//   chunk c ^ (r % 8); a tile starts on a 1024-byte boundary.
// * wgmma operands from such a tile (descriptor: start >> 4, LBO >> 4 at
//   bit 16, SBO >> 4 at bit 32, layout 1 = 128-byte swizzle at bit 62):
//   - K-major (the contraction index along a row: Q, K as the A or B of
//     S = Q K^T): SBO = 1024 (8 rows), LBO unused; k-step kk (16 columns,
//     32 bytes) starts kk * 32 bytes in.
//   - MN-major (the contraction index down the rows: V in P V, dO in
//     P^T dO, Q in dS^T Q; tnspB = 1): SBO = 1024 (8 contraction rows), LBO
//     the stride between 64-wide panels of the other index (one panel at
//     Dh 64); k-step kk (16 rows) starts kk * 2048 bytes in.
// * wgmma accumulators (m64nNk16, f32): warp w of the warpgroup holds rows
//   16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4); register
//   4j + e of 8-wide column block j is row 16w + g + 8 (e >> 1), column
//   8j + 2t + (e & 1): mma.sync's C layout, block by block. A from
//   registers takes each warp's 16 rows in mma.sync's m16n8k16 A layout,
//   so two adjacent column blocks of an accumulator, rounded to bf16 and
//   paired, are one k-step's A operand (pack_a).
// * Asynchrony: a wgmma reads its A registers and writes its accumulator
//   after it is issued, until wgmma.wait_group. fence_regs after the wait
//   keeps the compiler from reusing or reading those registers earlier.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j_sm90 {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ host: tensor maps
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once; null when libcuda has
// none
inline EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = []() -> EncodeTiledFn {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                    &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            return nullptr;
        return reinterpret_cast<EncodeTiledFn>(p);
    }();
    return fn;
}

// The tensor map of a contiguous [bh, t, dh] bf16 head tensor at `heads`,
// loaded in boxes of `rows` rows by 64 columns, 128-byte swizzled. Returns
// a cudaError_t: cudaErrorNotSupported without the function,
// cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses the map.
inline cudaError_t encode_heads(CUtensorMap* map, const void* heads, int bh, int t,
                                int dh, int rows) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)t, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)dh * sizeof(bf16),
                                   (cuuint64_t)t * dh * sizeof(bf16)};
    const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(heads),
                          dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past the edge
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the device's SM count (the persistent kernels launch one block per SM)
inline cudaError_t sm_count(int* n) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    return err;
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes), once per
// device for each launch site: `done` is that site's bitmask of devices
// (devices past 63 set it on every launch). It is a property of the
// function on a device, and setting it on every launch costs host time
// that a 50 us kernel launched back to back would wait for.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned long long* done) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit && (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && bit) __atomic_fetch_or(done, bit, __ATOMIC_RELEASE);
    return err;
}

// ------------------------------------------------------------ persistent blocks
// The i-th work item of this block, in a snake over rounds of gridDim.x
// items: block b takes item b of even rounds and item G - 1 - b of odd
// ones. Items are numbered heaviest first, so the snake evens out what
// each block gets; every item below the count is taken once.
__device__ __forceinline__ int snake_item(int i) {
    const int G = gridDim.x;
    return i * G + ((i & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// ------------------------------------------------------------ shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// the first 1024-byte boundary at or after p (the launch asks for 1 KB more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    const uint32_t s = smem_u32(p);
    return p + (((s + 1023u) & ~1023u) - s);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

// after the inits, before any thread or the TMA uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

// one arrival for the calling warp, by its lane 0, once every lane has
// come here (a predicated arrive: no branch near the wgmmas)
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
    __syncwarp();
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
        "r"(threadIdx.x & 31)
        : "memory");
}

// wait until the phase of parity `parity` has completed (phase n of a
// barrier has parity n & 1; barriers start in phase 0)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

// ------------------------------------------------------------ TMA
// box (c0 = column, c1 = row, c2 = head) of a 3-D tensor map into dst,
// completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) into dst,
// completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// ------------------------------------------------------------ warpgroups
template <int REGS>
__device__ __forceinline__ void regs_grow() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_shrink() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// named barrier `id` (1..15) over `threads` threads: sync waits, arrive
// does not
__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------ wgmma
// 128-byte-swizzled operand at p (see the top of this file)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
           ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
           ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

// a descriptor moved `bytes` (a multiple of 16) further into its tile
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
    return desc + (uint64_t)(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N of the warpgroup's newest commit groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers read or written by an in-flight wgmma: neither moved across
// this point nor reused before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the MUFU alone (ex2.approx.ftz: results below 2^-126 flush to 0,
// far below a bf16 P's or an f32 row sum's last bit); exp2f adds a range
// fix-up of three instructions around it
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// two f32 rounded to nearest bf16: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// accumulator column blocks (2kk, 2kk + 1) of c, rounded to bf16, as
// k-step kk's A operand a[4kk .. 4kk + 3] of a register-A wgmma
template <int NC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NC / 2], const float (&c)[NC]) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) a[i] = pack_bf16(c[2 * i], c[2 * i + 1]);
}

// d (64 x N, f32) = A B (+ d when accumulate != 0) over one k-step of 16.
// _ss: A and B from shared memory by descriptor (A K-major); _rs: A from
// registers (a0..a3). B is MN-major when TB (tnspB = 1), else K-major.
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
          "r"(accumulate), "n"(TB));
}

}  // namespace dl4j_sm90
