// Device helpers shared by the flash-attention kernels (forward and
// backward): cp.async staging of row tiles, the TF32 split of f32 operands
// and the 3xTF32 tensor-core product that keeps f32 accuracy.
//
// 3xTF32: every operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big); a product is small.big + big.small + big.big
// accumulated in f32 by mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// small terms first, small.small dropped. big is rounded explicitly (the
// tensor core ignores the low 13 bits of an operand), so small is taken
// from exactly the big the tensor core sees. The rounding is computed on
// the int32 view: two integer instructions, where ptxas expands
// cvt.rna.tf32.f32 into about five (its NaN handling included).
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, "col"):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// A C fragment feeds the next product's A fragment from registers when the
// contraction index of each 8-wide step is permuted: logical column t <-
// key 2t and t + 4 <- key 2t + 1 (accumulate below); the B fragment then
// reads rows 2t and 2t + 1 of the streamed tile.
//
// Rows of a staged tile are padded to DH + 4 floats (LD): the 32 loads of a
// fragment (rows g, columns t: bank 4g + t; rows 2t, 2t + 1, columns g:
// bank 8t + g) fall on 32 distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace dl4j_tf32 {

constexpr int kThreads = 256;  // 8 warps: every kernel that stages with these

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group this thread committed has landed (its own copies)
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [0, rows) of a [*, DH] head slice into dst[.][LD], 16 bytes a
// thread per step, asynchronously (part of the caller's next commit group).
template <int DH, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int rows) {
    constexpr int V4 = DH / 4;
    for (int i = threadIdx.x; i < rows * V4; i += kThreads) {
        const int r = i / V4, c = (i % V4) * 4;
        cp_async16(dst + r * LD + c, src + (size_t)r * DH + c);
    }
}

__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src,
                                          int n) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i);
}

// ------------------------------------------------------------ TF32 split
// rna_tf32 (to nearest, ties away from zero, on a 10-bit mantissa; the low
// 13 bits 0) for every finite x, on the int32 view
__device__ __forceinline__ unsigned to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ a rounding of order 2^-22 x)
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split_n(const float (&x)[N], unsigned (&big)[N],
                                        unsigned (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// Splits rows [0, rows) of a staged [.][LD] tile in place into its big
// plane and the small plane `plane` floats on. Each thread splits exactly
// the 16-byte pieces that stage_rows<DH, LD> had it copy, so its own
// cp.async wait suffices before this; a __syncthreads then publishes the
// planes to every warp.
template <int DH, int LD>
__device__ __forceinline__ void split_rows(float* tile, int rows, int plane) {
    constexpr int V4 = DH / 4;
    for (int i = threadIdx.x; i < rows * V4; i += kThreads) {
        float* p = tile + (i / V4) * LD + (i % V4) * 4;
        const float4 x = *reinterpret_cast<const float4*>(p);
        unsigned b[4], sm[4];
        split(x.x, b[0], sm[0]);
        split(x.y, b[1], sm[1]);
        split(x.z, b[2], sm[2]);
        split(x.w, b[3], sm[3]);
        *reinterpret_cast<uint4*>(p) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(p + plane) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
}

// ------------------------------------------------------------ products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at f32 accuracy: small terms first, small.small dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ab)[4],
                                           const unsigned (&as)[4],
                                           const unsigned (&bb)[2],
                                           const unsigned (&bs)[2]) {
    mma_tf32(d, as, bb);
    mma_tf32(d, ab, bs);
    mma_tf32(d, ab, bb);
}

// out[n] (16 rows x ND*8 columns) += A Z, where A (16 x NS*8) is a score
// tile held in C fragments and Z a streamed tile split into planes (small
// plane PLANE floats on, rows LD apart); the contraction runs over Z's rows
// in the permuted order (see the top of this file). The tile's share is
// summed in the tensor core from zero and then added to out in f32: the
// tensor core adds into its accumulator with truncation, so a chain of
// MMAs over a whole sequence would drift. zp = Z + 2t*LD + column0 + g.
template <int NS, int ND, int LD, int PLANE>
__device__ __forceinline__ void accumulate(float (&out)[ND][4], const float (&a)[NS][4],
                                           const float* zp) {
    float part[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
        // A fragment (row g, cols t, t+4) <- C fragment (row g, cols 2t, 2t+1)
        const float av[4] = {a[kk][0], a[kk][2], a[kk][1], a[kk][3]};
        unsigned ab[4], as[4];
        split_n(av, ab, as);
        const unsigned* z = reinterpret_cast<const unsigned*>(zp) + kk * 8 * LD;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            const unsigned bb[2] = {z[n * 8], z[LD + n * 8]};
            const unsigned bs[2] = {z[PLANE + n * 8], z[PLANE + LD + n * 8]};
            mma_3xtf32(part[n], ab, as, bb, bs);
        }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] += part[n][e];
}

}  // namespace dl4j_tf32
