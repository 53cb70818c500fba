// Device helpers shared by the bf16 flash-attention kernels (forward and
// backward, the bf16 halves of flash_attention_fwd.cu and
// flash_attention_bwd.cu): cp.async staging of bf16 row tiles, bf16 tensor-
// core products with f32 accumulation, and the tile geometry. K1-bf16's
// cluster plan (lstm_sequence.cu) takes mma_bf16 and the ldmatrix loads.
//
// Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one
// product a tile (the operands are already bf16, so one product is the
// reference's precision: the TPU kernel multiplies bf16 operands with
// preferred_element_type=f32). Fragment layouts (g = lane / 4, t = lane % 4;
// two bf16 in one 32-bit register, the lower column in the low half):
//   A (16 x 16, row major): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, "col"):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
//
// * S = X Y^T (scores, dP) with X and Y row-major [rows][Dh] tiles: the A
//   fragment is X's rows g, g+8 and the B fragment Y's row g, both two
//   contiguous bf16, so each is one 32-bit shared-memory load.
// * O += P Z (P V, dS K, P^T dO, dS^T Q): P's C fragments of two adjacent
//   8-wide column blocks are exactly the A fragment of one 16-deep k-step,
//   rounded to bf16 in registers (no shared memory, no shuffle). Z is a
//   row-major [keys][Dh] tile whose B fragment needs two rows a register,
//   so it is read transposed by ldmatrix.x4.trans: four 8x8 matrices a
//   call, the b0 and b1 of two 8-wide column blocks.
// * Rows of a staged tile are padded to Dh + 8 bf16 (LD): the 32 32-bit
//   loads of a fragment (rows g, words t) fall on banks 4g + t, and the 8
//   16-byte rows of an ldmatrix matrix on 8 distinct 4-bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dl4j_bf16 {

using bf16 = __nv_bfloat16;

// Tile geometry of the three kernels at head width DH: BR resident rows a
// block (16 a warp row group), BC streamed rows a tile; at Dh 256 two warps
// share a row group and each keeps half of the output columns, so the f32
// accumulators fit the registers.
template <int DH>
struct Cfg {
    static constexpr int WN = DH == 256 ? 2 : 1;  // warps sharing a row group
    static constexpr int THREADS = 128 * WN;      // 4 row groups of 16
    static constexpr int BR = 64;
    static constexpr int BC = DH == 64 ? 64 : 32;
    static constexpr int LD = DH + 8;             // row stride of a tile
    static constexpr int DW = DH / WN;            // output columns of a warp
    static constexpr int NS = BC / 8;             // 8-wide blocks of a score row
    static constexpr int ND = DW / 8;             // 8-wide blocks of an output row
    static constexpr int TILE = BC * LD;          // bf16 of a streamed tile
    static constexpr int RES = BR * LD;           // bf16 of a resident tile
    static_assert(NS % 2 == 0 && ND % 2 == 0, "k-steps of 16, column pairs");
    static_assert(64 % BC == 0, "tiles divide T % 64 == 0");
};

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// at most N of this thread's newest commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of a [*, DH] head slice into dst[.][LD], 8 bf16 (16 bytes)
// a copy, as part of the caller's next commit group
template <int DH, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           int rows) {
    constexpr int V8 = DH / 8, LD = DH + 8;
    for (int i = threadIdx.x; i < rows * V8; i += THREADS) {
        const int r = i / V8, c = (i % V8) * 8;
        cp_async16(dst + r * LD + c, src + (size_t)r * DH + c);
    }
}

// n f32 (n % 4 == 0) into dst
template <int THREADS>
__device__ __forceinline__ void stage_vec(float* dst, const float* __restrict__ src,
                                          int n) {
    for (int i = threadIdx.x; i < n / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
}

// ------------------------------------------------------------ fragments
__device__ __forceinline__ unsigned ld32(const bf16* p) {
    return *reinterpret_cast<const unsigned*>(p);
}

// two f32 rounded to nearest bf16: lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// four 8x8 bf16 matrices, lane l addressing row l % 8 of matrix l / 8 (16
// contiguous bytes): r[m] holds row g, columns 2t..2t+1 of matrix m
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

// two matrices (lanes 0-15 address their rows)
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(s)
                 : "memory");
}

// the same, transposed: r[m] holds rows 2t..2t+1 of column g of matrix m
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ products
// acc[j] (16 rows x NS*8 columns) = X Y^T over DH, f32. xp = X + g*LD + 2t
// (the warp's first row), yp = Y + g*LD + 2t (a streamed tile's row 0).
template <int DH, int NS>
__device__ __forceinline__ void scores(float (&acc)[NS][4], const bf16* xp,
                                       const bf16* yp) {
    constexpr int LD = DH + 8;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
        const bf16* x = xp + ks * 16;
        const unsigned a[4] = {ld32(x), ld32(x + 8 * LD), ld32(x + 8), ld32(x + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const bf16* y = yp + j * 8 * LD + ks * 16;
            mma_bf16(acc[j], a, ld32(y), ld32(y + 8));
        }
    }
}

// out[n] (16 rows x ND*8 columns) += bf16(A) Z, f32: A (16 x NS*8) in C
// fragments, Z a streamed [NS*8][LD] tile from its first output column on
// (zp = tile + column0), read transposed.
template <int DH, int NS, int ND>
__device__ __forceinline__ void accumulate(float (&out)[ND][4], const float (&a)[NS][4],
                                           const bf16* zp) {
    constexpr int LD = DH + 8;
    const int lane = threadIdx.x & 31;
    // lane l addresses row l % 8 of matrix l / 8: matrices 0, 1 are the
    // k-step's rows 0-7 and 8-15 of column block n, 2 and 3 of block n + 1
    const bf16* z = zp + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
        const unsigned af[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                                pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                                pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                                pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
            unsigned b[4];
            ldmatrix_x4_trans(b, z + kk * 16 * LD + n * 8);
            mma_bf16(out[n], af, b[0], b[1]);
            mma_bf16(out[n + 1], af, b[2], b[3]);
        }
    }
}

// rows g, g+8 of a warp's 16 output rows (C fragments), as bf16
template <int DH, int ND>
__device__ __forceinline__ void store_frags(bf16* __restrict__ out, const float (&acc)[ND][4],
                                            const float (&mul)[2], int g, int t) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<unsigned*>(out + (size_t)(g + 8 * h) * DH + n * 8 + 2 * t) =
                pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
}

}  // namespace dl4j_bf16
