// Flash-attention forward for Hopper (sm_90a): f32 on the tensor cores at
// f32 accuracy (3xTF32), described here, and bf16 (the mixed-precision
// path), described at its kernel further down.
//
// Replaces the forward of PallasFlashAttentionHelper.attend
// (deeplearning4j_tpu/nn/pallas_kernels.py:359), which calls jax's bundled
// TPU kernel jax.experimental.pallas.ops.tpu.flash_attention:
//     o = softmax(q k^T / sqrt(Dh) [causal]) v,   q, k, v, o: [N, H, T, Dh] f32,
// with an optional LSE output for the backward (csrc/flash_attention_bwd.cu):
// lse[n*h, T] = the natural-log logsumexp of the SCALED scores q.k / sqrt(Dh)
// of each row. A null pointer skips it, so the inference path writes
// nothing extra.
//
// What bounds it. At the served and trained GPT-2-small shape [N=8, H=12,
// T=1024, Dh=64], causal, the two [T x T x Dh] products over the causal
// pairs T(T+1)/2 of each head are 12.9 GFLOP. As 3xTF32 (three TF32
// products for one f32-accurate one) at the H100 SXM's 495 TFLOP/s dense
// TF32 that is 0.078 ms; the bytes (q, k, v read once, o written once,
// 4 x 25.2 MB) take 0.030 ms at 3.35 TB/s. So it is bound by operations.
// chip_smoke.py re-derives both for the card it runs on.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W, median of 25 launches):
// 0.295 ms, 27% of the 3xTF32 bound, against 0.493 ms for
// F.scaled_dot_product_attention and 0.443 ms for this kernel's earlier
// CUDA-core version. ptxas: 177 to 203 registers, no spills.
//
// Design (the backward's, csrc/flash_attention_bwd.cu, with two products):
//   * one block of 8 warps per (n*h, BR query rows); warp w owns 16 query
//     rows (row group w / WN) and Dh / WN columns of O (column part w % WN).
//     Dh 64 and 128: BR = 128, WN = 1. Dh 256: BR = 64, WN = 2 (the two
//     warps of a row group both compute its scores; each keeps half of O,
//     64 accumulator registers).
//   * Q is staged once and split in place into a big and a small plane, so
//     its A fragments cost 8 shared-memory loads and no arithmetic. K and V
//     tiles of BC rows (Dh 64: 64, Dh 128: 16, Dh 256: 8) stream through a
//     ring of 2 shared-memory stages filled by cp.async.cg (16 bytes a
//     thread); each tile is split once per block into planes by the threads
//     that copied it, as soon as their copies land, while the other stage
//     is multiplied. One __syncthreads per tile. Shared memory: 204 KB,
//     198 KB and 195 KB; one block per SM.
//   * Products: S = Q K^T and the tile's share of P V as 3xTF32
//     mma.sync.m16n8k8 (tf32_mma.cuh).
//   * Online softmax on the C fragments, in base 2: a row's running max is
//     reduced over its quad (the 4 lanes that hold the row) with two
//     shuffles; the running sum stays a per-lane partial (the max, and so
//     the rescale factor, is the quad's) and is reduced once at the end.
//   * P goes from the accumulators straight into the P V product's A
//     fragment by the permuted contraction order (tf32_mma.cuh): no shared
//     memory, no shuffle.
//   * Accumulation in f32: each K/V tile's share of P V is summed in the
//     tensor core from zero, then O <- alpha O + share by f32 operations.
//     The tensor core truncates when it adds into its accumulator, and
//     chained over T = 1024 keys that drift broke the twin-net gradient
//     check for the backward.
//   * Causal: the key loop stops at the diagonal tile, a warp whose rows
//     all lie before a tile skips its products, masking is applied only in
//     tiles that cross the diagonal, and the heaviest query blocks are
//     scheduled first. Every processed tile holds an unmasked key for each
//     of the warp's rows at Dh 64 and 128; at Dh 256 (BC 8) the first tile
//     does, so the running max is finite from the first tile on.
//   * A last block of 64 rows (T % 128 == 64) leaves the warps of the
//     missing rows idle; they still stage, split and reach every barrier.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"
#include "hopper_sm90.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace dl4j_tf32;

constexpr int THREADS = kThreads;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads banks
constexpr int STAGES = 2;     // ring of streamed K/V tiles
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
struct Cfg {
    static constexpr int BR = DH == 256 ? 64 : 128;                // query rows
    static constexpr int BC = DH == 64 ? 64 : (DH == 128 ? 16 : 8);  // K/V rows a tile
    static constexpr int WN = WARPS / (BR / 16);  // warps sharing a row group
    static constexpr int DW = DH / WN;            // O columns of a warp
    static constexpr int LD = DH + PAD;           // row stride of a tile
    static constexpr int QPLANE = BR * LD;        // Q's big -> small plane
    static constexpr int PLANE = BC * LD;         // a streamed tile's big -> small
    static constexpr int NS = BC / 8;             // 8-wide blocks of a score row
    static constexpr int ND = DW / 8;             // 8-wide blocks of an O row
    static constexpr int STAGE = 4 * PLANE;       // K big, K small, V big, V small
    static constexpr size_t BYTES = (size_t)(2 * QPLANE + STAGES * STAGE) * sizeof(float);
    static_assert(WN * (BR / 16) == WARPS, "8 warps cover the query rows");
    static_assert(64 % BC == 0 && BR % 64 == 0, "tiles divide T % 64 == 0");
    static_assert(BYTES <= 232448, "a block may have 227 KB");
};

// acc[j] (16 query rows x NS*8 keys) = Q K^T over DH, both operands split
// into planes. qp = Q big + g*LD + t, kp = K big + g*LD + t.
template <int DH>
__device__ __forceinline__ void scores(float (&acc)[Cfg<DH>::NS][4], const float* qp,
                                       const float* kp) {
    using C = Cfg<DH>;
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks) {
        const unsigned* x = reinterpret_cast<const unsigned*>(qp) + ks * 8;
        const unsigned ab[4] = {x[0], x[8 * C::LD], x[4], x[8 * C::LD + 4]};
        const unsigned as[4] = {x[C::QPLANE], x[C::QPLANE + 8 * C::LD], x[C::QPLANE + 4],
                                x[C::QPLANE + 8 * C::LD + 4]};
#pragma unroll
        for (int j = 0; j < C::NS; ++j) {
            const unsigned* y = reinterpret_cast<const unsigned*>(kp) + j * 8 * C::LD + ks * 8;
            const unsigned bb[2] = {y[0], y[4]};
            const unsigned bs[2] = {y[C::PLANE], y[C::PLANE + 4]};
            mma_3xtf32(acc[j], ab, as, bb, bs);
        }
    }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, float* __restrict__ lse,
                           int T, float scale_log2) {
    using C = Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // big plane, then small
    float* KVs = Qs + 2 * C::QPLANE;              // STAGES x (K b, K s, V b, V s)

    const int n_blocks = (T + BR - 1) / BR;
    // causal: the last query blocks do the most work; start them first
    const int qb = CAUSAL ? (n_blocks - 1 - (int)blockIdx.y) : (int)blockIdx.y;
    const int q0 = qb * BR;
    const int rows = min(BR, T - q0);
    const size_t head = (size_t)blockIdx.x * T * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp / C::WN) * 16;      // the warp's rows in the block
    const int col0 = (warp % C::WN) * C::DW;  // and its O columns
    const bool active = r0 < rows;
    const int qw = q0 + r0;                  // the warp's first query row

    const int n_tiles = CAUSAL ? (q0 + rows) / BC : T / BC;
    auto stage = [&](int kt) {
        float* dst = KVs + (kt % STAGES) * C::STAGE;
        stage_rows<DH, C::LD>(dst, k + head + (size_t)kt * BC * DH, BC);
        stage_rows<DH, C::LD>(dst + 2 * C::PLANE, v + head + (size_t)kt * BC * DH, BC);
    };
    auto split_stage = [&](int kt) {
        float* dst = KVs + (kt % STAGES) * C::STAGE;
        split_rows<DH, C::LD>(dst, C::BC, C::PLANE);
        split_rows<DH, C::LD>(dst + 2 * C::PLANE, C::BC, C::PLANE);
    };
    stage_rows<DH, C::LD>(Qs, q + head + (size_t)q0 * DH, rows);
    stage(0);
    cp_async_commit();
    cp_async_wait_all();  // Q and the first K, V tile (this thread's copies)
    split_rows<DH, C::LD>(Qs, rows, C::QPLANE);
    split_stage(0);
    __syncthreads();

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // rows g and g + 8: running max (base 2, scaled), this lane's share of
    // the running sum
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const float* qp = Qs + (r0 + g) * LD + t;
    for (int kt = 0; kt < n_tiles; ++kt) {
        // tile kt is split (by every thread) and tile kt - 1 is consumed (by
        // every warp), so its stage may take tile kt + 1
        if (kt > 0) __syncthreads();
        if (kt + 1 < n_tiles) stage(kt + 1);
        cp_async_commit();
        const float* Ks = KVs + (kt % STAGES) * C::STAGE;
        const float* Vs = Ks + 2 * C::PLANE;
        const int k0 = kt * BC;
        // causal: skip a tile whose keys all lie after the warp's rows
        if (active && !(CAUSAL && k0 > qw + 15)) {
            float s[NS][4];
            scores<DH>(s, qp, Ks + g * LD + t);
            const bool mask = CAUSAL && k0 + BC - 1 > qw;
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int key = k0 + j * 8 + 2 * t + (e & 1);
                    const float val = (mask && key > qw + g + 8 * h)
                        ? -INFINITY : s[j][e] * scale_log2;
                    s[j][e] = val;
                    mx[h] = fmaxf(mx[h], val);
                }
            float alpha[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(m[h], mx[h]);  // finite (see the header)
                alpha[h] = exp2f(m[h] - m_new);          // 0 on the first tile
                m[h] = m_new;
                l[h] *= alpha[h];
            }
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = exp2f(s[j][e] - m[e >> 1]);
                    s[j][e] = p;
                    l[e >> 1] += p;
                }
#pragma unroll
            for (int n = 0; n < ND; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
            // O += P V, the tile's share summed from zero, added in f32
            accumulate<NS, ND, LD, C::PLANE>(acc, s, Vs + 2 * t * LD + col0 + g);
        }
        if (kt + 1 < n_tiles) {  // split this thread's part of the next tile
            cp_async_wait_all();
            split_stage(kt + 1);
        }
    }
    if (!active) return;  // after the last barrier
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    float* out = o + head + (size_t)qw * DH + col0;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(out + (size_t)(g + 8 * h) * DH + n * 8 + 2 * t) =
                make_float2(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    if (lse != nullptr && col0 == 0 && t == 0) {
        // m is in base-2 units of the scaled scores: ln(sum) = (m + log2 l) ln 2
        float* lh = lse + (size_t)blockIdx.x * T + qw + g;
        lh[0] = (m[0] + log2f(l[0])) * LN2;
        lh[8] = (m[1] + log2f(l[1])) * LN2;
    }
}

template <int DH, bool CAUSAL>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int t, cudaStream_t stream) {
    auto kernel = flash_attention_fwd_kernel<DH, CAUSAL>;
    const size_t smem = Cfg<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
    const dim3 grid(bh, (t + Cfg<DH>::BR - 1) / Cfg<DH>::BR);
    kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, t, scale_log2);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const float* q, const float* k, const float* v, float* o,
                      float* lse, int bh, int t, int causal, cudaStream_t stream) {
    return causal ? launch<DH, true>(q, k, v, o, lse, bh, t, stream)
                  : launch<DH, false>(q, k, v, o, lse, bh, t, stream);
}

}  // namespace

// q, k, v, o: contiguous [bh, t, dh] f32 on the device; lse: [bh, t] f32
// or null; t % 64 == 0, dh in {64, 128, 256}, 0 < t / 64 <= 65535.
// Returns a cudaError_t (0 = launched).
extern "C" int dl4j_flash_attention_fwd_f32(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int bh, int t, int dh, int causal,
                                            void* stream) {
    if (bh <= 0 || t <= 0 || t % 64 != 0 || t / 64 > 65535)
        return (int)cudaErrorInvalidValue;
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    float* lf = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 64: return (int)launch_dh<64>(qf, kf, vf, of, lf, bh, t, causal, s);
        case 128: return (int)launch_dh<128>(qf, kf, vf, of, lf, bh, t, causal, s);
        case 256: return (int)launch_dh<256>(qf, kf, vf, of, lf, bh, t, causal, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ======================================================================
// Flash-attention forward, bf16 (the mixed-precision path).
//
// Replaces the same TPU kernel on bf16 q, k, v: it multiplies bf16
// operands with f32 accumulation (preferred_element_type=f32), keeps the
// softmax statistics and the O accumulator in f32, rounds P (the
// exponentials relative to the running row max) to bf16 before P V, and
// writes O in bf16 and the LSE in f32 (jax 0.9.0's
// jax/experimental/pallas/ops/tpu/flash_attention.py :396, :471, :670,
// :688-693).
//
// What bounds it. At GPT-2-small's [8, 12, 1024, 64], causal, the two
// products over the causal pairs are 12.9 GFLOP, 0.013 ms at the H100
// SXM's 989 TFLOP/s dense bf16; q, k, v and o move 4 x 12.6 MB, 0.015 ms
// at 3.35 TB/s. chip_smoke.py re-derives both for the card it runs on.
//
// Design (the first bf16 kernel; it serves Dh 128 and 256, and Dh 64 takes
// the wgmma kernel below): one block
// per (n*h, 64 query rows), 4 row groups of 16 rows, one warp each (two at
// Dh 256, each keeping half of O's columns); Q resident in shared memory;
// K and V tiles of BC rows (64 at Dh 64, else 32) through a 2-stage
// cp.async ring; S = Q K^T and P V as bf16 mma.sync m16n8k16 (bf16_mma.cuh);
// the online softmax in base 2 on the C fragments, as the f32 kernel's;
// P goes from the accumulators into P V's A fragment in registers. Causal:
// the key loop stops at the diagonal, a warp skips a tile that lies wholly
// after its rows, the heaviest query blocks start first.

namespace {

namespace bf = dl4j_bf16;

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(bf::Cfg<DH>::THREADS)
flash_attention_fwd_bf16_kernel(const bf::bf16* __restrict__ q,
                                const bf::bf16* __restrict__ k,
                                const bf::bf16* __restrict__ v,
                                bf::bf16* __restrict__ o, float* __restrict__ lse,
                                int T, float scale_log2) {
    using C = bf::Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    extern __shared__ float4 smem4[];
    bf::bf16* Qs = reinterpret_cast<bf::bf16*>(smem4);
    bf::bf16* KVs = Qs + C::RES;  // 2 stages x (K, V)

    const int n_blocks = T / BR;
    const int qb = CAUSAL ? (n_blocks - 1 - (int)blockIdx.y) : (int)blockIdx.y;
    const int q0 = qb * BR;
    const size_t head = (size_t)blockIdx.x * T * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp / C::WN) * 16;
    const int col0 = (warp % C::WN) * C::DW;
    const int qw = q0 + r0;

    const int n_tiles = CAUSAL ? (q0 + BR) / BC : T / BC;
    auto stage = [&](int kt) {
        bf::bf16* dst = KVs + (kt & 1) * 2 * C::TILE;
        bf::stage_rows<DH, C::THREADS>(dst, k + head + (size_t)kt * BC * DH, BC);
        bf::stage_rows<DH, C::THREADS>(dst + C::TILE, v + head + (size_t)kt * BC * DH, BC);
    };
    bf::stage_rows<DH, C::THREADS>(Qs, q + head + (size_t)q0 * DH, BR);
    stage(0);
    bf::cp_async_commit();

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    const bf::bf16* qp = Qs + (r0 + g) * LD + 2 * t;
    for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) stage(kt + 1);  // into the stage tile kt - 1 left
        bf::cp_async_commit();
        bf::cp_async_wait<1>();  // tile kt (and Q) landed
        __syncthreads();
        const bf::bf16* Ks = KVs + (kt & 1) * 2 * C::TILE;
        const bf::bf16* Vs = Ks + C::TILE;
        const int k0 = kt * BC;
        if (!(CAUSAL && k0 > qw + 15)) {
            float s[NS][4];
            bf::scores<DH, NS>(s, qp, Ks + g * LD + 2 * t);
            const bool mask = CAUSAL && k0 + BC - 1 > qw;
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int key = k0 + j * 8 + 2 * t + (e & 1);
                    const float val = (mask && key > qw + g + 8 * h)
                        ? -INFINITY : s[j][e] * scale_log2;
                    s[j][e] = val;
                    mx[h] = fmaxf(mx[h], val);
                }
            float alpha[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                // finite from the first tile on: key 0 is every row's
                const float m_new = fmaxf(m[h], mx[h]);
                alpha[h] = exp2f(m[h] - m_new);
                m[h] = m_new;
                l[h] *= alpha[h];
            }
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = exp2f(s[j][e] - m[e >> 1]);
                    s[j][e] = p;
                    l[e >> 1] += p;  // the f32 p, as the TPU kernel sums it
                }
#pragma unroll
            for (int n = 0; n < ND; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
            bf::accumulate<DH, NS, ND>(acc, s, Vs + col0);  // O += bf16(P) V
        }
        __syncthreads();  // every warp is done with tile kt's stage
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    bf::store_frags<DH, ND>(o + head + (size_t)qw * DH + col0, acc, inv, g, t);
    if (lse != nullptr && col0 == 0 && t == 0) {
        float* lh = lse + (size_t)blockIdx.x * T + qw + g;
        lh[0] = (m[0] + log2f(l[0])) * LN2;
        lh[8] = (m[1] + log2f(l[1])) * LN2;
    }
}

template <int DH, bool CAUSAL>
cudaError_t launch_bf16(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                        bf::bf16* o, float* lse, int bh, int t, cudaStream_t stream) {
    using C = bf::Cfg<DH>;
    auto kernel = flash_attention_fwd_bf16_kernel<DH, CAUSAL>;
    const size_t smem = (size_t)(C::RES + 4 * C::TILE) * sizeof(bf::bf16);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
    const dim3 grid(bh, t / C::BR);
    kernel<<<grid, C::THREADS, smem, stream>>>(q, k, v, o, lse, t, scale_log2);
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16_dh(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                           bf::bf16* o, float* lse, int bh, int t, int causal,
                           cudaStream_t stream) {
    return causal ? launch_bf16<DH, true>(q, k, v, o, lse, bh, t, stream)
                  : launch_bf16<DH, false>(q, k, v, o, lse, bh, t, stream);
}

}  // namespace

// ======================================================================
// Flash-attention forward, bf16, redesigned for Hopper: the kernel that
// serves the bf16 forward at Dh 64 (GPT-2-small's [8, 12, 1024, 64]);
// Dh 128 and 256 keep the mma.sync kernel above. It computes what that
// kernel computes, at the same rounding points: S = Q K^T of bf16 operands
// in f32; the online softmax in f32, base 2; P = exp2(S scale log2e - m)
// against the running row max m, rounded to bf16 only as the operand of
// P V; the f32 row sum of the unrounded P; O divided by it and written in
// bf16; the LSE in f32.
//
// What held the mma.sync kernel back: mma.sync with 16 rows a warp, each
// warp reading its own B fragments from shared memory (about 256 bytes a
// 4,096-FLOP product, against the SM's 128 bytes a clock); cp.async copies
// issued by every thread in a 2-stage ring with two block-wide barriers a
// tile; the softmax and the products in series in every warp, where at
// Dh 64 the exponentials (MUFU) cost about as much as the products.
//
// What bounds it. At [8, 12, 1024, 64], causal, the two products are
// 12.9 GFLOP, 0.013 ms at 989 TFLOP/s dense bf16, and q, k, v and o move
// 4 x 12.6 MB, 0.015 ms at 3.35 TB/s: bytes, by a little. At Dh 64 the
// exponentials are a co-bound: a 128 x 128 tile's 16,384 ex2 take the
// MUFU (16 a clock an SM) as long as the tile's products take the tensor
// cores.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W): 0.0444 ms of device time
// a launch, against 0.0819 for the mma.sync kernel and 0.0455 for
// F.scaled_dot_product_attention in bf16; full attention 0.0706 (SDPA
// 0.0612). ptxas: 168 registers at launch, no spills.
//
// Design (hopper_sm90.cuh holds the pieces):
//   * Persistent: one block of 3 warpgroups on each SM walks work items
//     (n*h, BR = 128 query rows), numbered heaviest causal block first and
//     dealt to the blocks in a snake, so that the next item's loads run
//     under this item's last products and stores. Warpgroup 0 is the
//     producer (setmaxnreg down to 24): one thread issues every load by
//     TMA, Q into one of 2 buffers, K and V tiles of BC = 128 keys into a
//     ring of 4 stages, each with a full and an empty mbarrier. Warpgroups
//     1 and 2 are the consumers (setmaxnreg up to 240), 64 query rows each.
//   * S = Q K^T: wgmma m64n128k16 x 4, both operands from shared memory
//     (K-major). The online softmax runs on the accumulator, which holds
//     mma.sync's C layout block by block, so the quad reductions and the
//     masking are the mma.sync kernel's; the exponentials are the MUFU's
//     ex2 alone, the scale folded into one FFMA, and only the last key
//     tile of an item is compiled with the mask. P goes into the A
//     registers of P V (wgmma m64n64k16 x 8, V MN-major) in registers.
//   * Each tile's P V is summed in the tensor core from zero and added to
//     O in f32 (O <- alpha O + share): the tensor core truncates when it
//     adds into its accumulator, so no sum is chained across tiles.
//   * Overlap, as FlashAttention-3: a consumer issues S of tile j together
//     with P V of tile j - 1 and runs tile j's softmax while P V runs; the
//     two consumers take turns at issuing (named barriers 1 and 2, one
//     turn each per tile), so one's exponentials run under the other's
//     products. The first and last turns of an item are peeled off the
//     loop: a wgmma issued under a branch makes ptxas serialize them all.
//   * Causal: BR = BC, so the key loop stops at tile qb (the diagonal), the
//     only tile masked. Every row sees key 0 in tile 0, so the running max
//     is finite from the first tile on.
//   * T % 128 == 64: Q, K and V are mapped per head, so the last block's
//     rows past T load as zeros; those query rows are computed and never
//     stored, and keys past T are masked (full) or above the diagonal
//     (causal).

namespace {

namespace h9 = dl4j_sm90;

namespace wg_fwd {
constexpr int DH = 64, BR = 128, BC = 128, STAGES = 4, THREADS = 384;
constexpr int TILE = BC * DH;  // bf16 of a K or V tile
constexpr uint32_t TILE_BYTES = TILE * sizeof(bf::bf16), Q_BYTES = BR * DH * sizeof(bf::bf16);
// 1 KB to align the tiles, 2 Q buffers, the K and V stages, the barriers
constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * (4 + 2 * STAGES);
}  // namespace wg_fwd

// The online softmax of one tile on a consumer's S accumulator (64 rows x
// BC keys), in place: s becomes P = exp2(s scale_log2 - m) (f32), m the
// running max of rows g and g + 8 (base-2 units), l their running f32 sums
// (the quad's partial), alpha the factor that rescales the earlier tiles.
// MASKED: keys after the row (causal) or past T (full) are -inf. The max
// is taken on the unscaled scores (scale_log2 > 0), the scale and the max
// meet in one FFMA, and the row max and sum run in 4 partial chains.
template <bool CAUSAL, bool MASKED, int NB>
__device__ __forceinline__ void softmax_tile(float (&s)[4 * NB], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int k0,
                                             int row, int T, int t) {
    if constexpr (MASKED) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + 8 * j + 2 * t + (e & 1);
                if (CAUSAL ? key > row + 8 * (e >> 1) : key >= T) s[4 * j + e] = -INFINITY;
            }
    }
    // 4 partial maxima a row half: chains of NB / 4, not NB
    float part[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[h][c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            part[h][j & 3] = fmaxf(part[h][j & 3], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h)
        part[h][0] = fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
    float neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float mx = part[h][0];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * scale_log2);
        alpha[h] = h9::exp2_ftz(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[4 * j + e] = h9::exp2_ftz(fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]));
    // the row sums of the f32 p, as the TPU kernel sums it, in 4 partials
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[h][c] = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) part[h][j & 3] += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) part[h][0] = (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], part[h][0]);
}

// S = Q K^T of one K tile (wgmma m64n128k16 x 4, both operands K-major),
// one commit group
__device__ __forceinline__ void issue_scores(float (&s)[wg_fwd::BC / 2], uint64_t dq,
                                             const bf::bf16* k_tile) {
    const uint64_t dk = h9::desc_sw128(k_tile, 16, 1024);
#pragma unroll
    for (int ks = 0; ks < wg_fwd::DH / 16; ++ks)
        h9::wgmma_ss_n128<0>(s, h9::desc_at(dq, ks * 32), h9::desc_at(dk, ks * 32), ks);
    h9::wgmma_commit();
}

// share = bf16(P) V of one V tile (wgmma m64n64k16 x 8, P from registers, V
// MN-major), summed from zero; one commit group
__device__ __forceinline__ void issue_pv(float (&share)[wg_fwd::DH / 2],
                                         const uint32_t (&p)[wg_fwd::BC / 4],
                                         const bf::bf16* v_tile) {
    const uint64_t dv = h9::desc_sw128(v_tile, wg_fwd::TILE_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < wg_fwd::BC / 16; ++kk)
        h9::wgmma_rs_n64<1>(share, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                            h9::desc_at(dv, kk * 2048), kk);
    h9::wgmma_commit();
}

// a consumer's registers over one work item
struct FwdState {
    float s[wg_fwd::BC / 2];       // S, then P in f32
    float share[wg_fwd::DH / 2];   // one tile's P V
    float acc[wg_fwd::DH / 2];     // O, unnormalized
    uint32_t p[wg_fwd::BC / 4];    // bf16(P) as BC / 16 k-steps of A registers
    float m[2], l[2], alpha_prev[2];
};

// One turn of a consumer: S of k_tile (HAS_S) and P V of the previous tile
// (HAS_PV) issued together, between taking the turn (named barrier `mine`)
// and handing it on (`other`); the softmax of S (MASKED or not) while P V
// runs; O <- alpha O + share; the previous tile's stage released. Every
// wgmma a turn issues is waited for in the same turn: no wgmma crosses a
// branch (ptxas would serialize them all).
template <bool CAUSAL, bool MASKED, bool HAS_S, bool HAS_PV>
__device__ __forceinline__ void fwd_turn(FwdState& st, uint64_t dq, const bf::bf16* k_tile,
                                         const bf::bf16* v_prev, uint64_t* empty_prev,
                                         int mine, int other, float scale_log2, int k0, int row,
                                         int T, int t) {
    h9::bar_sync(mine, 256);
    h9::wgmma_fence();
    if constexpr (HAS_S) issue_scores(st.s, dq, k_tile);
    if constexpr (HAS_PV) issue_pv(st.share, st.p, v_prev);
    // consumer 1's last turn of its last item hands a turn to no one: that
    // arrival stays pending until the block exits
    h9::bar_arrive(other, 256);
    float alpha[2];
    if constexpr (HAS_S) {
        if constexpr (HAS_PV)
            h9::wgmma_wait<1>();  // S landed; P V may still run
        else
            h9::wgmma_wait<0>();
        h9::fence_regs(st.s);
        softmax_tile<CAUSAL, MASKED, wg_fwd::BC / 8>(st.s, st.m, st.l, alpha, scale_log2, k0,
                                                     row, T, t);
    }
    if constexpr (HAS_PV) {
        h9::wgmma_wait<0>();
        h9::fence_regs(st.share);
        h9::fence_regs(st.p);
        h9::mbar_arrive_warp(empty_prev);  // the previous tile is done
#pragma unroll
        for (int r = 0; r < wg_fwd::DH / 2; ++r)
            st.acc[r] = fmaf(st.acc[r], st.alpha_prev[(r >> 1) & 1], st.share[r]);
    }
    if constexpr (HAS_S) {
        h9::pack_a<wg_fwd::BC / 2>(st.p, st.s);  // P rounded to bf16, as the TPU kernel
        st.alpha_prev[0] = alpha[0];
        st.alpha_prev[1] = alpha[1];
    }
}

// work item w: query block qb of head `head`, the heaviest causal blocks first
__device__ __forceinline__ void fwd_item(int w, int bh, int n_qb, bool causal, int& qb,
                                         int& head) {
    head = w % bh;
    qb = causal ? n_qb - 1 - w / bh : w / bh;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(wg_fwd::THREADS, 1)
flash_attention_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                      const __grid_constant__ CUtensorMap tm_k,
                                      const __grid_constant__ CUtensorMap tm_v,
                                      bf::bf16* __restrict__ o, float* __restrict__ lse,
                                      int bh, int T, float scale_log2) {
    constexpr int DH = wg_fwd::DH, BR = wg_fwd::BR, BC = wg_fwd::BC;
    constexpr int STAGES = wg_fwd::STAGES, TILE = wg_fwd::TILE;
    constexpr uint32_t TILE_BYTES = wg_fwd::TILE_BYTES, Q_BYTES = wg_fwd::Q_BYTES;
    extern __shared__ unsigned char smem_raw[];
    bf::bf16* Qs = reinterpret_cast<bf::bf16*>(h9::align1024(smem_raw));  // 2 buffers
    bf::bf16* Ks = Qs + 2 * BR * DH;    // STAGES tiles
    bf::bf16* Vs = Ks + STAGES * TILE;  // STAGES tiles
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
    uint64_t* q_empty = q_full + 2;
    uint64_t* full = q_empty + 2;
    uint64_t* empty = full + STAGES;

    const int n_qb = (T + BR - 1) / BR, n_items = bh * n_qb;

    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            h9::mbar_init(&q_full[b], 1);
            h9::mbar_init(&q_empty[b], 2 * 4);  // every consumer warp
        }
        for (int s = 0; s < STAGES; ++s) {
            h9::mbar_init(&full[s], 1);
            h9::mbar_init(&empty[s], 2 * 4);
        }
        h9::mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {  // the producer warpgroup
        h9::regs_shrink<24>();
        if (threadIdx.x == 0) {
            int tile = 0;  // the ring's count of tiles, over every item
            for (int i = 0;; ++i) {
                const int w = h9::snake_item(i);
                if (w >= n_items) break;
                int qb, head;
                fwd_item(w, bh, n_qb, CAUSAL, qb, head);
                const int n_tiles = CAUSAL ? qb + 1 : (T + BC - 1) / BC;
                const int b = i & 1;
                if (i >= 2) h9::mbar_wait(&q_empty[b], (i / 2 - 1) & 1);
                h9::mbar_expect_tx(&q_full[b], Q_BYTES);
                h9::tma_load_3d(Qs + b * BR * DH, &tm_q, &q_full[b], 0, qb * BR, head);
                for (int kt = 0; kt < n_tiles; ++kt, ++tile) {
                    const int s = tile % STAGES;
                    if (tile >= STAGES) h9::mbar_wait(&empty[s], (tile / STAGES - 1) & 1);
                    h9::mbar_expect_tx(&full[s], 2 * TILE_BYTES);
                    h9::tma_load_3d(Ks + s * TILE, &tm_k, &full[s], 0, kt * BC, head);
                    h9::tma_load_3d(Vs + s * TILE, &tm_v, &full[s], 0, kt * BC, head);
                }
            }
        }
    } else {  // the consumer warpgroups
        h9::regs_grow<240>();
        const int cw = threadIdx.x / 128 - 1;
        const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int g = lane >> 2, t = lane & 3;
        const int mine = 1 + cw, other = 2 - cw;  // the turns' named barriers

        FwdState st;
        if (cw == 1) h9::bar_arrive(1, 256);  // consumer 0 takes the first turn
        int tile = 0;
        for (int i = 0;; ++i) {
            const int w = h9::snake_item(i);
            if (w >= n_items) break;
            int qb, head;
            fwd_item(w, bh, n_qb, CAUSAL, qb, head);
            const int n_tiles = CAUSAL ? qb + 1 : (T + BC - 1) / BC;
            const int row = qb * BR + cw * 64 + warp * 16 + g;  // and row + 8
            const int b = i & 1;
            const uint64_t dq = h9::desc_sw128(Qs + b * BR * DH + cw * 64 * DH, 16, 1024);
            st.m[0] = st.m[1] = -INFINITY;
            st.l[0] = st.l[1] = 0.f;
#pragma unroll
            for (int r = 0; r < DH / 2; ++r) st.acc[r] = 0.f;
            h9::mbar_wait(&q_full[b], (i / 2) & 1);
            // turns: the first issues S of tile 0, turn kt S of tile kt with
            // P V of tile kt - 1, the last P V of the last tile; only the
            // last S tile may need the mask
            for (int kt = 0; kt < n_tiles; ++kt) {
                const int s = (tile + kt) % STAGES, s_prev = (tile + kt + STAGES - 1) % STAGES;
                const bool masked = kt == n_tiles - 1 && (CAUSAL || (kt + 1) * BC > T);
                const bf::bf16* k_tile = Ks + s * TILE;
                const bf::bf16* v_prev = Vs + s_prev * TILE;
                h9::mbar_wait(&full[s], ((tile + kt) / STAGES) & 1);
                if (kt == 0) {
                    if (masked)
                        fwd_turn<CAUSAL, true, true, false>(st, dq, k_tile, v_prev, nullptr,
                                                            mine, other, scale_log2, 0, row, T, t);
                    else
                        fwd_turn<CAUSAL, false, true, false>(st, dq, k_tile, v_prev, nullptr,
                                                             mine, other, scale_log2, 0, row, T,
                                                             t);
                } else if (masked) {
                    fwd_turn<CAUSAL, true, true, true>(st, dq, k_tile, v_prev, &empty[s_prev],
                                                       mine, other, scale_log2, kt * BC, row, T,
                                                       t);
                } else {
                    fwd_turn<CAUSAL, false, true, true>(st, dq, k_tile, v_prev, &empty[s_prev],
                                                        mine, other, scale_log2, kt * BC, row, T,
                                                        t);
                }
            }
            h9::mbar_arrive_warp(&q_empty[b]);  // every S of the item has landed
            const int s_last = (tile + n_tiles - 1) % STAGES;
            fwd_turn<CAUSAL, false, false, true>(st, dq, nullptr, Vs + s_last * TILE,
                                                 &empty[s_last], mine, other, scale_log2, 0, row,
                                                 T, t);
            tile += n_tiles;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
                st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row + 8 * h;
                if (r < T) {
                    const float inv = 1.f / st.l[h];
                    bf::bf16* out = o + ((size_t)head * T + r) * DH + 2 * t;
#pragma unroll
                    for (int j = 0; j < DH / 8; ++j)
                        *reinterpret_cast<uint32_t*>(out + 8 * j) = h9::pack_bf16(
                            st.acc[4 * j + 2 * h] * inv, st.acc[4 * j + 2 * h + 1] * inv);
                    // m is in base-2 units of the scaled scores
                    if (lse != nullptr && t == 0)
                        lse[(size_t)head * T + r] = (st.m[h] + log2f(st.l[h])) * LN2;
                }
            }
        }
    }
}

template <bool CAUSAL>
cudaError_t launch_bf16_wgmma(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                              bf::bf16* o, float* lse, int bh, int t, cudaStream_t stream) {
    constexpr int DH = wg_fwd::DH, BR = wg_fwd::BR, BC = wg_fwd::BC;
    constexpr int THREADS = wg_fwd::THREADS;
    constexpr size_t SMEM = wg_fwd::SMEM;
    CUtensorMap tq, tk, tv;
    int sms = 0;
    cudaError_t err = h9::encode_heads(&tq, q, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::encode_heads(&tk, k, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::encode_heads(&tv, v, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::sm_count(&sms);
    if (err != cudaSuccess) return err;
    auto kernel = flash_attention_fwd_bf16_wgmma_kernel<CAUSAL>;
    static unsigned long long smem_set = 0;
    err = h9::allow_smem(kernel, SMEM, &smem_set);
    if (err != cudaSuccess) return err;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
    const long long items = (long long)bh * ((t + BR - 1) / BR);
    const int grid = (int)(items < sms ? items : sms);  // persistent: one block per SM
    kernel<<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, o, lse, bh, t, scale_log2);
    return cudaGetLastError();
}

}  // namespace

// The design and tiles that serve the bf16 forward at head width dh:
// design 1 is the wgmma kernel, 0 the mma.sync one; br query rows a block,
// bc keys a tile. Returns a cudaError_t.
extern "C" int dl4j_flash_attention_fwd_bf16_tiles(int dh, int* design, int* br, int* bc) {
    switch (dh) {
        case 64:
            *design = 1, *br = wg_fwd::BR, *bc = wg_fwd::BC;
            return 0;
        case 128:
            *design = 0, *br = bf::Cfg<128>::BR, *bc = bf::Cfg<128>::BC;
            return 0;
        case 256:
            *design = 0, *br = bf::Cfg<256>::BR, *bc = bf::Cfg<256>::BC;
            return 0;
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// q, k, v, o: contiguous [bh, t, dh] bf16 on the device; lse: [bh, t] f32
// or null; t % 64 == 0, dh in {64, 128, 256}, 0 < t / 64 <= 65535.
// Returns a cudaError_t (0 = launched).
extern "C" int dl4j_flash_attention_fwd_bf16(const void* q, const void* k,
                                             const void* v, void* o, void* lse,
                                             int bh, int t, int dh, int causal,
                                             void* stream) {
    if (bh <= 0 || t <= 0 || t % 64 != 0 || t / 64 > 65535)
        return (int)cudaErrorInvalidValue;
    const auto* qb = static_cast<const bf::bf16*>(q);
    const auto* kb = static_cast<const bf::bf16*>(k);
    const auto* vb = static_cast<const bf::bf16*>(v);
    auto* ob = static_cast<bf::bf16*>(o);
    float* lf = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 64:  // the wgmma kernel
            return (int)(causal ? launch_bf16_wgmma<true>(qb, kb, vb, ob, lf, bh, t, s)
                                : launch_bf16_wgmma<false>(qb, kb, vb, ob, lf, bh, t, s));
        case 128: return (int)launch_bf16_dh<128>(qb, kb, vb, ob, lf, bh, t, causal, s);
        case 256: return (int)launch_bf16_dh<256>(qb, kb, vb, ob, lf, bh, t, causal, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
