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
// Design (a simple first kernel; wgmma and TMA are later work): one block
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
        case 64: return (int)launch_bf16_dh<64>(qb, kb, vb, ob, lf, bh, t, causal, s);
        case 128: return (int)launch_bf16_dh<128>(qb, kb, vb, ob, lf, bh, t, causal, s);
        case 256: return (int)launch_bf16_dh<256>(qb, kb, vb, ob, lf, bh, t, causal, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
