// Flash-attention backward for Hopper (sm_90a): f32 on the tensor cores at
// f32 accuracy (3xTF32), described here, and bf16 (the mixed-precision
// path), described at its kernels further down.
//
// Replaces the backward of PallasFlashAttentionHelper.attend
// (deeplearning4j_tpu/nn/pallas_kernels.py:359): the custom VJP of jax's
// bundled TPU kernel (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_bwd -> _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), which has two kernels, as this file has:
//
//   P  = exp(S * scale - LSE),  S = q k^T,  scale = 1 / sqrt(Dh)
//   D  = rowsum(dO o o)                      (per query row)
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - D)
//   dK = dS^T Q * scale,          dQ = dS K * scale
//
// LSE is the forward kernel's [n*h, T] output (flash_attention_fwd.cu), the
// natural-log logsumexp of the SCALED scores; both kernels turn it into the
// base-2 units they exponentiate in (exp2f(S * scale * log2 e - LSE * log2 e)).
//
// What bounds it. At the trained GPT-2-small shape [N=8, H=12, T=1024,
// Dh=64], causal, each [T x T x Dh] product over the causal pairs
// T(T+1)/2 of a head is 6.45 GFLOP: the dq kernel runs 3 (S, dP, dQ),
// 19.35 GFLOP, the dk/dv kernel 4 (S, dP, dV, dK), 25.80 GFLOP. Done as
// 3xTF32 (three TF32 products for one f32-accurate one) at the H100 SXM's
// 495 TFLOP/s dense TF32 that is 0.117 ms and 0.156 ms; bytes (6 [N,H,T,Dh]
// and 2 [N,H,T] tensors, 25.2 MB and 0.4 MB each) take 0.045 ms at
// 3.35 TB/s, so both kernels are bound by operations. On the CUDA cores'
// 67 TFLOP/s f32 the same products would take 0.289 ms and 0.385 ms.
// chip_smoke.py re-derives both bounds for the card it runs on.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W, medians of 25 launches):
// dq 0.455 ms and dk/dv 0.477 ms, 26% and 33% of their 3xTF32 bounds;
// together 0.933 ms against 1.239 ms for the backward of
// F.scaled_dot_product_attention (CUTLASS's fmha_cutlassB_f32 kernel).
// ptxas: 195 and 254 registers (Dh 64, causal), no spills.
//
// Design:
//   * dq kernel, launched FIRST: one block per (n*h, BR query rows). Q and
//     dO of those rows stay resident in shared memory; it computes D for
//     its rows (O is read once, here) and writes D out for the dk/dv
//     kernel, then streams K and V tiles of BC rows up to the diagonal
//     (causal), accumulating dQ in registers.
//   * dk/dv kernel: one block per (n*h, BR key rows). K and V stay resident;
//     it streams Q, dO, LSE and D tiles of BC rows from the diagonal down
//     (causal), accumulating dK and dV in registers. No atomics: every
//     output element has exactly one owner block, so the results are the
//     same bits run to run.
//   * 8 warps; warp w owns 16 resident rows (row group w / WN) and Dh / WN
//     columns of the output (column part w % WN). With WN = 2 (Dh 256) the
//     two warps of a row group both compute that group's S and dP.
//   * Tiles: Dh 64: BR 128, BC 64; Dh 128: BR 128, BC 16; Dh 256: BR 64,
//     BC 8. Shared memory, rows padded to Dh + 4 floats: two resident
//     [BR] tiles and two stages of two [BC] tiles as big and small planes
//     (and LSE, D): 205 KB, 198 KB and 195 KB; one block per SM. A last
//     block whose rows run past T (T = 192 at BR 128) leaves the warps of
//     those rows idle.
//   * Streamed tiles come through a ring of 2 shared-memory stages filled
//     by cp.async.cg (16 bytes a thread): the next tile's copy is in flight
//     while the current one is split and multiplied.
//   * Products: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Every
//     operand x is split into big = cvt.rna.tf32.f32(x) and small =
//     cvt.rna.tf32.f32(x - big) (big is rounded explicitly, so small is
//     taken from exactly the big the tensor core sees); each product is
//     small.big + big.small + big.big accumulated in f32, small terms
//     first, small.small dropped. The rounding is computed on the int32
//     view ((bits + 0x1000) & ~0x1fff: the same result for every finite x
//     in 2 instructions; ptxas expands cvt.rna.tf32.f32 into about 5).
//   * Where the split happens: a streamed tile is split once per block,
//     in place, into a big plane and a small plane, by the threads that
//     copied it, as soon as their copies land; its fragments then cost 4
//     shared-memory loads and no arithmetic. Split at fragment load, each
//     of the 8 warps would split every streamed element again, and those
//     splits take more issue slots than the MMAs they feed. A resident
//     tile is split at fragment load: each A fragment serves the 8-wide
//     blocks of a whole score row, and a second plane of both resident
//     tiles would not fit.
//   * Truncation: the tensor core adds into its accumulator with
//     truncation, so a long chain of MMAs into one accumulator drifts (a dK
//     entry at T = 1024 would take 384). Each streamed tile's share of dQ,
//     dK and dV is summed in the tensor core from zero and added to the
//     running sum by f32 adds, which round to nearest; S and dP (24 MMAs at
//     Dh 64) stay in one chain. Chained throughout, GPT-2's twin-net
//     gradient check (chip_smoke.py) failed: worst gradient 3.9e-5 of its
//     largest entry, against a limit of 1e-5. Flushed after every k-step,
//     the extra live registers spilled.
//   * P and dS go from the accumulators (C fragment: row g, columns 2t and
//     2t+1, g = lane/4, t = lane%4) straight into the next product's A
//     fragment (row g, columns t and t+4) with no shared memory and no
//     shuffle: the contraction index of each 8-wide k-step is permuted,
//     logical column t <- key (query) 2t and t+4 <- 2t+1, and the B
//     fragment reads the same permuted rows (2t and 2t+1) of K, Q or dO.
//   * Row padding of 4 floats puts the 32 loads of every fragment on 32
//     banks: rows g, columns t (S and dP operands: bank 4g + t) and rows
//     2t, 2t+1, columns g (the permuted B fragments: bank 8t + g).
//   * Causal: both loops stop at the diagonal tile; a warp whose rows lie
//     wholly on the masked side of a tile skips its products; masking is
//     applied only in tiles that cross the diagonal; the heaviest blocks
//     are scheduled first.

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
constexpr int STAGES = 2;     // ring of streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
    static constexpr int BR = DH == 256 ? 64 : 128;                // resident rows
    static constexpr int BC = DH == 64 ? 64 : (DH == 128 ? 16 : 8);  // streamed rows
    static constexpr int WN = WARPS / (BR / 16);  // warps sharing a row group
    static constexpr int DW = DH / WN;            // output columns of a warp
    static constexpr int LD = DH + PAD;           // row stride of a tile
    static constexpr int PLANE = BC * LD;         // a streamed tile's big -> small
    static constexpr int NS = BC / 8;             // 8-wide blocks of a score row
    static constexpr int ND = DW / 8;             // 8-wide blocks of an output row
    // one stage: two streamed tensors as big and small planes, two [BC]
    // row vectors (LSE and D, dk/dv kernel only)
    static constexpr int STAGE = 4 * PLANE + 2 * BC;
    // two resident [BR][LD] tiles and STAGES stages
    static constexpr size_t BYTES =
        (size_t)(2 * BR * LD + STAGES * STAGE) * sizeof(float);
    static_assert(WN * (BR / 16) == WARPS, "8 warps cover the resident rows");
    static_assert(64 % BC == 0 && BR % 64 == 0, "tiles divide T % 64 == 0");
    static_assert(BYTES <= 232448, "a block may have 227 KB");
};

// acc[j] (16 resident rows x NS*8 streamed rows) = X Y^T over DH, with X the
// warp's 16 rows of a resident tile (split here) and Y a streamed tile
// (split into planes). xp = X + g*LD + t, yp = Y + g*LD + t.
template <int DH>
__device__ __forceinline__ void scores(float (&acc)[Cfg<DH>::NS][4], const float* xp,
                                       const float* yp) {
    using C = Cfg<DH>;
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks) {
        const float* x = xp + ks * 8;
        const float xa[4] = {x[0], x[8 * C::LD], x[4], x[8 * C::LD + 4]};
        unsigned ab[4], as[4];
        split_n(xa, ab, as);
#pragma unroll
        for (int j = 0; j < C::NS; ++j) {
            const unsigned* y = reinterpret_cast<const unsigned*>(yp) + j * 8 * C::LD + ks * 8;
            const unsigned bb[2] = {y[0], y[4]};
            const unsigned bs[2] = {y[C::PLANE], y[C::PLANE + 4]};
            mma_3xtf32(acc[j], ab, as, bb, bs);
        }
    }
}

// rows g, g+8 of a warp's 16 output rows (C fragments) <- acc * mul
template <int DH>
__device__ __forceinline__ void store_frags(float* __restrict__ out,
                                            const float (&acc)[Cfg<DH>::ND][4],
                                            float mul, int g, int t) {
    using C = Cfg<DH>;
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(out + (size_t)(g + 8 * h) * DH + n * 8 + 2 * t) =
                make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ o,
                              const float* __restrict__ lse,
                              const float* __restrict__ dout,
                              float* __restrict__ dq,
                              float* __restrict__ dvec,
                              int T, float scale, float scale_log2) {
    using C = Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* dOs = Qs + BR * LD;
    float* KVs = dOs + BR * LD;  // STAGES x (K big, K small, V big, V small)

    const int n_blocks = (T + BR - 1) / BR;
    // causal: the last query blocks do the most work; start them first
    const int qb = CAUSAL ? (n_blocks - 1 - (int)blockIdx.y) : (int)blockIdx.y;
    const int q0 = qb * BR;
    const int rows = min(BR, T - q0);
    const size_t head = (size_t)blockIdx.x * T * DH;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp / C::WN) * 16;      // the warp's rows in the block
    const int col0 = (warp % C::WN) * C::DW;  // and its output columns
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
    stage_rows<DH, C::LD>(dOs, dout + head + (size_t)q0 * DH, rows);
    stage(0);
    cp_async_commit();

    // LSE (base 2) of rows g and g+8
    float lse2[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
    if (active) {
        lse2[0] = lse[(size_t)blockIdx.x * T + qw + g] * LOG2E;
        lse2[1] = lse[(size_t)blockIdx.x * T + qw + g + 8] * LOG2E;
    }
    cp_async_wait_all();  // Q, dO and the first K, V tile
    split_stage(0);
    __syncthreads();

    // D = rowsum(dO o O) of the warp's 16 rows, reduced over the warp
    if (active) {
        for (int r = 0; r < 16; ++r) {
            const float* orow = o + head + (size_t)(qw + r) * DH;
            const float* grow = dOs + (r0 + r) * LD;
            float sum = 0.f;
#pragma unroll
            for (int d = lane; d < DH; d += 32) sum = fmaf(orow[d], grow[d], sum);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (r == g) drow[0] = sum;
            if (r == g + 8) drow[1] = sum;
            if (lane == 0 && col0 == 0) dvec[(size_t)blockIdx.x * T + qw + r] = sum;
        }
    }

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    const float* qp = Qs + (r0 + g) * LD + t;
    const float* dop = dOs + (r0 + g) * LD + t;
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
            float s[NS][4], dp[NS][4];
            scores<DH>(s, qp, Ks + g * LD + t);
            scores<DH>(dp, dop, Vs + g * LD + t);
            const bool mask = CAUSAL && k0 + BC - 1 > qw;
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int key = k0 + j * 8 + 2 * t + (e & 1);
                    const float p = (mask && key > qw + g + 8 * h)
                        ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lse2[h]));
                    s[j][e] = p * (dp[j][e] - drow[h]);  // dS
                }
            accumulate<NS, ND, LD, C::PLANE>(acc, s, Ks + 2 * t * LD + col0 + g);  // dQ += dS K
        }
        if (kt + 1 < n_tiles) {  // split this thread's part of the next tile
            cp_async_wait_all();
            split_stage(kt + 1);
        }
    }
    if (active) store_frags<DH>(dq + head + (size_t)qw * DH + col0, acc, scale, g, t);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ lse,
                               const float* __restrict__ dout,
                               const float* __restrict__ dvec,
                               float* __restrict__ dk,
                               float* __restrict__ dv,
                               int T, float scale, float scale_log2) {
    using C = Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);
    float* Vs = Ks + BR * LD;
    float* QDs = Vs + BR * LD;  // STAGES x (Q big, Q small, dO big, dO small, LSE, D)

    // causal: the first key blocks see the most query tiles; start them first
    const int kb = (int)blockIdx.y;
    const int k0 = kb * BR;
    const int rows = min(BR, T - k0);
    const size_t head = (size_t)blockIdx.x * T * DH;
    const size_t vec = (size_t)blockIdx.x * T;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp / C::WN) * 16;
    const int col0 = (warp % C::WN) * C::DW;
    const bool active = r0 < rows;
    const int kw = k0 + r0;  // the warp's first key row

    const int qt0 = CAUSAL ? k0 / BC : 0;
    const int qt_end = T / BC;
    auto stage = [&](int qt) {
        float* dst = QDs + ((qt - qt0) % STAGES) * C::STAGE;
        stage_rows<DH, C::LD>(dst, q + head + (size_t)qt * BC * DH, BC);
        stage_rows<DH, C::LD>(dst + 2 * C::PLANE, dout + head + (size_t)qt * BC * DH, BC);
        stage_vec(dst + 4 * C::PLANE, lse + vec + (size_t)qt * BC, BC);
        stage_vec(dst + 4 * C::PLANE + BC, dvec + vec + (size_t)qt * BC, BC);
    };
    auto split_stage = [&](int qt) {
        float* dst = QDs + ((qt - qt0) % STAGES) * C::STAGE;
        split_rows<DH, C::LD>(dst, C::BC, C::PLANE);
        split_rows<DH, C::LD>(dst + 2 * C::PLANE, C::BC, C::PLANE);
    };
    stage_rows<DH, C::LD>(Ks, k + head + (size_t)k0 * DH, rows);
    stage_rows<DH, C::LD>(Vs, v + head + (size_t)k0 * DH, rows);
    stage(qt0);
    cp_async_commit();
    cp_async_wait_all();  // K, V and the first Q, dO tile
    split_stage(qt0);

    float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    const float* kp = Ks + (r0 + g) * LD + t;
    const float* vp = Vs + (r0 + g) * LD + t;
    for (int qt = qt0; qt < qt_end; ++qt) {
        // tile qt is split (by every thread) and tile qt - 1 is consumed (by
        // every warp), so its stage may take tile qt + 1
        __syncthreads();
        if (qt + 1 < qt_end) stage(qt + 1);
        cp_async_commit();
        const float* Qs = QDs + ((qt - qt0) % STAGES) * C::STAGE;
        const float* dOs = Qs + 2 * C::PLANE;
        const int q0 = qt * BC;
        // causal: skip a tile whose queries all lie before the warp's keys
        if (active && !(CAUSAL && q0 + BC - 1 < kw)) {
            const float* Ls = dOs + 2 * C::PLANE;
            const float* Ds = Ls + BC;
            float s[NS][4], dp[NS][4];  // S^T, dP^T: keys x queries
            scores<DH>(s, kp, Qs + g * LD + t);
            scores<DH>(dp, vp, dOs + g * LD + t);
            const bool mask = CAUSAL && q0 < kw + 15;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int c = j * 8 + 2 * t;
                const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
                const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = kw + g + 8 * (e >> 1);
                    const float lq = (e & 1) ? l2.y : l2.x;
                    const float dq_ = (e & 1) ? d2.y : d2.x;
                    const float p = (mask && key > q0 + c + (e & 1))
                        ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lq * LOG2E));
                    s[j][e] = p;                     // P^T
                    dp[j][e] = p * (dp[j][e] - dq_);  // dS^T
                }
            }
            accumulate<NS, ND, LD, C::PLANE>(dv_acc, s, dOs + 2 * t * LD + col0 + g);  // dV += P^T dO
            accumulate<NS, ND, LD, C::PLANE>(dk_acc, dp, Qs + 2 * t * LD + col0 + g);  // dK += dS^T Q
        }
        if (qt + 1 < qt_end) {  // split this thread's part of the next tile
            cp_async_wait_all();
            split_stage(qt + 1);
        }
    }
    if (active) {
        store_frags<DH>(dk + head + (size_t)kw * DH + col0, dk_acc, scale, g, t);
        store_frags<DH>(dv + head + (size_t)kw * DH + col0, dv_acc, 1.f, g, t);
    }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

template <int DH, bool CAUSAL>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* o,
                      const float* lse, const float* dout, float* dq, float* dvec,
                      int bh, int t, cudaStream_t stream) {
    auto kernel = flash_attention_bwd_dq_kernel<DH, CAUSAL>;
    const size_t smem = Cfg<DH>::BYTES;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const dim3 grid(bh, (t + Cfg<DH>::BR - 1) / Cfg<DH>::BR);
    kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, dout, dq, dvec, t,
                                            scale, scale * LOG2E);
    return cudaGetLastError();
}

template <int DH, bool CAUSAL>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* lse, const float* dout, const float* dvec,
                       float* dk, float* dv, int bh, int t, cudaStream_t stream) {
    auto kernel = flash_attention_bwd_dkv_kernel<DH, CAUSAL>;
    const size_t smem = Cfg<DH>::BYTES;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const dim3 grid(bh, (t + Cfg<DH>::BR - 1) / Cfg<DH>::BR);
    kernel<<<grid, THREADS, smem, stream>>>(q, k, v, lse, dout, dvec, dk, dv, t,
                                            scale, scale * LOG2E);
    return cudaGetLastError();
}

bool bad_shape(int bh, int t) {
    return bh <= 0 || t <= 0 || t % 64 != 0 || t / 64 > 65535;
}

}  // namespace

// q, k, v, o, dout, dq: contiguous [bh, t, dh] f32 on the device; lse, dvec:
// [bh, t] f32. Writes dq and D = rowsum(dout * o) into dvec. t % 64 == 0,
// dh in {64, 128, 256}. Returns a cudaError_t (0 = launched).
extern "C" int dl4j_flash_attention_bwd_dq_f32(const void* q, const void* k,
                                               const void* v, const void* o,
                                               const void* lse, const void* dout,
                                               void* dq, void* dvec, int bh,
                                               int t, int dh, int causal,
                                               void* stream) {
    if (bad_shape(bh, t)) return (int)cudaErrorInvalidValue;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
                *lf = static_cast<const float*>(lse), *gf = static_cast<const float*>(dout);
    float* dqf = static_cast<float*>(dq);
    float* df = static_cast<float*>(dvec);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DQ(DH)                                                              \
    return (int)(causal ? launch_dq<DH, true>(qf, kf, vf, of, lf, gf, dqf, df, bh, t, s) \
                        : launch_dq<DH, false>(qf, kf, vf, of, lf, gf, dqf, df, bh, t, s))
    switch (dh) {
        case 64: DL4J_DQ(64);
        case 128: DL4J_DQ(128);
        case 256: DL4J_DQ(256);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DL4J_DQ
}

// q, k, v, dout, dk, dv: contiguous [bh, t, dh] f32 on the device; lse,
// dvec: [bh, t] f32 (dvec as the dq kernel wrote it). Writes dk and dv.
// Returns a cudaError_t (0 = launched).
extern "C" int dl4j_flash_attention_bwd_dkv_f32(const void* q, const void* k,
                                                const void* v, const void* lse,
                                                const void* dout, const void* dvec,
                                                void* dk, void* dv, int bh,
                                                int t, int dh, int causal,
                                                void* stream) {
    if (bad_shape(bh, t)) return (int)cudaErrorInvalidValue;
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *lf = static_cast<const float*>(lse),
                *gf = static_cast<const float*>(dout), *df = static_cast<const float*>(dvec);
    float* dkf = static_cast<float*>(dk);
    float* dvf = static_cast<float*>(dv);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DKV(DH)                                                              \
    return (int)(causal ? launch_dkv<DH, true>(qf, kf, vf, lf, gf, df, dkf, dvf, bh, t, s) \
                        : launch_dkv<DH, false>(qf, kf, vf, lf, gf, df, dkf, dvf, bh, t, s))
    switch (dh) {
        case 64: DL4J_DKV(64);
        case 128: DL4J_DKV(128);
        case 256: DL4J_DKV(256);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DL4J_DKV
}

// ======================================================================
// Flash-attention backward, bf16 (the mixed-precision path).
//
// Replaces the TPU kernels' bf16 path: every product takes bf16 operands
// with f32 accumulation (flash_attention.py :845, :900, :918, :1188,
// :1258); P = exp(S * scale - LSE) and dS = P o (dP - D) * scale are f32
// and rounded to bf16 only as operands of dV = P^T dO, dK = dS^T Q and
// dQ = dS K; D = rowsum(f32(dO) o f32(O)) and the LSE are f32; dQ, dK and
// dV are accumulated in f32 and written in bf16 (:1095-1098, :1436).
//
// What bounds it. At GPT-2-small's [8, 12, 1024, 64], causal, the dq kernel
// runs 3 products over the causal pairs (S, dP, dQ), 19.35 GFLOP, and the
// dk/dv kernel 4 (S, dP, dV, dK), 25.80 GFLOP: 0.020 and 0.026 ms at
// 989 TFLOP/s dense bf16; their bytes (5 and 6 bf16 [N,H,T,Dh] tensors of
// 12.6 MB, 2 f32 [N,H,T] of 0.4 MB) take about 0.019 and 0.023 ms.
//
// Design (the first bf16 kernels, at Dh 128 and 256; Dh 64 takes the wgmma
// dk/dv and dq kernels below): the f32 kernels' split (the
// dq kernel first, writing D; then the dk/dv kernel; every output element
// has one owner block, no atomics) on bf16_mma.cuh's geometry: blocks of
// 64 resident rows in 4 row groups of 16 (two warps a group at Dh 256),
// streamed tiles of BC rows through a 2-stage cp.async ring, bf16 mma.sync
// m16n8k16, P and dS rounded into the next product's A fragment in
// registers.

namespace {

namespace bf = dl4j_bf16;

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(bf::Cfg<DH>::THREADS)
flash_attention_bwd_dq_bf16_kernel(const bf::bf16* __restrict__ q,
                                   const bf::bf16* __restrict__ k,
                                   const bf::bf16* __restrict__ v,
                                   const bf::bf16* __restrict__ o,
                                   const float* __restrict__ lse,
                                   const bf::bf16* __restrict__ dout,
                                   bf::bf16* __restrict__ dq,
                                   float* __restrict__ dvec,
                                   int T, float scale, float scale_log2) {
    using C = bf::Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    extern __shared__ float4 smem4[];
    bf::bf16* Qs = reinterpret_cast<bf::bf16*>(smem4);
    bf::bf16* dOs = Qs + C::RES;
    bf::bf16* KVs = dOs + C::RES;  // 2 stages x (K, V)

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
    bf::stage_rows<DH, C::THREADS>(dOs, dout + head + (size_t)q0 * DH, BR);
    stage(0);
    bf::cp_async_commit();

    // LSE (base 2) of rows g and g+8
    const float lse2[2] = {lse[(size_t)blockIdx.x * T + qw + g] * LOG2E,
                           lse[(size_t)blockIdx.x * T + qw + g + 8] * LOG2E};
    bf::cp_async_wait<0>();  // Q, dO and the first K, V tile
    __syncthreads();

    // D = rowsum(f32(dO) o f32(O)) of the warp's 16 rows, reduced over the warp
    float drow[2] = {0.f, 0.f};
    for (int r = 0; r < 16; ++r) {
        const bf::bf16* orow = o + head + (size_t)(qw + r) * DH;
        const bf::bf16* grow = dOs + (r0 + r) * LD;
        float sum = 0.f;
#pragma unroll
        for (int d = lane; d < DH; d += 32)
            sum = fmaf(__bfloat162float(orow[d]), __bfloat162float(grow[d]), sum);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (r == g) drow[0] = sum;
        if (r == g + 8) drow[1] = sum;
        if (lane == 0 && col0 == 0) dvec[(size_t)blockIdx.x * T + qw + r] = sum;
    }

    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    const bf::bf16* qp = Qs + (r0 + g) * LD + 2 * t;
    const bf::bf16* dop = dOs + (r0 + g) * LD + 2 * t;
    for (int kt = 0; kt < n_tiles; ++kt) {
        if (kt + 1 < n_tiles) stage(kt + 1);
        bf::cp_async_commit();
        bf::cp_async_wait<1>();
        __syncthreads();
        const bf::bf16* Ks = KVs + (kt & 1) * 2 * C::TILE;
        const bf::bf16* Vs = Ks + C::TILE;
        const int k0 = kt * BC;
        if (!(CAUSAL && k0 > qw + 15)) {
            float s[NS][4], dp[NS][4];
            bf::scores<DH, NS>(s, qp, Ks + g * LD + 2 * t);
            bf::scores<DH, NS>(dp, dop, Vs + g * LD + 2 * t);
            const bool mask = CAUSAL && k0 + BC - 1 > qw;
#pragma unroll
            for (int j = 0; j < NS; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e >> 1;
                    const int key = k0 + j * 8 + 2 * t + (e & 1);
                    const float p = (mask && key > qw + g + 8 * h)
                        ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lse2[h]));
                    s[j][e] = p * (dp[j][e] - drow[h]) * scale;  // dS
                }
            bf::accumulate<DH, NS, ND>(acc, s, Ks + col0);  // dQ += bf16(dS) K
        }
        __syncthreads();
    }
    const float one[2] = {1.f, 1.f};
    bf::store_frags<DH, ND>(dq + head + (size_t)qw * DH + col0, acc, one, g, t);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(bf::Cfg<DH>::THREADS)
flash_attention_bwd_dkv_bf16_kernel(const bf::bf16* __restrict__ q,
                                    const bf::bf16* __restrict__ k,
                                    const bf::bf16* __restrict__ v,
                                    const float* __restrict__ lse,
                                    const bf::bf16* __restrict__ dout,
                                    const float* __restrict__ dvec,
                                    bf::bf16* __restrict__ dk,
                                    bf::bf16* __restrict__ dv,
                                    int T, float scale, float scale_log2) {
    using C = bf::Cfg<DH>;
    constexpr int BR = C::BR, BC = C::BC, LD = C::LD, NS = C::NS, ND = C::ND;
    // one stage: Q and dO tiles, then the LSE and D of their rows (f32)
    constexpr int STAGE_BYTES = 2 * C::TILE * (int)sizeof(bf::bf16) + 2 * BC * (int)sizeof(float);
    extern __shared__ float4 smem4[];
    bf::bf16* Ks = reinterpret_cast<bf::bf16*>(smem4);
    bf::bf16* Vs = Ks + C::RES;
    char* stages = reinterpret_cast<char*>(Vs + C::RES);

    const int k0 = (int)blockIdx.y * BR;
    const size_t head = (size_t)blockIdx.x * T * DH;
    const size_t vec = (size_t)blockIdx.x * T;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = (warp / C::WN) * 16;
    const int col0 = (warp % C::WN) * C::DW;
    const int kw = k0 + r0;  // the warp's first key row

    // causal: the first key blocks see the most query tiles, and start first
    const int qt0 = CAUSAL ? k0 / BC : 0;
    const int qt_end = T / BC;
    auto stage_at = [&](int qt) {
        return stages + ((qt - qt0) & 1) * STAGE_BYTES;
    };
    auto stage = [&](int qt) {
        char* dst = stage_at(qt);
        bf::bf16* qd = reinterpret_cast<bf::bf16*>(dst);
        float* vd = reinterpret_cast<float*>(qd + 2 * C::TILE);
        bf::stage_rows<DH, C::THREADS>(qd, q + head + (size_t)qt * BC * DH, BC);
        bf::stage_rows<DH, C::THREADS>(qd + C::TILE, dout + head + (size_t)qt * BC * DH, BC);
        bf::stage_vec<C::THREADS>(vd, lse + vec + (size_t)qt * BC, BC);
        bf::stage_vec<C::THREADS>(vd + BC, dvec + vec + (size_t)qt * BC, BC);
    };
    bf::stage_rows<DH, C::THREADS>(Ks, k + head + (size_t)k0 * DH, BR);
    bf::stage_rows<DH, C::THREADS>(Vs, v + head + (size_t)k0 * DH, BR);
    stage(qt0);
    bf::cp_async_commit();

    float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    const bf::bf16* kp = Ks + (r0 + g) * LD + 2 * t;
    const bf::bf16* vp = Vs + (r0 + g) * LD + 2 * t;
    for (int qt = qt0; qt < qt_end; ++qt) {
        if (qt + 1 < qt_end) stage(qt + 1);
        bf::cp_async_commit();
        bf::cp_async_wait<1>();  // tile qt (and K, V) landed
        __syncthreads();
        const bf::bf16* Qt = reinterpret_cast<const bf::bf16*>(stage_at(qt));
        const bf::bf16* dOt = Qt + C::TILE;
        const float* Ls = reinterpret_cast<const float*>(dOt + C::TILE);
        const float* Ds = Ls + BC;
        const int q0 = qt * BC;
        // causal: skip a tile whose queries all lie before the warp's keys
        if (!(CAUSAL && q0 + BC - 1 < kw)) {
            float s[NS][4], dp[NS][4];  // S^T, dP^T: keys x queries
            bf::scores<DH, NS>(s, kp, Qt + g * LD + 2 * t);
            bf::scores<DH, NS>(dp, vp, dOt + g * LD + 2 * t);
            const bool mask = CAUSAL && q0 < kw + 15;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int c = j * 8 + 2 * t;
                const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
                const float2 d2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = kw + g + 8 * (e >> 1);
                    const float lq = (e & 1) ? l2.y : l2.x;
                    const float dq_ = (e & 1) ? d2.y : d2.x;
                    const float p = (mask && key > q0 + c + (e & 1))
                        ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lq * LOG2E));
                    s[j][e] = p;                             // P^T
                    dp[j][e] = p * (dp[j][e] - dq_) * scale;  // dS^T
                }
            }
            bf::accumulate<DH, NS, ND>(dv_acc, s, dOt + col0);  // dV += bf16(P^T) dO
            bf::accumulate<DH, NS, ND>(dk_acc, dp, Qt + col0);  // dK += bf16(dS^T) Q
        }
        __syncthreads();
    }
    const float one[2] = {1.f, 1.f};
    bf::store_frags<DH, ND>(dk + head + (size_t)kw * DH + col0, dk_acc, one, g, t);
    bf::store_frags<DH, ND>(dv + head + (size_t)kw * DH + col0, dv_acc, one, g, t);
}

template <int DH, bool CAUSAL>
cudaError_t launch_dq_bf16(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                           const bf::bf16* o, const float* lse, const bf::bf16* dout,
                           bf::bf16* dq, float* dvec, int bh, int t, cudaStream_t stream) {
    using C = bf::Cfg<DH>;
    auto kernel = flash_attention_bwd_dq_bf16_kernel<DH, CAUSAL>;
    const size_t smem = (size_t)(2 * C::RES + 4 * C::TILE) * sizeof(bf::bf16);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const dim3 grid(bh, t / C::BR);
    kernel<<<grid, C::THREADS, smem, stream>>>(q, k, v, o, lse, dout, dq, dvec, t,
                                               scale, scale * LOG2E);
    return cudaGetLastError();
}

template <int DH, bool CAUSAL>
cudaError_t launch_dkv_bf16(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                            const float* lse, const bf::bf16* dout, const float* dvec,
                            bf::bf16* dk, bf::bf16* dv, int bh, int t, cudaStream_t stream) {
    using C = bf::Cfg<DH>;
    auto kernel = flash_attention_bwd_dkv_bf16_kernel<DH, CAUSAL>;
    const size_t smem = (size_t)2 * C::RES * sizeof(bf::bf16)
        + 2 * (2 * C::TILE * sizeof(bf::bf16) + 2 * C::BC * sizeof(float));
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const dim3 grid(bh, t / C::BR);
    kernel<<<grid, C::THREADS, smem, stream>>>(q, k, v, lse, dout, dvec, dk, dv, t,
                                               scale, scale * LOG2E);
    return cudaGetLastError();
}

}  // namespace

// ======================================================================
// Flash-attention backward dk/dv, bf16, redesigned for Hopper: the kernel
// that serves the bf16 dk/dv at Dh 64 (GPT-2-small's [8, 12, 1024, 64]);
// Dh 128 and 256 keep the mma.sync kernel above; the dq kernel after this
// one is its transpose. It
// computes what that kernel computes, at the same rounding points: S^T
// and dP^T of bf16 operands in f32; P^T = exp2(S^T scale log2e - LSE
// log2e) and dS^T = P^T o (dP^T - D) scale in f32, each rounded to bf16
// only as the operand of dV += P^T dO and dK += dS^T Q; dK and dV summed
// in f32 and written in bf16. D comes from the dq kernel, which runs
// first; every output element has one owner block, no atomics, so the
// results are the same bits from run to run.
//
// What bounds it. At [8, 12, 1024, 64], causal, the four products are
// 25.8 GFLOP, 0.026 ms at 989 TFLOP/s dense bf16; the bytes (6 bf16
// [N, H, T, Dh] tensors and 2 f32 rows, read or written once) take 0.023
// ms: operations.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W): 0.0859 ms of device time
// a launch, against 0.1340 for the mma.sync kernel; ptxas: 168 registers
// at launch, no spills.
//
// Design (hopper_sm90.cuh holds the pieces; the forward's wgmma kernel
// describes the pattern):
//   * Persistent: one block of 3 warpgroups on each SM walks work items
//     (n*h, BR = 128 key rows); causal: the key blocks that see the most
//     query tiles (the first) come first, dealt in a snake. The producer
//     warpgroup (24 registers) loads an item's K and V into one of 2
//     buffers, then streams Q and dO tiles of BC = 64 query rows (TMA) with
//     their LSE and D rows (1-D bulk copies) through a ring of 5 stages.
//     Two consumer warpgroups (240 registers) own 64 key rows each.
//   * S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16 x 4 each, both
//     operands from shared memory, K-major; P^T is computed while dP^T
//     still runs. dV share = bf16(P^T) dO (wgmma m64n64k16 x 4, P^T from
//     registers, dO MN-major) runs while dS^T is computed; then dK share =
//     bf16(dS^T) Q the same way. Each share is summed from zero and added
//     to dV or dK in f32 (the tensor core truncates when it adds into its
//     accumulator).
//   * Causal: an item starts at its diagonal query tile; a consumer whose
//     keys all lie after a tile's queries skips its products but still
//     releases the stage; only the tile on its diagonal is masked. A last
//     block of 64 keys (T % 128 == 64): the second consumer's keys lie
//     past T, it skips every tile; rows past T load as zeros and are never
//     stored.

namespace {

namespace h9 = dl4j_sm90;

namespace wg_dkv {
constexpr int DH = 64, BR = 128, BC = 64, STAGES = 5, THREADS = 384;
constexpr int RES = BR * DH;   // bf16 of a resident K or V block
constexpr int TILE = BC * DH;  // bf16 of a streamed Q or dO tile
constexpr uint32_t RES_BYTES = RES * sizeof(bf::bf16), TILE_BYTES = TILE * sizeof(bf::bf16),
                   ROW_BYTES = BC * sizeof(float);
// 1 KB to align the tiles, 2 buffers of K and V, the Q and dO stages, the
// LSE and D stages, the barriers
constexpr size_t SMEM = 1024 + 4 * RES_BYTES + STAGES * (2 * TILE_BYTES + 2 * ROW_BYTES) +
                        8 * (4 + 2 * STAGES);
}  // namespace wg_dkv

// a consumer's registers over one work item
struct DkvState {
    float a[wg_dkv::BC / 2], b[wg_dkv::BC / 2];  // S^T then P^T; dP^T, dS^T, the dK share
    float sv[wg_dkv::DH / 2];                   // the dV share
    float dk[wg_dkv::DH / 2], dv[wg_dkv::DH / 2];
    uint32_t pa[wg_dkv::BC / 4], da[wg_dkv::BC / 4];  // bf16(P^T), bf16(dS^T): A registers
};

// One query tile of a consumer (masked: the tile on its diagonal): S^T and
// dP^T, P^T, the dV share, dS^T, the dK share, all waited for here; dK and
// dV += their shares in f32. key: the thread's first key row; Lq, Dq: the
// tile's LSE and D rows in shared memory.
__device__ __forceinline__ void dkv_tile(DkvState& st, uint64_t dk_desc, uint64_t dv_desc,
                                         const bf::bf16* Qs, const bf::bf16* dOs,
                                         const float* Lq, const float* Dq, int q0, int key,
                                         bool masked, float scale, float scale_log2, int t) {
    const uint64_t dq_desc = h9::desc_sw128(Qs, 16, 1024);
    const uint64_t ddo_desc = h9::desc_sw128(dOs, 16, 1024);
    h9::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < wg_dkv::DH / 16; ++ks)
        h9::wgmma_ss_n64<0>(st.a, h9::desc_at(dk_desc, ks * 32), h9::desc_at(dq_desc, ks * 32),
                            ks);
    h9::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < wg_dkv::DH / 16; ++ks)
        h9::wgmma_ss_n64<0>(st.b, h9::desc_at(dv_desc, ks * 32),
                            h9::desc_at(ddo_desc, ks * 32), ks);
    h9::wgmma_commit();
    h9::wgmma_wait<1>();  // S^T landed; dP^T may still run
    h9::fence_regs(st.a);
#pragma unroll
    for (int j = 0; j < wg_dkv::BC / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(Lq + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int query = q0 + 8 * j + 2 * t + (e & 1);
            const float lq = (e & 1) ? l2.y : l2.x;
            st.a[4 * j + e] = (masked && key + 8 * (e >> 1) > query)
                ? 0.f
                : h9::exp2_ftz(fmaf(st.a[4 * j + e], scale_log2, -lq * LOG2E));  // P^T
        }
    }
    // dV share = bf16(P^T) dO (dO MN-major) runs while dS^T is computed
    h9::pack_a<wg_dkv::BC / 2>(st.pa, st.a);  // rounded to bf16 only here, as the TPU kernel
    h9::wgmma_fence();
    const uint64_t ddo_mn = h9::desc_sw128(dOs, wg_dkv::TILE_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < wg_dkv::BC / 16; ++kk)
        h9::wgmma_rs_n64<1>(st.sv, st.pa[4 * kk], st.pa[4 * kk + 1], st.pa[4 * kk + 2],
                            st.pa[4 * kk + 3], h9::desc_at(ddo_mn, kk * 2048), kk);
    h9::wgmma_commit();
    h9::wgmma_wait<1>();  // dP^T landed; the dV share may still run
    h9::fence_regs(st.b);
#pragma unroll
    for (int j = 0; j < wg_dkv::BC / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(Dq + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            st.b[4 * j + e] =
                st.a[4 * j + e] * (st.b[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * scale;  // dS^T
    }
    h9::pack_a<wg_dkv::BC / 2>(st.da, st.b);
    // dK share = bf16(dS^T) Q (Q MN-major), into dP^T's registers
    h9::wgmma_fence();
    const uint64_t dq_mn = h9::desc_sw128(Qs, wg_dkv::TILE_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < wg_dkv::BC / 16; ++kk)
        h9::wgmma_rs_n64<1>(st.b, st.da[4 * kk], st.da[4 * kk + 1], st.da[4 * kk + 2],
                            st.da[4 * kk + 3], h9::desc_at(dq_mn, kk * 2048), kk);
    h9::wgmma_commit();
    h9::wgmma_wait<0>();
    h9::fence_regs(st.sv);
    h9::fence_regs(st.b);
    h9::fence_regs(st.pa);
    h9::fence_regs(st.da);
#pragma unroll
    for (int r = 0; r < wg_dkv::DH / 2; ++r) {
        st.dv[r] += st.sv[r];
        st.dk[r] += st.b[r];
    }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(wg_dkv::THREADS, 1)
flash_attention_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                          const __grid_constant__ CUtensorMap tm_k,
                                          const __grid_constant__ CUtensorMap tm_v,
                                          const __grid_constant__ CUtensorMap tm_do,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ dvec,
                                          bf::bf16* __restrict__ dk,
                                          bf::bf16* __restrict__ dv, int bh, int T,
                                          float scale, float scale_log2) {
    constexpr int DH = wg_dkv::DH, BR = wg_dkv::BR, BC = wg_dkv::BC;
    constexpr int STAGES = wg_dkv::STAGES, RES = wg_dkv::RES, TILE = wg_dkv::TILE;
    constexpr uint32_t RES_BYTES = wg_dkv::RES_BYTES, TILE_BYTES = wg_dkv::TILE_BYTES,
                       ROW_BYTES = wg_dkv::ROW_BYTES;
    extern __shared__ unsigned char smem_raw[];
    bf::bf16* Ks = reinterpret_cast<bf::bf16*>(h9::align1024(smem_raw));  // 2 buffers
    bf::bf16* Vs = Ks + 2 * RES;                                          // 2 buffers
    bf::bf16* Qt = Vs + 2 * RES;         // STAGES tiles
    bf::bf16* dOt = Qt + STAGES * TILE;  // STAGES tiles
    float* Ls = reinterpret_cast<float*>(dOt + STAGES * TILE);  // STAGES x BC
    float* Ds = Ls + STAGES * BC;                                // STAGES x BC
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + STAGES * BC);
    uint64_t* kv_empty = kv_full + 2;
    uint64_t* full = kv_empty + 2;
    uint64_t* empty = full + STAGES;

    const int n_kb = (T + BR - 1) / BR, n_items = bh * n_kb;

    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            h9::mbar_init(&kv_full[b], 1);
            h9::mbar_init(&kv_empty[b], 2 * 4);  // every consumer warp
        }
        for (int s = 0; s < STAGES; ++s) {
            h9::mbar_init(&full[s], 1);
            h9::mbar_init(&empty[s], 2 * 4);
        }
        h9::mbar_fence_init();
    }
    __syncthreads();

    // work item w: key block w / bh (causal: the first key blocks see the
    // most query tiles, and come first) of head w % bh
    if (threadIdx.x < 128) {  // the producer warpgroup
        h9::regs_shrink<24>();
        if (threadIdx.x == 0) {
            int tile = 0;  // the ring's count of tiles, over every item
            for (int i = 0;; ++i) {
                const int w = h9::snake_item(i);
                if (w >= n_items) break;
                const int head = w % bh, k0 = (w / bh) * BR;
                const int qt0 = CAUSAL ? k0 / BC : 0;  // the diagonal tile
                const size_t rows = (size_t)head * T;
                const int b = i & 1;
                if (i >= 2) h9::mbar_wait(&kv_empty[b], (i / 2 - 1) & 1);
                h9::mbar_expect_tx(&kv_full[b], 2 * RES_BYTES);
                h9::tma_load_3d(Ks + b * RES, &tm_k, &kv_full[b], 0, k0, head);
                h9::tma_load_3d(Vs + b * RES, &tm_v, &kv_full[b], 0, k0, head);
                for (int qt = qt0; qt < T / BC; ++qt, ++tile) {
                    const int s = tile % STAGES, q0 = qt * BC;
                    if (tile >= STAGES) h9::mbar_wait(&empty[s], (tile / STAGES - 1) & 1);
                    h9::mbar_expect_tx(&full[s], 2 * TILE_BYTES + 2 * ROW_BYTES);
                    h9::tma_load_3d(Qt + s * TILE, &tm_q, &full[s], 0, q0, head);
                    h9::tma_load_3d(dOt + s * TILE, &tm_do, &full[s], 0, q0, head);
                    h9::bulk_load(Ls + s * BC, lse + rows + q0, ROW_BYTES, &full[s]);
                    h9::bulk_load(Ds + s * BC, dvec + rows + q0, ROW_BYTES, &full[s]);
                }
            }
        }
    } else {  // the consumer warpgroups
        h9::regs_grow<240>();
        const int cw = threadIdx.x / 128 - 1;
        const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int g = lane >> 2, t = lane & 3;

        DkvState st;
        int tile = 0;
        for (int i = 0;; ++i) {
            const int w = h9::snake_item(i);
            if (w >= n_items) break;
            const int head = w % bh, k0 = (w / bh) * BR;
            const int qt0 = CAUSAL ? k0 / BC : 0;
            const size_t rows = (size_t)head * T;
            const int kw = k0 + cw * 64;          // the consumer's first key
            const int key = kw + warp * 16 + g;  // and key + 8
            const int kvb = i & 1;
            const uint64_t dk_desc = h9::desc_sw128(Ks + kvb * RES + cw * 64 * DH, 16, 1024);
            const uint64_t dv_desc = h9::desc_sw128(Vs + kvb * RES + cw * 64 * DH, 16, 1024);
#pragma unroll
            for (int r = 0; r < DH / 2; ++r) st.dk[r] = st.dv[r] = 0.f;
            h9::mbar_wait(&kv_full[kvb], (i / 2) & 1);
            for (int qt = qt0; qt < T / BC; ++qt, ++tile) {
                const int s = tile % STAGES, q0 = qt * BC;
                h9::mbar_wait(&full[s], (tile / STAGES) & 1);
                // skip a tile whose queries all lie before the consumer's keys
                if (!(kw >= T || (CAUSAL && q0 + BC - 1 < kw))) {
                    const bf::bf16* Qs = Qt + s * TILE;
                    const bf::bf16* dOs = dOt + s * TILE;
                    dkv_tile(st, dk_desc, dv_desc, Qs, dOs, Ls + s * BC, Ds + s * BC, q0, key,
                             CAUSAL && q0 < kw + 64,  // the tile on the diagonal
                             scale, scale_log2, t);
                }
                h9::mbar_arrive_warp(&empty[s]);  // this consumer is done with the stage
            }
            h9::mbar_arrive_warp(&kv_empty[kvb]);  // and with this item's K and V
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = key + 8 * h;
                if (r < T) {
                    bf::bf16* ko = dk + (rows + r) * DH + 2 * t;
                    bf::bf16* vo = dv + (rows + r) * DH + 2 * t;
#pragma unroll
                    for (int j = 0; j < DH / 8; ++j) {
                        *reinterpret_cast<uint32_t*>(ko + 8 * j) =
                            h9::pack_bf16(st.dk[4 * j + 2 * h], st.dk[4 * j + 2 * h + 1]);
                        *reinterpret_cast<uint32_t*>(vo + 8 * j) =
                            h9::pack_bf16(st.dv[4 * j + 2 * h], st.dv[4 * j + 2 * h + 1]);
                    }
                }
            }
        }
    }
}

template <bool CAUSAL>
cudaError_t launch_dkv_bf16_wgmma(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                                  const float* lse, const bf::bf16* dout, const float* dvec,
                                  bf::bf16* dk, bf::bf16* dv, int bh, int t,
                                  cudaStream_t stream) {
    constexpr int DH = wg_dkv::DH, BR = wg_dkv::BR, BC = wg_dkv::BC;
    constexpr int THREADS = wg_dkv::THREADS;
    constexpr size_t SMEM = wg_dkv::SMEM;
    CUtensorMap tq, tk, tv, tdo;
    int sms = 0;
    cudaError_t err = h9::encode_heads(&tq, q, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::encode_heads(&tk, k, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::encode_heads(&tv, v, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::encode_heads(&tdo, dout, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::sm_count(&sms);
    if (err != cudaSuccess) return err;
    auto kernel = flash_attention_bwd_dkv_bf16_wgmma_kernel<CAUSAL>;
    static unsigned long long smem_set = 0;
    err = h9::allow_smem(kernel, SMEM, &smem_set);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const long long items = (long long)bh * ((t + BR - 1) / BR);
    const int grid = (int)(items < sms ? items : sms);  // persistent: one block per SM
    kernel<<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, tdo, lse, dvec, dk, dv, bh, t, scale,
                                            scale * LOG2E);
    return cudaGetLastError();
}

}  // namespace

// ======================================================================
// Flash-attention backward dq, bf16, redesigned for Hopper: the kernel that
// serves the bf16 dq at Dh 64 (GPT-2-small's [8, 12, 1024, 64]); Dh 128 and
// 256 keep the mma.sync dq kernel above. It computes what that kernel
// computes, at the same rounding points (the TPU kernel's
// _flash_attention_dq_kernel, flash_attention.py :1146-1283): D =
// rowsum(f32(dO) o f32(O)) in f32, written to dvec for the dk/dv kernel
// that runs next; S = Q K^T and dP = dO V^T of bf16 operands in f32; P =
// exp2(S scale log2e - LSE log2e) and dS = P o (dP - D) scale in f32, dS
// rounded to bf16 only as the operand of dQ += dS K; dQ summed in f32 and
// written in bf16. Every output element has one owner block, no atomics:
// the same bits from run to run.
//
// What bounds it. At [8, 12, 1024, 64], causal, the three products are
// 19.35 GFLOP, 0.020 ms at 989 TFLOP/s dense bf16; the bytes (q, k, v, o,
// dO read and dQ written, 6 bf16 [N, H, T, Dh] tensors, the LSE read and D
// written) take 0.023 ms: bytes, by a little, with the exponentials (the
// MUFU's 16 a clock an SM) a co-bound at Dh 64.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W): 0.0591 ms of device time
// a launch, against 0.1141 for the mma.sync kernel in the same run (full
// attention 0.0987 against 0.1624); with the dk/dv kernel the bf16
// backward takes 0.1455 ms against 0.1548 for the backward of
// F.scaled_dot_product_attention in bf16. Without the turns below the
// kernel takes 0.0636. ptxas: 168 registers at launch, no spills.
//
// Design: the transpose of the dk/dv kernel above.
//   * Persistent: one block of 3 warpgroups on each SM walks work items
//     (n*h, BR = 128 query rows); causal: the last query blocks, which see
//     the most key tiles, come first, dealt in a snake. The producer
//     warpgroup (24 registers) loads an item's Q, dO and O (TMA) into one
//     of 2 buffers, then streams K and V tiles of BC = 64 keys through a
//     ring of 5 stages. Two consumer warpgroups (240 registers) own 64
//     query rows each.
//   * D first: each consumer sums f32(dO) o f32(O) of its rows from the
//     shared-memory tiles, a quarter row a thread and one quad reduction,
//     and keeps D and the LSE (base 2) of its two rows in registers.
//   * S = Q K^T and dP = dO V^T: wgmma m64n64k16 x 4 each, both operands
//     from shared memory, K-major; P is computed while dP still runs. dS
//     is rounded into the A registers of the dQ share = bf16(dS) K (wgmma
//     m64n64k16 x 4, K MN-major), which is summed from zero and added to
//     dQ in f32 (the tensor core truncates when it adds into its
//     accumulator).
//   * Overlap: the two consumers take turns at issuing S and dP (named
//     barriers 1 and 2, one turn each per key tile), so one's exponentials
//     and dS run under the other's products.
//   * Causal: an item's key loop stops at its diagonal; a consumer whose
//     rows all lie before a tile's keys skips its products but still takes
//     its turn and releases the stage; only the tile on its diagonal is
//     masked. The second consumer's rows see one more tile than the
//     first's. A last block of 64 rows (T % 128 == 64): the second
//     consumer's rows lie past T, load as zeros, and it skips every tile
//     and writes neither D nor dQ.

namespace {

namespace wg_dq {
constexpr int DH = 64, BR = 128, BC = 64, STAGES = 5, THREADS = 384;
constexpr int RES = BR * DH;   // bf16 of a resident Q, dO or O block
constexpr int TILE = BC * DH;  // bf16 of a streamed K or V tile
constexpr uint32_t RES_BYTES = RES * sizeof(bf::bf16), TILE_BYTES = TILE * sizeof(bf::bf16);
// 1 KB to align the tiles, 2 buffers of Q, dO and O, the K and V stages,
// the barriers
constexpr size_t SMEM = 1024 + 6 * RES_BYTES + STAGES * 2 * TILE_BYTES + 8 * (4 + 2 * STAGES);
}  // namespace wg_dq

// a consumer's registers over one work item
struct DqState {
    float s[wg_dq::BC / 2];   // S, then P
    float dp[wg_dq::BC / 2];  // dP, then dS, then the dQ share
    float dq[wg_dq::DH / 2];
    uint32_t da[wg_dq::BC / 4];  // bf16(dS): A registers
};

// One key tile of a consumer (MASKED: the tile on its diagonal), in its
// turn: S and dP issued between taking the turn (named barrier `mine`) and
// handing it on (`other`); P, dS and the dQ share, all waited for here; dQ
// += the share in f32. row: the thread's first query row; lse2, dd: the LSE
// (base 2) and D of rows row and row + 8.
template <bool MASKED>
__device__ __forceinline__ void dq_tile(DqState& st, uint64_t q_desc, uint64_t do_desc,
                                        const bf::bf16* Ks, const bf::bf16* Vs,
                                        const float (&lse2)[2], const float (&dd)[2], int k0,
                                        int row, float scale, float scale_log2, int t, int mine,
                                        int other) {
    const uint64_t k_desc = h9::desc_sw128(Ks, 16, 1024);
    const uint64_t v_desc = h9::desc_sw128(Vs, 16, 1024);
    h9::bar_sync(mine, 256);
    h9::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < wg_dq::DH / 16; ++ks)
        h9::wgmma_ss_n64<0>(st.s, h9::desc_at(q_desc, ks * 32), h9::desc_at(k_desc, ks * 32),
                            ks);
    h9::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < wg_dq::DH / 16; ++ks)
        h9::wgmma_ss_n64<0>(st.dp, h9::desc_at(do_desc, ks * 32), h9::desc_at(v_desc, ks * 32),
                            ks);
    h9::wgmma_commit();
    h9::bar_arrive(other, 256);
    h9::wgmma_wait<1>();  // S landed; dP may still run
    h9::fence_regs(st.s);
#pragma unroll
    for (int j = 0; j < wg_dq::BC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            st.s[4 * j + e] = (MASKED && key > row + 8 * (e >> 1))
                ? 0.f
                : h9::exp2_ftz(fmaf(st.s[4 * j + e], scale_log2, -lse2[e >> 1]));  // P
        }
    h9::wgmma_wait<0>();
    h9::fence_regs(st.dp);
#pragma unroll
    for (int i = 0; i < wg_dq::BC / 2; ++i)
        st.dp[i] = st.s[i] * (st.dp[i] - dd[(i >> 1) & 1]) * scale;  // dS
    h9::pack_a<wg_dq::BC / 2>(st.da, st.dp);  // rounded to bf16 only here, as the TPU kernel
    // dQ share = bf16(dS) K (K MN-major: the sum runs over keys), into dS's
    // registers
    h9::wgmma_fence();
    const uint64_t k_mn = h9::desc_sw128(Ks, wg_dq::TILE_BYTES, 1024);
#pragma unroll
    for (int kk = 0; kk < wg_dq::BC / 16; ++kk)
        h9::wgmma_rs_n64<1>(st.dp, st.da[4 * kk], st.da[4 * kk + 1], st.da[4 * kk + 2],
                            st.da[4 * kk + 3], h9::desc_at(k_mn, kk * 2048), kk);
    h9::wgmma_commit();
    h9::wgmma_wait<0>();
    h9::fence_regs(st.dp);
    h9::fence_regs(st.da);
#pragma unroll
    for (int r = 0; r < wg_dq::DH / 2; ++r) st.dq[r] += st.dp[r];
}

// f32(dO) o f32(O) summed over a row of two 128-byte-swizzled [rows][64]
// tiles: this thread's quarter (16-byte chunks 2t and 2t + 1), then the
// quad's sum
__device__ __forceinline__ float row_dot(const bf::bf16* dOs, const bf::bf16* Os, int r,
                                         int t) {
    float sum = 0.f;
#pragma unroll
    for (int c = 2 * t; c < 2 * t + 2; ++c) {
        const int off = r * 64 + ((c ^ (r & 7)) * 8);
        const uint4 a = *reinterpret_cast<const uint4*>(dOs + off);
        const uint4 b = *reinterpret_cast<const uint4*>(Os + off);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            sum = fmaf(__uint_as_float(aw[i] << 16), __uint_as_float(bw[i] << 16), sum);
            sum = fmaf(__uint_as_float(aw[i] & 0xffff0000u), __uint_as_float(bw[i] & 0xffff0000u),
                       sum);
        }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    return sum;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(wg_dq::THREADS, 1)
flash_attention_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                         const __grid_constant__ CUtensorMap tm_k,
                                         const __grid_constant__ CUtensorMap tm_v,
                                         const __grid_constant__ CUtensorMap tm_o,
                                         const __grid_constant__ CUtensorMap tm_do,
                                         const float* __restrict__ lse,
                                         bf::bf16* __restrict__ dq, float* __restrict__ dvec,
                                         int bh, int T, float scale, float scale_log2) {
    constexpr int DH = wg_dq::DH, BR = wg_dq::BR, BC = wg_dq::BC;
    constexpr int STAGES = wg_dq::STAGES, RES = wg_dq::RES, TILE = wg_dq::TILE;
    constexpr uint32_t RES_BYTES = wg_dq::RES_BYTES, TILE_BYTES = wg_dq::TILE_BYTES;
    extern __shared__ unsigned char smem_raw[];
    bf::bf16* Qs = reinterpret_cast<bf::bf16*>(h9::align1024(smem_raw));  // 2 buffers
    bf::bf16* dOs = Qs + 2 * RES;                                         // 2 buffers
    bf::bf16* Os = dOs + 2 * RES;                                         // 2 buffers
    bf::bf16* Kt = Os + 2 * RES;          // STAGES tiles
    bf::bf16* Vt = Kt + STAGES * TILE;    // STAGES tiles
    uint64_t* r_full = reinterpret_cast<uint64_t*>(Vt + STAGES * TILE);
    uint64_t* r_empty = r_full + 2;
    uint64_t* full = r_empty + 2;
    uint64_t* empty = full + STAGES;

    const int n_qb = (T + BR - 1) / BR, n_items = bh * n_qb;

    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            h9::mbar_init(&r_full[b], 1);
            h9::mbar_init(&r_empty[b], 2 * 4);  // every consumer warp
        }
        for (int s = 0; s < STAGES; ++s) {
            h9::mbar_init(&full[s], 1);
            h9::mbar_init(&empty[s], 2 * 4);
        }
        h9::mbar_fence_init();
    }
    __syncthreads();

    // work item w: query block qb of head w % bh (causal: the last query
    // blocks see the most key tiles, and come first); its key tiles run up
    // to the diagonal (causal) or over all T
    auto item = [&](int w, int& head, int& qb, int& n_tiles) {
        head = w % bh;
        qb = CAUSAL ? n_qb - 1 - w / bh : w / bh;
        n_tiles = CAUSAL ? min((qb + 1) * BR, T) / BC : T / BC;
    };
    if (threadIdx.x < 128) {  // the producer warpgroup
        h9::regs_shrink<24>();
        if (threadIdx.x == 0) {
            int tile = 0;  // the ring's count of tiles, over every item
            for (int i = 0;; ++i) {
                const int w = h9::snake_item(i);
                if (w >= n_items) break;
                int head, qb, n_tiles;
                item(w, head, qb, n_tiles);
                const int b = i & 1;
                if (i >= 2) h9::mbar_wait(&r_empty[b], (i / 2 - 1) & 1);
                h9::mbar_expect_tx(&r_full[b], 3 * RES_BYTES);
                h9::tma_load_3d(Qs + b * RES, &tm_q, &r_full[b], 0, qb * BR, head);
                h9::tma_load_3d(dOs + b * RES, &tm_do, &r_full[b], 0, qb * BR, head);
                h9::tma_load_3d(Os + b * RES, &tm_o, &r_full[b], 0, qb * BR, head);
                for (int kt = 0; kt < n_tiles; ++kt, ++tile) {
                    const int s = tile % STAGES;
                    if (tile >= STAGES) h9::mbar_wait(&empty[s], (tile / STAGES - 1) & 1);
                    h9::mbar_expect_tx(&full[s], 2 * TILE_BYTES);
                    h9::tma_load_3d(Kt + s * TILE, &tm_k, &full[s], 0, kt * BC, head);
                    h9::tma_load_3d(Vt + s * TILE, &tm_v, &full[s], 0, kt * BC, head);
                }
            }
        }
    } else {  // the consumer warpgroups
        h9::regs_grow<240>();
        const int cw = threadIdx.x / 128 - 1;
        const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int g = lane >> 2, t = lane & 3;
        const int mine = 1 + cw, other = 2 - cw;  // the turns' named barriers

        DqState st;
        if (cw == 1) h9::bar_arrive(1, 256);  // consumer 0 takes the first turn
        int tile = 0;
        for (int i = 0;; ++i) {
            const int w = h9::snake_item(i);
            if (w >= n_items) break;
            int head, qb, n_tiles;
            item(w, head, qb, n_tiles);
            const size_t rows = (size_t)head * T;
            const int b = i & 1;
            const int row0 = qb * BR + cw * 64;  // the consumer's first row
            const int row = row0 + warp * 16 + g;  // and row + 8
            const bool live = row0 < T;  // T % 64 == 0: all its rows or none
            const int lr = cw * 64 + warp * 16 + g;  // row within the buffers
            const uint64_t q_desc = h9::desc_sw128(Qs + b * RES + cw * 64 * DH, 16, 1024);
            const uint64_t do_desc = h9::desc_sw128(dOs + b * RES + cw * 64 * DH, 16, 1024);
            h9::mbar_wait(&r_full[b], (i / 2) & 1);
            float dd[2], lse2[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                dd[h] = row_dot(dOs + b * RES, Os + b * RES, lr + 8 * h, t);
                lse2[h] = live ? lse[rows + row + 8 * h] * LOG2E : 0.f;
                if (live && t == 0) dvec[rows + row + 8 * h] = dd[h];
            }
#pragma unroll
            for (int r = 0; r < DH / 2; ++r) st.dq[r] = 0.f;
            for (int kt = 0; kt < n_tiles; ++kt, ++tile) {
                const int s = tile % STAGES, k0 = kt * BC;
                h9::mbar_wait(&full[s], (tile / STAGES) & 1);
                if (!live || (CAUSAL && k0 > row0)) {  // no rows at or after these keys
                    h9::bar_sync(mine, 256);           // the turn, with no products
                    h9::bar_arrive(other, 256);
                } else if (CAUSAL && k0 == row0) {  // the tile on the diagonal
                    dq_tile<true>(st, q_desc, do_desc, Kt + s * TILE, Vt + s * TILE, lse2, dd,
                                  k0, row, scale, scale_log2, t, mine, other);
                } else {
                    dq_tile<false>(st, q_desc, do_desc, Kt + s * TILE, Vt + s * TILE, lse2, dd,
                                   k0, row, scale, scale_log2, t, mine, other);
                }
                h9::mbar_arrive_warp(&empty[s]);  // this consumer is done with the stage
            }
            h9::mbar_arrive_warp(&r_empty[b]);  // and with this item's Q, dO and O
            if (live) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    bf::bf16* out = dq + (rows + row + 8 * h) * DH + 2 * t;
#pragma unroll
                    for (int j = 0; j < DH / 8; ++j)
                        *reinterpret_cast<uint32_t*>(out + 8 * j) =
                            h9::pack_bf16(st.dq[4 * j + 2 * h], st.dq[4 * j + 2 * h + 1]);
                }
            }
        }
    }
}

template <bool CAUSAL>
cudaError_t launch_dq_bf16_wgmma(const bf::bf16* q, const bf::bf16* k, const bf::bf16* v,
                                 const bf::bf16* o, const float* lse, const bf::bf16* dout,
                                 bf::bf16* dq, float* dvec, int bh, int t,
                                 cudaStream_t stream) {
    constexpr int DH = wg_dq::DH, BR = wg_dq::BR, BC = wg_dq::BC;
    constexpr int THREADS = wg_dq::THREADS;
    constexpr size_t SMEM = wg_dq::SMEM;
    CUtensorMap tq, tk, tv, to, tdo;
    int sms = 0;
    cudaError_t err = h9::encode_heads(&tq, q, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::encode_heads(&tk, k, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::encode_heads(&tv, v, bh, t, DH, BC);
    if (err == cudaSuccess) err = h9::encode_heads(&to, o, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::encode_heads(&tdo, dout, bh, t, DH, BR);
    if (err == cudaSuccess) err = h9::sm_count(&sms);
    if (err != cudaSuccess) return err;
    auto kernel = flash_attention_bwd_dq_bf16_wgmma_kernel<CAUSAL>;
    static unsigned long long smem_set = 0;
    err = h9::allow_smem(kernel, SMEM, &smem_set);
    if (err != cudaSuccess) return err;
    const float scale = 1.f / sqrtf((float)DH);
    const long long items = (long long)bh * ((t + BR - 1) / BR);
    const int grid = (int)(items < sms ? items : sms);  // persistent: one block per SM
    kernel<<<grid, THREADS, SMEM, stream>>>(tq, tk, tv, to, tdo, lse, dq, dvec, bh, t, scale,
                                            scale * LOG2E);
    return cudaGetLastError();
}

}  // namespace

// The design and tiles that serve the bf16 dq kernel at head width dh:
// design 1 is the wgmma kernel, 0 the mma.sync one; br query rows a block,
// bc keys a tile. Returns a cudaError_t.
extern "C" int dl4j_flash_attention_bwd_dq_bf16_tiles(int dh, int* design, int* br, int* bc) {
    switch (dh) {
        case 64:
            *design = 1, *br = wg_dq::BR, *bc = wg_dq::BC;
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

// The design and tiles that serve the bf16 dk/dv kernel at head width dh:
// design 1 is the wgmma kernel, 0 the mma.sync one; br key rows a block,
// bc queries a tile. Returns a cudaError_t.
extern "C" int dl4j_flash_attention_bwd_dkv_bf16_tiles(int dh, int* design, int* br,
                                                       int* bc) {
    switch (dh) {
        case 64:
            *design = 1, *br = wg_dkv::BR, *bc = wg_dkv::BC;
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

// q, k, v, o, dout, dq: contiguous [bh, t, dh] bf16 on the device; lse,
// dvec: [bh, t] f32. Writes dq and D = rowsum(f32(dout) * f32(o)) into
// dvec. t % 64 == 0, dh in {64, 128, 256}. Returns a cudaError_t.
extern "C" int dl4j_flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                                const void* v, const void* o,
                                                const void* lse, const void* dout,
                                                void* dq, void* dvec, int bh,
                                                int t, int dh, int causal,
                                                void* stream) {
    if (bad_shape(bh, t)) return (int)cudaErrorInvalidValue;
    const auto *qb = static_cast<const bf::bf16*>(q), *kb = static_cast<const bf::bf16*>(k),
               *vb = static_cast<const bf::bf16*>(v), *ob = static_cast<const bf::bf16*>(o),
               *gb = static_cast<const bf::bf16*>(dout);
    const float* lf = static_cast<const float*>(lse);
    auto* dqb = static_cast<bf::bf16*>(dq);
    float* df = static_cast<float*>(dvec);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DQ_BF16(DH)                                                                \
    return (int)(causal ? launch_dq_bf16<DH, true>(qb, kb, vb, ob, lf, gb, dqb, df, bh, t, s) \
                        : launch_dq_bf16<DH, false>(qb, kb, vb, ob, lf, gb, dqb, df, bh, t, s))
    switch (dh) {
        case 64:  // the wgmma kernel
            return (int)(causal ? launch_dq_bf16_wgmma<true>(qb, kb, vb, ob, lf, gb, dqb, df, bh,
                                                             t, s)
                                : launch_dq_bf16_wgmma<false>(qb, kb, vb, ob, lf, gb, dqb, df,
                                                              bh, t, s));
        case 128: DL4J_DQ_BF16(128);
        case 256: DL4J_DQ_BF16(256);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DL4J_DQ_BF16
}

// q, k, v, dout, dk, dv: contiguous [bh, t, dh] bf16 on the device; lse,
// dvec: [bh, t] f32 (dvec as the dq kernel wrote it). Writes dk and dv.
// Returns a cudaError_t (0 = launched).
extern "C" int dl4j_flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                                 const void* v, const void* lse,
                                                 const void* dout, const void* dvec,
                                                 void* dk, void* dv, int bh,
                                                 int t, int dh, int causal,
                                                 void* stream) {
    if (bad_shape(bh, t)) return (int)cudaErrorInvalidValue;
    const auto *qb = static_cast<const bf::bf16*>(q), *kb = static_cast<const bf::bf16*>(k),
               *vb = static_cast<const bf::bf16*>(v), *gb = static_cast<const bf::bf16*>(dout);
    const float *lf = static_cast<const float*>(lse), *df = static_cast<const float*>(dvec);
    auto* dkb = static_cast<bf::bf16*>(dk);
    auto* dvb = static_cast<bf::bf16*>(dv);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_DKV_BF16(DH)                                                                \
    return (int)(causal ? launch_dkv_bf16<DH, true>(qb, kb, vb, lf, gb, df, dkb, dvb, bh, t, s) \
                        : launch_dkv_bf16<DH, false>(qb, kb, vb, lf, gb, df, dkb, dvb, bh, t, s))
    switch (dh) {
        case 64:  // the wgmma kernel
            return (int)(causal ? launch_dkv_bf16_wgmma<true>(qb, kb, vb, lf, gb, df, dkb, dvb,
                                                              bh, t, s)
                                : launch_dkv_bf16_wgmma<false>(qb, kb, vb, lf, gb, df, dkb,
                                                               dvb, bh, t, s));
        case 128: DL4J_DKV_BF16(128);
        case 256: DL4J_DKV_BF16(256);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DL4J_DKV_BF16
}
