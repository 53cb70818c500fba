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
// Design: the f32 kernels' split (the dq kernel first, writing D; then the
// dk/dv kernel; every output element has one owner block, no atomics) on
// bf16_mma.cuh's geometry: blocks of 64 resident rows in 4 row groups of
// 16 (two warps a group at Dh 256), streamed tiles of BC rows through a
// 2-stage cp.async ring, bf16 mma.sync m16n8k16, P and dS rounded into the
// next product's A fragment in registers.

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
        case 64: DL4J_DQ_BF16(64);
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
        case 64: DL4J_DKV_BF16(64);
        case 128: DL4J_DKV_BF16(128);
        case 256: DL4J_DKV_BF16(256);
        default: return (int)cudaErrorInvalidValue;
    }
#undef DL4J_DKV_BF16
}
