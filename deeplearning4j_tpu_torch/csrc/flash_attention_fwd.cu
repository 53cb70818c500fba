// Flash-attention forward, f32, for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the forward of PallasFlashAttentionHelper.attend
// (deeplearning4j_tpu/nn/pallas_kernels.py:359), which calls jax's bundled
// TPU kernel jax.experimental.pallas.ops.tpu.flash_attention:
//     o = softmax(q k^T / sqrt(Dh) [causal]) v,   q, k, v, o: [N, H, T, Dh] f32.
//
// Design for this card (not the TPU kernel carried over block by block):
//   * one thread block per (n*h, 64-row query tile); the TPU's sequential
//     k grid becomes a loop inside the block over 64-row k/v tiles staged in
//     shared memory;
//   * the running max, the running sum and the O accumulator stay in
//     registers (online softmax); O / l is written once;
//   * causal: the loop stops at the diagonal tile and masks inside it, and
//     the heaviest query tiles are scheduled first;
//   * 256 threads = 16 row groups x 16 lanes. A thread owns 4 query rows
//     (so its softmax statistics live in its own registers) and, per k tile,
//     4 key columns of S = q k^T, strided by 16 so that shared-memory reads
//     are free of bank conflicts; a row's max and sum are reduced across
//     its 16 lanes with warp shuffles. For P v it owns 4 rows x Dh/16
//     columns of O.
//   * Dh is a template parameter (64, 128, 256). The tiles take 67 KB,
//     115 KB and 211 KB of shared memory, so the launch raises the
//     dynamic shared-memory limit with cudaFuncSetAttribute.
//   * f32 FMAs on the CUDA cores, no TF32. wgmma and TMA come later.
//   * optional LSE output for the backward (csrc/flash_attention_bwd.cu):
//     lse[n*h, T] = m + log(l), the natural-log logsumexp of the SCALED
//     scores q.k / sqrt(Dh) of each row. A null pointer skips it, so the
//     inference path writes nothing extra.
//
// Bound at the served GPT-2-small shape [N=8, H=12, T=1024, Dh=64], causal:
//   operations 4*N*H*Dh*T(T+1)/2 = 12.9 GFLOP -> 0.19 ms at the H100 SXM's
//   67 TFLOP/s f32 (non-tensor) rate; bytes 4 x 25.2 MB (q, k, v read once,
//   o written once) -> 0.03 ms at 3.35 TB/s. The kernel is bound by
//   operations; chip_smoke.py re-derives both for the card it runs on.
//   Each inner step reads two 16-byte shared-memory vectors per 16 FMAs,
//   so shared-memory bandwidth, not the FMA pipe, is the first limit of
//   this simple version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int PAD = 4;        // keeps rows 16-byte aligned, skews banks

template <int DH>
struct Tiles {
    static constexpr int Q_LD = DH + PAD;  // Qs[BM][Q_LD]
    static constexpr int K_LD = DH + PAD;  // Ks[BN][K_LD]
    static constexpr int V_LD = DH;        // Vs[BN][V_LD]
    static constexpr int P_LD = BN + PAD;  // Ps[BM][P_LD]
    static constexpr int FLOATS = BM * Q_LD + BN * K_LD + BN * V_LD + BM * P_LD;
    static constexpr size_t BYTES = FLOATS * sizeof(float);
};

__device__ __forceinline__ float f4_at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows [row0, row0 + BM) of a [T, DH] head slice -> dst[BM][ld]
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src) {
    constexpr int V4 = DH / 4;  // float4 per row
    for (int i = threadIdx.x; i < BM * V4; i += THREADS) {
        const int r = i / V4, c4 = i % V4;
        const float4 val = reinterpret_cast<const float4*>(src + (size_t)r * DH)[c4];
        *reinterpret_cast<float4*>(dst + r * ld + c4 * 4) = val;
    }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, float* __restrict__ lse,
                           int T, float scale_log2) {
    using S = Tiles<DH>;
    constexpr int DC = DH / 64;  // 64-wide column chunks of O per thread row
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + BM * S::Q_LD;
    float* Vs = Ks + BN * S::K_LD;
    float* Ps = Vs + BN * S::V_LD;

    const int n_tiles = T / BM;
    // causal: the last query tiles do the most work; start them first
    const int qt = CAUSAL ? (n_tiles - 1 - (int)blockIdx.y) : (int)blockIdx.y;
    const size_t head = (size_t)blockIdx.x * T * DH;
    const int ty = threadIdx.x >> 4;  // row group: rows ty*4 .. ty*4+3
    const int tx = threadIdx.x & 15;  // lane: key columns tx + 16*b

    load_tile<DH>(Qs, S::Q_LD, q + head + (size_t)qt * BM * DH);

    float acc[4][4 * DC];
    float m[4], l[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        m[a] = -INFINITY;
        l[a] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * DC; ++c) acc[a][c] = 0.f;
    }

    const int kv_end = CAUSAL ? qt + 1 : n_tiles;
    for (int kt = 0; kt < kv_end; ++kt) {
        __syncthreads();  // the previous tile's Ks/Vs are consumed
        load_tile<DH>(Ks, S::K_LD, k + head + (size_t)kt * BN * DH);
        load_tile<DH>(Vs, S::V_LD, v + head + (size_t)kt * BN * DH);
        __syncthreads();

        // S = Q K^T for this thread's 4 rows x 4 columns
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
                qa[a] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + a) * S::Q_LD + d);
#pragma unroll
            for (int b = 0; b < 4; ++b)
                kb[b] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * b) * S::K_LD + d);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    float t = s[a][b];
                    t = fmaf(qa[a].x, kb[b].x, t);
                    t = fmaf(qa[a].y, kb[b].y, t);
                    t = fmaf(qa[a].z, kb[b].z, t);
                    t = fmaf(qa[a].w, kb[b].w, t);
                    s[a][b] = t;
                }
        }

        // online softmax in base 2 (scale_log2 = log2(e) / sqrt(Dh))
        const bool diag = CAUSAL && kt == qt;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int row = ty * 4 + a;
            float mx = -INFINITY;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                float val = s[a][b] * scale_log2;
                if (diag && tx + 16 * b > row) val = -INFINITY;
                s[a][b] = val;
                mx = fmaxf(mx, val);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            // finite: every row has at least one unmasked key in a tile
            const float m_new = fmaxf(m[a], mx);
            const float alpha = exp2f(m[a] - m_new);  // 0 on the first tile
            float rs = 0.f;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const float p = exp2f(s[a][b] - m_new);
                s[a][b] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[a] = l[a] * alpha + rs;
            m[a] = m_new;
#pragma unroll
            for (int c = 0; c < 4 * DC; ++c) acc[a][c] *= alpha;
#pragma unroll
            for (int b = 0; b < 4; ++b) Ps[row * S::P_LD + tx + 16 * b] = s[a][b];
        }
        // a row group's 16 lanes share one warp: it alone writes and reads
        // its rows of Ps
        __syncwarp();

        // O += P V for this thread's 4 rows x (DC chunks of 4 columns)
#pragma unroll 2
        for (int j = 0; j < BN; j += 4) {
            float4 pa[4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
                pa[a] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + a) * S::P_LD + j);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
                for (int ch = 0; ch < DC; ++ch) {
                    const float4 vv = *reinterpret_cast<const float4*>(
                        Vs + (j + jj) * S::V_LD + ch * 64 + tx * 4);
#pragma unroll
                    for (int a = 0; a < 4; ++a) {
                        const float p = f4_at(pa[a], jj);
                        acc[a][ch * 4 + 0] = fmaf(p, vv.x, acc[a][ch * 4 + 0]);
                        acc[a][ch * 4 + 1] = fmaf(p, vv.y, acc[a][ch * 4 + 1]);
                        acc[a][ch * 4 + 2] = fmaf(p, vv.z, acc[a][ch * 4 + 2]);
                        acc[a][ch * 4 + 3] = fmaf(p, vv.w, acc[a][ch * 4 + 3]);
                    }
                }
            }
        }
    }

    float* oh = o + head + (size_t)qt * BM * DH;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const float inv = 1.f / l[a];
        const int row = ty * 4 + a;
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) {
            float4 out;
            out.x = acc[a][ch * 4 + 0] * inv;
            out.y = acc[a][ch * 4 + 1] * inv;
            out.z = acc[a][ch * 4 + 2] * inv;
            out.w = acc[a][ch * 4 + 3] * inv;
            *reinterpret_cast<float4*>(oh + (size_t)row * DH + ch * 64 + tx * 4) = out;
        }
    }
    if (lse != nullptr && tx == 0) {
        // m is in base-2 units of the scaled scores: ln(sum) = (m + log2 l) ln 2
        float* lh = lse + (size_t)blockIdx.x * T + (size_t)qt * BM;
#pragma unroll
        for (int a = 0; a < 4; ++a)
            lh[ty * 4 + a] = (m[a] + log2f(l[a])) * 0.6931471805599453f;
    }
}

template <int DH, bool CAUSAL>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int t, cudaStream_t stream) {
    auto kernel = flash_attention_fwd_kernel<DH, CAUSAL>;
    const size_t smem = Tiles<DH>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
    const dim3 grid(bh, t / BM);
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
    if (bh <= 0 || t <= 0 || t % BM != 0 || t / BM > 65535)
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
