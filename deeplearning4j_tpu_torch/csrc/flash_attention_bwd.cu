// Flash-attention backward, f32, for Hopper (sm_90a), on the CUDA cores.
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
// Design for this card (not the TPU blocks carried over):
//   * dq kernel, launched FIRST: one block per (n*h, query tile). It loads
//     its Q and dO tiles once, computes D for its rows (O is read once,
//     here) and writes D out for the dk/dv kernel, then loops over key
//     tiles up to the diagonal (causal) accumulating dQ in registers.
//   * dk/dv kernel: one block per (n*h, key tile). K and V stay in shared
//     memory; it loops over query tiles from the diagonal down (causal),
//     accumulating dK and dV in registers. No atomics: every output element
//     has exactly one owner block.
//   * the forward kernel's register tiling: 256 threads = 16 row groups x
//     16 lanes; a thread owns B/16 rows x B/16 columns of each B x B score
//     tile (columns strided by 16 so shared-memory reads do not conflict)
//     and B/16 rows x Dh/16 columns of each accumulator. P and dS go
//     through a per-warp slice of shared memory (a row group's 16 lanes
//     write and read only their own rows, so __syncwarp orders them).
//   * tile B = 64 rows for Dh 64 and 128, 32 rows for Dh 256: four B x
//     (Dh+4) tiles plus the score tile take 87 KB, 153 KB and 138 KB of
//     shared memory (64-row tiles at Dh 256 would need 266 KB, above the
//     227 KB a block may have).
//   * causal: both loops stop at the diagonal tile and mask inside it; the
//     heaviest tiles are scheduled first.
//   * f32 FMAs on the CUDA cores, no TF32.
//
// Bound at the trained GPT-2-small shape [N=8, H=12, T=1024, Dh=64],
// causal, in multiply-adds of the causal pairs T(T+1)/2 per head:
//   dk/dv: 4 products (S, dP, dV, dK) = 2 x the forward's 12.9 GFLOP;
//   dq:    3 products (S, dP, dQ)     = 1.5 x the forward's.
// At the H100 SXM's 67 TFLOP/s f32 (non-tensor) rate that is 0.39 ms and
// 0.29 ms; bytes (6 and 5 tensors of 25.2 MB) are 0.05 ms and 0.04 ms at
// 3.35 TB/s, so both are bound by operations. chip_smoke.py re-derives the
// bounds for the card it runs on. As in the forward, two 16-byte
// shared-memory reads per 16 FMAs make shared-memory bandwidth the first
// limit of this simple version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int PAD = 4;        // keeps rows 16-byte aligned, skews banks
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
    static constexpr int B = DH == 256 ? 32 : 64;  // rows of every tile
    static constexpr int R = B / 16;               // rows (columns) per thread
    static constexpr int LD = DH + PAD;            // row stride of a [B][DH] tile
    static constexpr int S_LD = B + PAD;           // row stride of a [B][B] tile
    static constexpr int DC = DH / 64;             // 64-wide accumulator chunks
    // four [B][LD] tiles, one [B][S_LD] tile, two [B] vectors
    static constexpr size_t BYTES =
        (size_t)(4 * B * LD + B * S_LD + 2 * B) * sizeof(float);
};

__device__ __forceinline__ float f4_at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// rows [0, B) of a [*, DH] head slice starting at src -> dst[B][LD]
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src) {
    using C = Cfg<DH>;
    constexpr int V4 = DH / 4;
    for (int i = threadIdx.x; i < C::B * V4; i += THREADS) {
        const int r = i / V4, c4 = i % V4;
        const float4 val = reinterpret_cast<const float4*>(src + (size_t)r * DH)[c4];
        *reinterpret_cast<float4*>(dst + r * C::LD + c4 * 4) = val;
    }
}

// s[a][b] = A[ty*R + a] . Bm[tx + 16 b] over DH, both [B][LD] tiles
template <int DH>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         int ty, int tx,
                                         float (&s)[Cfg<DH>::R][Cfg<DH>::R]) {
    using C = Cfg<DH>;
    constexpr int R = C::R, LD = C::LD;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
        float4 av[R], bv[R];
#pragma unroll
        for (int a = 0; a < R; ++a)
            av[a] = *reinterpret_cast<const float4*>(A + (ty * R + a) * LD + d);
#pragma unroll
        for (int b = 0; b < R; ++b)
            bv[b] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * b) * LD + d);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b) {
                float t = s[a][b];
                t = fmaf(av[a].x, bv[b].x, t);
                t = fmaf(av[a].y, bv[b].y, t);
                t = fmaf(av[a].z, bv[b].z, t);
                t = fmaf(av[a].w, bv[b].w, t);
                s[a][b] = t;
            }
    }
}

// acc[a][.] += sum_j P[ty*R + a][j] * X[j][ch*64 + tx*4 + .]
// P: [B][S_LD] (this row group's rows), X: [B][LD]
template <int DH>
__device__ __forceinline__ void acc_rows(const float* P, const float* X,
                                         int ty, int tx,
                                         float (&acc)[Cfg<DH>::R][4 * Cfg<DH>::DC]) {
    using C = Cfg<DH>;
    constexpr int R = C::R, DC = C::DC;
#pragma unroll 2
    for (int j = 0; j < C::B; j += 4) {
        float4 pa[R];
#pragma unroll
        for (int a = 0; a < R; ++a)
            pa[a] = *reinterpret_cast<const float4*>(P + (ty * R + a) * C::S_LD + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int ch = 0; ch < DC; ++ch) {
                const float4 xv = *reinterpret_cast<const float4*>(
                    X + (j + jj) * C::LD + ch * 64 + tx * 4);
#pragma unroll
                for (int a = 0; a < R; ++a) {
                    const float p = f4_at(pa[a], jj);
                    acc[a][ch * 4 + 0] = fmaf(p, xv.x, acc[a][ch * 4 + 0]);
                    acc[a][ch * 4 + 1] = fmaf(p, xv.y, acc[a][ch * 4 + 1]);
                    acc[a][ch * 4 + 2] = fmaf(p, xv.z, acc[a][ch * 4 + 2]);
                    acc[a][ch * 4 + 3] = fmaf(p, xv.w, acc[a][ch * 4 + 3]);
                }
            }
        }
    }
}

// out rows [0, B) of a [*, DH] head slice <- acc * mul (this thread's part)
template <int DH>
__device__ __forceinline__ void store_rows(float* __restrict__ out, int ty, int tx,
                                           float (&acc)[Cfg<DH>::R][4 * Cfg<DH>::DC],
                                           float mul) {
    using C = Cfg<DH>;
#pragma unroll
    for (int a = 0; a < C::R; ++a) {
        const int row = ty * C::R + a;
#pragma unroll
        for (int ch = 0; ch < C::DC; ++ch) {
            float4 v;
            v.x = acc[a][ch * 4 + 0] * mul;
            v.y = acc[a][ch * 4 + 1] * mul;
            v.z = acc[a][ch * 4 + 2] * mul;
            v.w = acc[a][ch * 4 + 3] * mul;
            *reinterpret_cast<float4*>(out + (size_t)row * DH + ch * 64 + tx * 4) = v;
        }
    }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
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
    constexpr int B = C::B, R = C::R, LD = C::LD, S_LD = C::S_LD, DC = C::DC;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* dOs = Qs + B * LD;
    float* Ks = dOs + B * LD;
    float* Vs = Ks + B * LD;
    float* Ss = Vs + B * LD;  // dS tile [B][S_LD]

    const int n_tiles = T / B;
    // causal: the last query tiles do the most work; start them first
    const int qt = CAUSAL ? (n_tiles - 1 - (int)blockIdx.y) : (int)blockIdx.y;
    const size_t head = (size_t)blockIdx.x * T * DH;
    const size_t vec0 = (size_t)blockIdx.x * T + (size_t)qt * B;  // into [bh, T]
    const int ty = threadIdx.x >> 4;  // row group: rows ty*R .. ty*R+R-1
    const int tx = threadIdx.x & 15;  // lane: key columns tx + 16*b

    load_tile<DH>(Qs, q + head + (size_t)qt * B * DH);
    load_tile<DH>(dOs, dout + head + (size_t)qt * B * DH);
    __syncthreads();

    // D = rowsum(dO o O) for this thread's rows, reduced over the 16 lanes
    float drow[R], lse2[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
        const int row = ty * R + a;
        const float* orow = o + head + ((size_t)qt * B + row) * DH;
        float sum = 0.f;
#pragma unroll
        for (int ch = 0; ch < DC; ++ch) {
            const float4 ov = *reinterpret_cast<const float4*>(orow + ch * 64 + tx * 4);
            const float4 gv = *reinterpret_cast<const float4*>(dOs + row * LD + ch * 64 + tx * 4);
            sum = fmaf(ov.x, gv.x, sum);
            sum = fmaf(ov.y, gv.y, sum);
            sum = fmaf(ov.z, gv.z, sum);
            sum = fmaf(ov.w, gv.w, sum);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        drow[a] = sum;
        lse2[a] = lse[vec0 + row] * LOG2E;
    }
    if (tx == 0) {
#pragma unroll
        for (int a = 0; a < R; ++a) dvec[vec0 + ty * R + a] = drow[a];
    }

    float acc[R][4 * DC];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < 4 * DC; ++c) acc[a][c] = 0.f;

    const int kv_end = CAUSAL ? qt + 1 : n_tiles;
    for (int kt = 0; kt < kv_end; ++kt) {
        __syncthreads();  // the previous tile's Ks/Vs/Ss are consumed
        load_tile<DH>(Ks, k + head + (size_t)kt * B * DH);
        load_tile<DH>(Vs, v + head + (size_t)kt * B * DH);
        __syncthreads();

        float s[R][R], dp[R][R];
        dot_tile<DH>(Qs, Ks, ty, tx, s);
        dot_tile<DH>(dOs, Vs, ty, tx, dp);
        const bool diag = CAUSAL && kt == qt;
#pragma unroll
        for (int a = 0; a < R; ++a) {
            const int row = ty * R + a;
#pragma unroll
            for (int b = 0; b < R; ++b) {
                const int col = tx + 16 * b;
                const float p = (diag && col > row)
                    ? 0.f : exp2f(fmaf(s[a][b], scale_log2, -lse2[a]));
                Ss[row * S_LD + col] = p * (dp[a][b] - drow[a]);
            }
        }
        __syncwarp();  // a row group reads only the rows its own lanes wrote
        acc_rows<DH>(Ss, Ks, ty, tx, acc);
    }
    store_rows<DH>(dq + head + (size_t)qt * B * DH, ty, tx, acc, scale);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
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
    constexpr int B = C::B, R = C::R, S_LD = C::S_LD, DC = C::DC, LD = C::LD;
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);
    float* Vs = Ks + B * LD;
    float* Qs = Vs + B * LD;
    float* dOs = Qs + B * LD;
    float* Ps = dOs + B * LD;  // P^T, then dS^T: [B keys][S_LD]
    float* Ls = Ps + B * S_LD;  // LSE of the query tile, base-2 units
    float* Ds = Ls + B;         // D of the query tile

    const int n_tiles = T / B;
    // causal: the first key tiles see the most query tiles; start them first
    const int kt = (int)blockIdx.y;
    const size_t head = (size_t)blockIdx.x * T * DH;
    const int ty = threadIdx.x >> 4;  // row group: key rows ty*R ..
    const int tx = threadIdx.x & 15;  // lane: query columns tx + 16*b

    load_tile<DH>(Ks, k + head + (size_t)kt * B * DH);
    load_tile<DH>(Vs, v + head + (size_t)kt * B * DH);

    float dk_acc[R][4 * DC], dv_acc[R][4 * DC];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < 4 * DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

    for (int qt = CAUSAL ? kt : 0; qt < n_tiles; ++qt) {
        __syncthreads();  // the previous tile's Qs/dOs/Ps/Ls/Ds are consumed
        load_tile<DH>(Qs, q + head + (size_t)qt * B * DH);
        load_tile<DH>(dOs, dout + head + (size_t)qt * B * DH);
        const size_t vec0 = (size_t)blockIdx.x * T + (size_t)qt * B;
        for (int i = threadIdx.x; i < B; i += THREADS) {
            Ls[i] = lse[vec0 + i] * LOG2E;
            Ds[i] = dvec[vec0 + i];
        }
        __syncthreads();

        float s[R][R], dp[R][R];
        dot_tile<DH>(Ks, Qs, ty, tx, s);   // S^T: keys x queries
        dot_tile<DH>(Vs, dOs, ty, tx, dp); // dP^T
        const bool diag = CAUSAL && qt == kt;
#pragma unroll
        for (int a = 0; a < R; ++a) {
            const int key = ty * R + a;
#pragma unroll
            for (int b = 0; b < R; ++b) {
                const int qry = tx + 16 * b;
                const float p = (diag && key > qry)
                    ? 0.f : exp2f(fmaf(s[a][b], scale_log2, -Ls[qry]));
                Ps[key * S_LD + qry] = p;
                s[a][b] = p * (dp[a][b] - Ds[qry]);  // dS^T, kept for below
            }
        }
        __syncwarp();
        acc_rows<DH>(Ps, dOs, ty, tx, dv_acc);  // dV += P^T dO
        __syncwarp();  // every lane of the row group is done reading P^T
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b)
                Ps[(ty * R + a) * S_LD + tx + 16 * b] = s[a][b];
        __syncwarp();
        acc_rows<DH>(Ps, Qs, ty, tx, dk_acc);   // dK += dS^T Q
    }
    store_rows<DH>(dk + head + (size_t)kt * B * DH, ty, tx, dk_acc, scale);
    store_rows<DH>(dv + head + (size_t)kt * B * DH, ty, tx, dv_acc, 1.f);
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
    const dim3 grid(bh, t / Cfg<DH>::B);
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
    const dim3 grid(bh, t / Cfg<DH>::B);
    kernel<<<grid, THREADS, smem, stream>>>(q, k, v, lse, dout, dvec, dk, dv, t,
                                            scale, scale * LOG2E);
    return cudaGetLastError();
}

bool bad_shape(int bh, int t) {
    return bh <= 0 || t <= 0 || t % 64 != 0 || t / 32 > 65535;
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
