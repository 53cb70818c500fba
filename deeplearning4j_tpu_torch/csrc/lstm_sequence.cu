// Fused LSTM sequence forward (K1), f32 and bf16, for Hopper (sm_90a).
//
// Replaces _lstm_pallas_fwd (deeplearning4j_tpu/nn/pallas_kernels.py:66) and
// its body _lstm_kernel (:37), reached through lstm_fused (:119) from
// PallasLSTMHelper.forward_seq (:153). Given the hoisted input projection
// xw = x W + b [T, N, 4H] (time-major, IFOG gate blocks of H columns), the
// recurrent matrix rw [H, 4H] and the carry h0, c0 [N, H], one launch runs
// the whole recurrence:
//
//   z_t = xw_t + h_{t-1} rw
//   i, f, o = sigmoid(z_i, z_f, z_o),  g = tanh(z_g)
//   c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
//
// and writes ys [T, N, H] (every h_t), hN and cN, all f32.
//
// K1-bf16 is the same recurrence on bf16 xw, rw, h0, c0 (the TPU kernel on a
// bf16 xw, whose scratch and outputs take xw.dtype, :86-95). Each step
// rounds where _lstm_kernel (:47-48) and lstm_sequence_plain on bf16 tensors
// round: d = h_{t-1} rw summed in f32 and rounded once to bf16; z = xw_t + d
// rounded; each gate rounded; f c, i g, their sum, tanh(c) and o tanh(c)
// each rounded. Each op is computed in f32 registers (a bf16 x bf16 product
// is exact in f32) and rounded once (cell_bf16 below). h and c are carried
// in bf16, and ys, hN, cN are written in bf16. Both plans are instantiated
// on the storage type E (float or __nv_bfloat16); the f32 instantiations run
// the same instructions as before bf16 was added. In the cluster plan rw, the
// h buffers and the xw buffers take E's bytes (so at H = 512 the bf16 rw,
// 2 MiB, fits a cluster of 16 CTAs where the f32 rw does not fit one), the
// partial sums stay f32; a bf16 CTA owns an even number of units, so that
// xw's and rw's columns are copied 4 bytes (two units) at a time, and runs
// its recurrent products on the tensor cores (below).
//
// What bounds it. At the training chunk [T, N, H] = [50, 32, 200] the
// recurrent products are 2 T N H 4H = 512 MFLOP: 7.6 us at the H100 SXM's
// 67 TFLOP/s (f32, CUDA cores), 3.1 us as 3xTF32 on the tensor cores. The
// bytes it must move (xw, rw, h0, c0 in; ys, hN, cN out) are 7.1 MB: 2.1 us
// at 3.35 TB/s. Neither is reachable: the recurrence is a chain of T
// dependent steps, and each step needs all of h_{t-1} before any unit of
// h_t. So the limit is the latency of one step (its products, its cell and
// the hand-over of h to every unit's owner) times T. lstm_chain_floor_kernel
// below times that hand-over alone.
//
// Two plans, chosen by the caller (nn/cuda_kernels.py lstm_plan, from the
// shapes and the device's limits alone):
//
// The cluster plan (lstm_sequence_cluster_kernel), where rw fits in the
// shared memory of one thread-block cluster (H up to about 330 at 8 CTAs a
// cluster, about 450 at 16). It rests on one fact: the recurrence couples
// the hidden units of one batch row and never two rows. So:
// - a 1-D grid of C clusters of S CTAs; cluster c owns batch rows
//   [c R, c R + R), CTA s of a cluster owns hidden units [s U, s U + U),
//   U = ceil(H / S), with all four of their gates: the 4U columns
//   {g H + u} of rw, [H, 4U], copied into its shared memory once;
// - every CTA keeps its own copy of its rows of h_{t-1} in shared memory,
//   double-buffered by the parity of t. At step t it computes z for its
//   columns and rows from that copy (each thread one column and one slice
//   of the H products, its rw entry reused over the rows it holds), sums
//   the slices, applies the cell (c never leaves shared memory), writes its
//   units of h_t to ys[t] and into the other buffer of EVERY CTA of the
//   cluster through distributed shared memory (st.shared::cluster), then
//   meets the others at one hardware cluster barrier
//   (barrier.cluster.arrive.release / wait.acquire). The cp.async copy of
//   xw_{t+1}, which does not depend on h, starts at the top of step t, so
//   it has a whole step to land. A fast CTA cannot overwrite a buffer a
//   peer still reads: it
//   writes buffer (t+1)&1 only after the barrier of step t-1, which every
//   peer reaches after its last read of that buffer;
// - clusters never wait on each other: no cooperative launch, no grid
//   barrier, no rule that the whole grid be resident. The grid is C S CTAs
//   launched with cudaLaunchKernelEx and a cluster dimension S; C is chosen
//   so that every cluster is resident at once;
// - no early exit: CTAs whose units or rows run past H or N go through
//   every barrier with the others.
// The f32 products stay on the CUDA cores: each thread one column and one
// slice of H, its rw entry reused over a register block of rows. The bf16
// products run on the tensor cores with the operands swapped, so that the
// few batch rows are the narrow side: d^T [4U x R] = rw_slice^T [4U x H]
// h^T [H x R], bf16 mma.sync m16n8k16 with f32 sums. M is the CTA's 4U gate
// columns (m-tiles of 16), N the R rows (n-tiles of 8, two to a load), K
// is H (k-steps of 16); the padding is zeros in both operands. rw stays
// resident in shared memory, laid out so that ldmatrix.trans reads its A
// fragments without bank conflicts; h (B) is read by ldmatrix from its
// buffer. Where M alone gives fewer m-tiles than warps, K is split into
// parts (warp w: m-tile w % mt, K part w / mt) whose f32 partial sums the
// cell adds. At [128, 64, 512] (S = 16, U = 32): 8 m-tiles x 2 K parts of
// 16 k-steps, 32 mma a warp a step. Holding a warp's A fragments in
// registers over the sequence (64 a thread) was no faster on the card.
//
// The grid plan (lstm_sequence_kernel), for widths whose rw does not fit one
// cluster (H = 512: 4 MB; H = 1500: 36 MB), launched cooperatively (every
// block resident at once) and looping over T itself:
// - block b owns hidden units [b U, b U + U) with all four gates; U is
//   chosen so that the blocks cover at most one SM each (U = ceil(H / SMs))
//   unless the caller sets it. Its slice of rw [H, 4U] is copied into
//   shared memory once when it fits beside the staged h, and read through
//   L2 every step when it does not, in tiles of rows;
// - at step t every block reads the whole h_{t-1} from L2 (ld.cg) into
//   shared memory, 8 loads of 16 bytes in flight a thread, computes z for
//   its columns, applies the cell and writes its slice of h_t into ys[t];
//   c stays with its owner thread (through cN);
// - one grid barrier (a __threadfence, then cooperative_groups' grid sync)
//   separates step t's writes of h_t from step t+1's reads. A grid that
//   cannot be resident is refused by cudaLaunchCooperativeKernel
//   (cudaErrorCooperativeLaunchTooLarge), which is returned to the caller.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py, device time a
// launch): the cluster plan 0.144 ms at [T, N, H] = [50, 32, 200] (S = 8,
// R = 3, 11 clusters: the card holds 15 clusters of 8) and 2.68 ms at
// [1000, 32, 200], about 2.7 us a step, against 0.343 and 7.15 ms for the
// grid plan; its chain floor (the hand-over and barrier alone) is 0.054
// and 1.05 ms. The rest of a step is the products, the cell's
// transcendentals and the block barrier before the cell.
//
// K1-bf16 on the same card (chip_smoke.py's lstm_bf16_kernel phase): at the
// bf16 path's [128, 64, 512] the cluster plan (S = 16, R = 10, 7 clusters)
// takes 0.51-0.56 ms of device time a launch over three runs, 4.4 us a
// step against a 1.48 us chain floor (with its products on the CUDA cores,
// 1.84-1.86 ms in an A/B run on the same card), against 3.07 ms for
// cuDNN's bf16 LSTM and a 0.017 ms bound (17.2 GFLOP at the bf16
// tensor-core rate). Of a step (flash_bf16_ab.py's lstm_split), the
// products take about a third, the hand-over and barrier a third, the cell
// a tenth. The grid plan at that shape takes 5.35 ms. At [50, 32, 200] (S =
// 8, R = 3) 0.142 ms. ptxas: 72 registers, no spills.
//
// DL4J_LSTM_SPLIT_NO_PRODUCTS and DL4J_LSTM_SPLIT_NO_CELL (-D, never in the
// port's own build) cut the bf16 cluster plan's products (zpart held at 0)
// or replace its cell by a few adds: wrong results, for
// flash_bf16_ab.py's split of a step's time only.
//
// Host cost: the device's limits, the kernels' shared-memory and cluster
// attributes and the cluster occupancy are looked up once per device (and
// kernel, cluster size and shared-memory size) and cached.
//
// Numerics: expf and tanhf (not the fast intrinsics); the dot products sum
// in another order than the plain version does (bf16: k-steps of 16 chained
// in the tensor core's f32 accumulator, then the K parts added in f32).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

#include "bf16_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 8;     // loads each thread keeps in flight while staging
constexpr int MIN_TILE = 32;  // rows of rw in a tile when the slice is read in tiles

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to the nearest bf16
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Four consecutive elements as floats (16 bytes of f32, 8 of bf16, aligned).
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
// four bf16 packed in 8 bytes, as floats
__device__ __forceinline__ float4 unpack4(uint2 v) {
    const unsigned lo = v.x, hi = v.y;
    return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
    return unpack4(*reinterpret_cast<const uint2*>(p));
}

// One step of one unit at K1-bf16's rounding points, given its four gate
// inputs x (IFOG, bf16 values) and its four recurrent sums d (f32): every
// op's result rounded to bf16 as the TPU kernel and lstm_sequence_plain on
// bf16 tensors round it. c is read and written; h is written.
__device__ __forceinline__ void cell_bf16(const float x[4], const float d[4], float& c,
                                          float& h) {
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = round_bf16(x[g] + round_bf16(d[g]));
    const float ig = round_bf16(sigmoidf(z[0]));
    const float fg = round_bf16(sigmoidf(z[1]));
    const float og = round_bf16(sigmoidf(z[2]));
    const float gg = round_bf16(tanhf(z[3]));
    c = round_bf16(round_bf16(fg * c) + round_bf16(ig * gg));
    h = round_bf16(og * round_bf16(tanhf(c)));
}

// Copy rows [0, nr) of src (row length H, contiguous; written by other
// blocks, so read through L2 with ld.cg) into dst (row stride dstride).
// Each thread starts BATCH loads before it stores any, 16 bytes each where
// the rows allow it, so the trip through L2 is paid about once per batch
// rather than once per element.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const float* src,
                                           int nr, int H, int dstride) {
    if ((H & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int q = H >> 2;
        const int total = nr * q;
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
            float4 v[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) v[b] = __ldcg(s4 + i);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) {
                    const int r = i / q, k = (i - r * q) * 4;
                    float* d = dst + r * dstride + k;
                    d[0] = v[b].x;
                    d[1] = v[b].y;
                    d[2] = v[b].z;
                    d[3] = v[b].w;
                }
            }
        }
    } else {
        const int total = nr * H;
        for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
            float v[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) v[b] = __ldcg(src + i);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) {
                    const int r = i / H;
                    dst[r * dstride + i - r * H] = v[b];
                }
            }
        }
    }
}

// The same from bf16 rows (8 bytes, 4 elements, a load where the rows allow
// it), converted to f32.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const bf16* src, int nr,
                                           int H, int dstride) {
    if ((H & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
        const int q = H >> 2;
        const int total = nr * q;
        const uint2* s2 = reinterpret_cast<const uint2*>(src);
        for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
            uint2 v[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) v[b] = __ldcg(s2 + i);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) {
                    const int r = i / q, k = (i - r * q) * 4;
                    const float4 f = unpack4(v[b]);
                    float* d = dst + r * dstride + k;
                    d[0] = f.x;
                    d[1] = f.y;
                    d[2] = f.z;
                    d[3] = f.w;
                }
            }
        }
    } else {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
        const int total = nr * H;
        for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
            unsigned short v[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) v[b] = __ldcg(s16 + i);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int i = base + b * THREADS;
                if (i < total) {
                    const int r = i / H;
                    dst[r * dstride + i - r * H] = __bfloat162float(__ushort_as_bfloat16(v[b]));
                }
            }
        }
    }
}

// Rows [k0, k0 + kn) of this block's slice of rw, as [kn, 4U] ([gate][unit]
// columns; zero for units past H) in shared memory, as f32.
template <typename E>
__device__ __forceinline__ void stage_rw(float* __restrict__ rw_s, const E* __restrict__ rw,
                                         int k0, int kn, int H, int U, int u0, int uc) {
    const int cols = 4 * U;
    const int total = kn * cols;
    const int64_t H4 = 4 * (int64_t)H;
    for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
        float v[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int i = base + b * THREADS;
            if (i < total) {
                const int k = i / cols, j = i - k * cols;
                const int g = j / U, u = j - g * U;
                v[b] = u < uc ? to_f(__ldg(rw + (k0 + k) * H4 + (int64_t)g * H + u0 + u)) : 0.f;
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int i = base + b * THREADS;
            if (i < total) rw_s[i] = v[b];
        }
    }
}

// The block's slice of rw is read in tiles of ktile rows; with ktile == H
// the whole slice stays in shared memory, loaded once, else every tile is
// staged again from L2 at every step. z sums over the tiles in shared
// memory, starting from xw (f32); for bf16 the sums start from 0 and are
// d, which cell_bf16 rounds before it adds xw. Shared memory holds f32 in
// both instantiations; E is the type of the tensors in device memory.
template <typename E>
__global__ void __launch_bounds__(THREADS)
lstm_sequence_kernel(const E* __restrict__ xw, const E* __restrict__ rw,
                     const E* __restrict__ h0, const E* __restrict__ c0,
                     E* ys, E* __restrict__ hn, E* __restrict__ cn,
                     int T, int N, int H, int U, int rows, int hstride, int ktile) {
    constexpr bool BF16 = std::is_same<E, bf16>::value;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float smem[];
    const int u0 = blockIdx.x * U;
    const int uc = min(U, H - u0);  // units this block owns
    const int cols = 4 * U;         // its z columns, [gate][unit]
    const int64_t H4 = 4 * (int64_t)H;
    const bool resident = ktile == H;
    float* rw_s = smem;                                  // [ktile, 4U]
    float* h_s = smem + (int64_t)ktile * cols;           // [rows, hstride]
    float* z_s = h_s + (int64_t)rows * hstride;          // [rows, 4U]

    if (resident) stage_rw(rw_s, rw, 0, H, H, U, u0, uc);

    for (int t = 0; t < T; ++t) {
        const E* h_prev = t == 0 ? h0 : ys + (int64_t)(t - 1) * N * H;
        const E* xw_t = xw + (int64_t)t * N * H4;
        E* y_t = ys + (int64_t)t * N * H;
        for (int r0 = 0; r0 < N; r0 += rows) {
            const int nr = min(rows, N - r0);
            __syncthreads();  // the last chunk's readers of h_s, z_s and rw_s are done
            stage_rows(h_s, h_prev + (int64_t)r0 * H, nr, H, hstride);
            // each thread owns the same outputs o for every tile, so z_s
            // needs no barrier of its own
            for (int o = threadIdx.x; o < nr * cols; o += THREADS) {
                const int r = o / cols, j = o - r * cols;
                const int g = j / U, u = j - g * U;
                if (u < uc) {
                    if constexpr (BF16)
                        z_s[o] = 0.f;
                    else
                        z_s[o] = xw_t[(int64_t)(r0 + r) * H4 + (int64_t)g * H + u0 + u];
                }
            }
            for (int k0 = 0; k0 < H; k0 += ktile) {
                const int kn = min(ktile, H - k0);
                if (!resident) {
                    __syncthreads();  // the last tile's readers of rw_s are done
                    stage_rw(rw_s, rw, k0, kn, H, U, u0, uc);
                }
                __syncthreads();
                for (int o = threadIdx.x; o < nr * cols; o += THREADS) {
                    const int r = o / cols, j = o - r * cols;
                    if (j - (j / U) * U >= uc) continue;
                    const float* hr = h_s + r * hstride + k0;
                    float acc = 0.f;
#pragma unroll 4
                    for (int k = 0; k < kn; ++k) acc = fmaf(hr[k], rw_s[k * cols + j], acc);
                    z_s[o] += acc;
                }
            }
            __syncthreads();
            for (int p = threadIdx.x; p < nr * uc; p += THREADS) {
                const int r = p / uc, u = p - r * uc;
                const float* z = z_s + r * cols;
                const int64_t idx = (int64_t)(r0 + r) * H + u0 + u;
                if constexpr (BF16) {
                    const E* xr = xw_t + (int64_t)(r0 + r) * H4 + u0 + u;
                    float x[4], d[4];
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        x[g] = to_f(xr[(int64_t)g * H]);
                        d[g] = z[g * U + u];
                    }
                    float c = to_f(t == 0 ? c0[idx] : cn[idx]), h;
                    cell_bf16(x, d, c, h);
                    cn[idx] = from_f<E>(c);
                    y_t[idx] = from_f<E>(h);
                    if (t == T - 1) hn[idx] = from_f<E>(h);
                } else {
                    const float ig = sigmoidf(z[u]);
                    const float fg = sigmoidf(z[U + u]);
                    const float og = sigmoidf(z[2 * U + u]);
                    const float gg = tanhf(z[3 * U + u]);
                    const float c = fg * (t == 0 ? c0[idx] : cn[idx]) + ig * gg;
                    const float h = og * tanhf(c);
                    cn[idx] = c;
                    y_t[idx] = h;
                    if (t == T - 1) hn[idx] = h;
                }
            }
        }
        if (t + 1 < T) {
            __threadfence();  // this thread's h_t visible device-wide ...
            grid.sync();      // ... before any block reads ys[t] at step t+1
        }
    }
}

// ----------------------------------------------------------- cluster plan
constexpr int CTHREADS = 512;

__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ unsigned cluster_id() {
    unsigned r;
    asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
    return r;
}
// the address of this CTA's shared-memory word p in CTA `rank` of the cluster
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
    const unsigned local = (unsigned)__cvta_generic_to_shared(p);
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(unsigned addr, bf16 v) {
    asm volatile("st.shared::cluster.b16 [%0], %1;\n" ::"r"(addr), "h"(__bfloat16_as_ushort(v))
                 : "memory");
}
// 4 bytes: one f32, or two bf16
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// every group this thread committed but the last one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int CWARPS = CTHREADS / 32;

// The shared-memory layout of one CTA of the cluster plan, in bytes, for
// rw, h and xw elements of E bytes (4: f32, 2: bf16). The same arithmetic
// is lstm_plan's in nn/cuda_kernels.py (_cluster_bytes); the launcher
// refuses a plan whose byte count disagrees.
//
// f32 (CUDA-core products): rw [hs][cols], h buffers [rp][hs], the P
// slices' partial sums [P][rp][cols].
//
// bf16 (tensor-core products, d^T = rw_slice^T h^T: M the CTA's gate
// columns, N the batch rows, K = H): rw [kp][rs], its columns padded to mp
// (a multiple of 16) and its rows to kp (H up to a multiple of 16), zero
// past H, past uc and past 4U, each row skewed by 8 bf16 so that ldmatrix
// reads it without bank conflicts; h buffers [np][kp + 8], rows padded to
// np (R up to a multiple of 8, n-tiles of 8), zero past H and past R;
// the ksplit partial sums of the K parts [ksplit][np][mp + 4] f32. mt
// m-tiles of 16 columns, kt k-steps of 16; warp w < mt ksplit computes
// m-tile w % mt over k-steps [kc (w / mt), kc (w / mt + 1)).
struct ClusterLayout {
    int U, cols, hs, rp, P, ks;          // f32
    int mp, kp, np, rs, zs, mt, kt, ksplit, kc;  // bf16
    int hrows, hstride;                  // the h buffers: rows, row stride (elements)
    int rw, hbuf, zpart, xw, c, hst, total;  // offsets (bytes) and the size
    __host__ __device__ ClusterLayout(int H, int S, int R, int RB, int E) {
        U = (H + S - 1) / S;
        if (E == 2) U = (U + 1) & ~1;      // bf16: units in pairs (4-byte copies)
        cols = 4 * U;
        hs = (H + 3) & ~3;                 // h rows padded for 4-element loads
        rp = (R + RB - 1) / RB * RB;       // rows padded to the register block
        P = cols >= CTHREADS ? 1 : CTHREADS / cols;  // slices of the H products
        ks = ((hs + P - 1) / P + 3) & ~3;  // rows of rw a slice, a multiple of 4
        mp = (cols + 15) & ~15;
        kp = (H + 15) & ~15;
        np = (R + 7) & ~7;
        rs = mp + 8;
        zs = mp + 4;                       // C fragments stored without bank conflicts
        mt = mp / 16;
        kt = kp / 16;
        ksplit = mt >= CWARPS ? 1 : CWARPS / mt;
        kc = (kt + ksplit - 1) / ksplit;
        rw = 0;
        if (E == 2) {
            hrows = np;
            hstride = kp + 8;
            hbuf = rw + kp * rs * E;              // [kp][rs] bf16
            zpart = hbuf + 2 * np * hstride * E;  // 2 x [np][kp + 8] bf16
            xw = zpart + ksplit * np * zs * 4;    // [ksplit][np][zs] f32
        } else {
            hrows = rp;
            hstride = hs;
            hbuf = rw + hs * cols * E;         // [hs][cols] E, zero past H and uc
            zpart = hbuf + 2 * rp * hs * E;    // 2 x [rp][hs] E
            xw = zpart + P * rp * cols * 4;    // [P][rp][cols] f32
        }
        c = xw + 2 * R * cols * E;         // 2 x [R][cols] E
        hst = c + R * U * 4;               // [R][U] f32
        total = hst + R * U * 4;           // [R][U] f32, h_t on its way to ys
    }
};

__host__ __device__ inline int row_block(int R) { return R < 4 ? R : 4; }

// bf16 step, products: zpart[p][n][m] = sum over K part p of
// h_{t-1}[n][k] rw[k][m], for every m-tile and K part (bf16 mma.sync
// m16n8k16, f32 sums: k-steps of 16 chained in the accumulator). Each
// k-step reads its A fragment of the resident rw slice (ldmatrix.trans)
// and its B fragments of h (ldmatrix).
__device__ __forceinline__ void products_bf16(const ClusterLayout& L, const bf16* rw_s,
                                              const bf16* hb, float* zpart, int warp,
                                              int lane) {
    const int q = lane >> 3, g = lane >> 2, t = lane & 3;
    for (int it = warp; it < L.mt * L.ksplit; it += CWARPS) {
        const int mtile = it % L.mt, part = it / L.mt;
        const int kb = part * L.kc, ke = min(L.kt, kb + L.kc);
        // A: matrices (k lo, m lo), (k lo, m hi), (k hi, m lo), (k hi, m hi)
        const bf16* a_lane = rw_s + ((q >> 1) * 8 + (lane & 7)) * L.rs + mtile * 16 + (q & 1) * 8;
        for (int nt = 0; nt < L.np / 8; nt += 2) {
            // B: matrices (n-tile nt, k lo), (nt, k hi), (nt + 1, k lo), (nt + 1,
            // k hi); the last n-tile of an odd count alone (x2: lanes 0-15)
            const bool two = nt + 1 < L.np / 8;
            const bf16* b_lane = hb + (nt * 8 + (q >> 1) * 8 + (lane & 7)) * L.hstride + (q & 1) * 8;
            float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
            for (int kk = kb; kk < ke; ++kk) {
                unsigned a[4], b[4];
                dl4j_bf16::ldmatrix_x4_trans(a, a_lane + kk * 16 * L.rs);
                if (two) {
                    dl4j_bf16::ldmatrix_x4(b, b_lane + kk * 16);
                    dl4j_bf16::mma_bf16(acc1, a, b[2], b[3]);
                } else {
                    dl4j_bf16::ldmatrix_x2(b, b_lane + kk * 16);
                }
                dl4j_bf16::mma_bf16(acc0, a, b[0], b[1]);
            }
            // C fragments: (m = g, n = 2t, 2t + 1), (m = g + 8, the same n)
            float* zp = zpart + (part * L.np + nt * 8 + 2 * t) * L.zs + mtile * 16 + g;
            zp[0] = acc0[0];
            zp[L.zs] = acc0[1];
            zp[8] = acc0[2];
            zp[L.zs + 8] = acc0[3];
            if (two) {
                zp += 8 * L.zs;
                zp[0] = acc1[0];
                zp[L.zs] = acc1[1];
                zp[8] = acc1[2];
                zp[L.zs + 8] = acc1[3];
            }
        }
    }
}

// One cluster per slice of R batch rows; RB rows of a register block; E the
// storage type. `pairs` (bf16): H is even and xw, rw are 4-byte aligned, so
// two units' columns copy as one 4-byte cp.async; else one element at a time.
template <int RB, typename E>
__global__ void __launch_bounds__(CTHREADS, 1)
lstm_sequence_cluster_kernel(const E* __restrict__ xw, const E* __restrict__ rw,
                             const E* __restrict__ h0, const E* __restrict__ c0,
                             E* __restrict__ ys, E* __restrict__ hn,
                             E* __restrict__ cn, int T, int N, int H, int S, int R,
                             int pairs) {
    constexpr bool BF16 = std::is_same<E, bf16>::value;
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    const ClusterLayout L(H, S, R, RB, (int)sizeof(E));
    const int U = L.U, cols = L.cols, hs = L.hs, rp = L.rp;
    const int hrows = L.hrows, hstride = L.hstride;
    E* rw_s = reinterpret_cast<E*>(smem + L.rw);
    E* hbuf = reinterpret_cast<E*>(smem + L.hbuf);
    float* zpart = reinterpret_cast<float*>(smem + L.zpart);
    E* xw_s = reinterpret_cast<E*>(smem + L.xw);
    float* c_s = reinterpret_cast<float*>(smem + L.c);
    float* h_s = reinterpret_cast<float*>(smem + L.hst);
    const int rank = (int)cluster_rank();
    const int row0 = (int)cluster_id() * R;
    const int u0 = rank * U;
    const int uc = max(0, min(U, H - u0));  // units this CTA owns
    const int tid = threadIdx.x;
    const int64_t H4 = 4 * (int64_t)H;

    // prologue: the slice of rw (every copy in flight at once: at T = 1
    // this is most of the kernel; a lane's columns are fixed, so it divides
    // once a column, not once an element), h0 into buffer 0, c0, xw_0
    const E zero = from_f<E>(0.f);
    if constexpr (BF16) {
        // [kp][rs]: two columns (units u, u + 1 of one gate: U is even) a
        // copy; zeros past H, uc and 4U (the tensor cores' padding)
        for (int j = 2 * (tid % 32); j < L.mp; j += 64) {
            const int g = j / U, u = j - g * U;
            const bool col = j < cols;
            const E* src = rw + (int64_t)(col ? g : 0) * H + u0 + u;
            for (int k = tid / 32; k < L.kp; k += CWARPS) {
                E* dst = rw_s + k * L.rs + j;
                if (col && pairs && k < H && u + 1 < uc) {
                    cp_async4(dst, src + k * H4);
                } else {
                    dst[0] = (col && k < H && u < uc) ? src[k * H4] : zero;
                    dst[1] = (col && k < H && u + 1 < uc) ? src[k * H4 + 1] : zero;
                }
            }
        }
    } else {
        for (int j = tid % 32; j < cols; j += 32) {
            const int g = j / U, u = j - g * U;
            const float* src = rw + (int64_t)g * H + u0 + u;
            for (int k = tid / 32; k < hs; k += CTHREADS / 32) {
                if (k < H && u < uc)
                    cp_async4(rw_s + k * cols + j, src + k * H4);
                else
                    rw_s[k * cols + j] = 0.f;
            }
        }
    }
    for (int i = tid; i < 2 * hrows * hstride; i += CTHREADS) {
        const int b = i / (hrows * hstride), rem = i - b * hrows * hstride;
        const int r = rem / hstride, k = rem - r * hstride;
        const int n = row0 + r;
        hbuf[i] = (b == 0 && r < R && n < N && k < H) ? h0[(int64_t)n * H + k] : zero;
    }
    for (int i = tid; i < R * U; i += CTHREADS) {
        const int r = i / U, u = i - r * U;
        const int n = row0 + r;
        c_s[i] = (u < uc && n < N) ? to_f(c0[(int64_t)n * H + u0 + u]) : 0.f;
    }
    // xw_t's rows and columns -> xw_s[t & 1], one commit group (empty
    // past the last step, so that the group count stays one a step)
    auto prefetch_xw = [&](int t) {
        E* dst = xw_s + (t & 1) * R * cols;
        const E* src = xw + (int64_t)t * N * H4;
        if constexpr (BF16) {
            for (int e = 2 * tid; t < T && e < R * cols; e += 2 * CTHREADS) {
                const int r = e / cols, j = e - r * cols;
                const int g = j / U, u = j - g * U;
                const int n = row0 + r;
                if (u < uc && n < N) {
                    const E* s = src + n * H4 + (int64_t)g * H + u0 + u;
                    if (pairs) {
                        cp_async4(dst + e, s);
                    } else {
                        dst[e] = s[0];
                        if (u + 1 < uc) dst[e + 1] = s[1];
                    }
                }
            }
        } else {
            for (int e = tid; t < T && e < R * cols; e += CTHREADS) {
                const int r = e / cols, j = e - r * cols;
                const int g = j / U, u = j - g * U;
                const int n = row0 + r;
                if (u < uc && n < N) cp_async4(dst + e, src + n * H4 + (int64_t)g * H + u0 + u);
            }
        }
        cp_async_commit();
    };
    prefetch_xw(0);
    cp_async_wait_all();  // this thread's copies of rw and xw_0
    // every CTA of the cluster has started (its shared memory exists) before
    // anyone writes into it; the barrier also publishes rw_s to the CTA
    cluster_arrive_release();
    cluster_wait_acquire();

#ifdef DL4J_LSTM_SPLIT_NO_PRODUCTS
    for (int i = tid; BF16 && i < L.ksplit * L.np * L.zs; i += CTHREADS) zpart[i] = 0.f;
    __syncthreads();
#endif

    for (int t = 0; t < T; ++t) {
        const E* hb = hbuf + (t & 1) * hrows * hstride;  // h_{t-1}
        // xw_{t+1} does not depend on h: its copy has the whole step to land
        // (its buffer was last read in step t - 1, before the last barrier)
        prefetch_xw(t + 1);
        // 1. bf16: zpart[p][n][m] on the tensor cores; f32: zpart[p][r][j]
        //    = sum over slice p of h_{t-1}[r][k] rw[k][j]
#ifndef DL4J_LSTM_SPLIT_NO_PRODUCTS
        if constexpr (BF16) products_bf16(L, rw_s, hb, zpart, tid >> 5, tid & 31);
#endif
        for (int item = tid; !BF16 && item < cols * L.P; item += CTHREADS) {
            const int j = item % cols, p = item / cols;
            const int k_begin = p * L.ks, k_end = min(hs, k_begin + L.ks);
            for (int rb = 0; rb < rp; rb += RB) {
                float acc[RB];
#pragma unroll
                for (int q = 0; q < RB; ++q) acc[q] = 0.f;
                const E* hrow = hb + rb * hs;
                for (int k = k_begin; k < k_end; k += 4) {
                    const float w0 = to_f(rw_s[(k + 0) * cols + j]);
                    const float w1 = to_f(rw_s[(k + 1) * cols + j]);
                    const float w2 = to_f(rw_s[(k + 2) * cols + j]);
                    const float w3 = to_f(rw_s[(k + 3) * cols + j]);
#pragma unroll
                    for (int q = 0; q < RB; ++q) {
                        const float4 hv = load4(hrow + q * hs + k);
                        acc[q] = fmaf(hv.x, w0, acc[q]);
                        acc[q] = fmaf(hv.y, w1, acc[q]);
                        acc[q] = fmaf(hv.z, w2, acc[q]);
                        acc[q] = fmaf(hv.w, w3, acc[q]);
                    }
                }
#pragma unroll
                for (int q = 0; q < RB; ++q) zpart[(p * rp + rb + q) * cols + j] = acc[q];
            }
        }
        cp_async_wait_prior();  // this thread's copies of xw_t (not xw_{t+1})
        __syncthreads();        // zpart and xw_t from every thread
        // 2. the cell for (row r, unit u); h_t to ys and to every CTA's
        //    buffer (t + 1) & 1
        const E* xt = xw_s + (t & 1) * R * cols;
        E* hnext = hbuf + ((t + 1) & 1) * hrows * hstride;
        for (int it = tid; it < R * U; it += CTHREADS) {
            const int r = it / U, u = it - r * U;
            const int n = row0 + r;
            if (u >= uc || n >= N) continue;
            const E* slot = hnext + r * hstride + u0 + u;
            if constexpr (BF16) {
                // d summed over the slices in f32, then the cell's roundings
                float x[4], d[4];
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    x[g] = to_f(xt[r * cols + g * U + u]);
                    d[g] = 0.f;
                }
                for (int p = 0; p < L.ksplit; ++p) {
                    const float* zp = zpart + (p * L.np + r) * L.zs + u;
#pragma unroll
                    for (int g = 0; g < 4; ++g) d[g] += zp[g * U];
                }
                float c = c_s[it], h;
#ifndef DL4J_LSTM_SPLIT_NO_CELL
                cell_bf16(x, d, c, h);
#else
                c = round_bf16(c + x[0] + d[0] + x[1] + d[1]);
                h = round_bf16(x[2] + d[2] + x[3] + d[3] + 0.5f * c);
#endif
                c_s[it] = c;
                h_s[it] = h;
                const E hv = from_f<E>(h);
                for (int peer = 0; peer < S; ++peer) st_cluster(peer_addr(slot, peer), hv);
            } else {
                // four independent sums (one a gate), so their loads overlap
                float z[4];
#pragma unroll
                for (int g = 0; g < 4; ++g) z[g] = xt[r * cols + g * U + u];
                for (int p = 0; p < L.P; ++p) {
                    const float* zp = zpart + (p * rp + r) * cols + u;
#pragma unroll
                    for (int g = 0; g < 4; ++g) z[g] += zp[g * U];
                }
                const float ig = sigmoidf(z[0]);
                const float fg = sigmoidf(z[1]);
                const float og = sigmoidf(z[2]);
                const float gg = tanhf(z[3]);
                const float c = fg * c_s[it] + ig * gg;
                const float h = og * tanhf(c);
                c_s[it] = c;
                h_s[it] = h;
                for (int peer = 0; peer < S; ++peer) st_cluster(peer_addr(slot, peer), h);
            }
        }
        // 3. one cluster barrier. Its release waits until this thread's
        //    earlier stores are visible to the cluster: the peers' h, and
        //    the global stores of ys[t - 1] made a whole step ago, not ys[t]
        cluster_arrive_release();
        cluster_wait_acquire();
        // 4. ys[t] from the same thread that computed it
        for (int it = tid; it < R * U; it += CTHREADS) {
            const int r = it / U, u = it - r * U;
            const int n = row0 + r;
            if (u < uc && n < N) ys[((int64_t)t * N + n) * H + u0 + u] = from_f<E>(h_s[it]);
        }
    }
    for (int it = tid; it < R * U; it += CTHREADS) {
        const int r = it / U, u = it - r * U;
        const int n = row0 + r;
        if (u < uc && n < N) {
            hn[(int64_t)n * H + u0 + u] = from_f<E>(h_s[it]);
            cn[(int64_t)n * H + u0 + u] = from_f<E>(c_s[it]);
        }
    }
}

// The chain floor: T steps of the cluster plan's hand-over alone, on its
// geometry and shared memory: each (row, unit) owner reads one entry of its
// h buffer, writes a value to every CTA's other buffer, and the cluster
// meets at its barrier. No products, no cell. out [N, H] gets the last
// values, so nothing is optimised away. E: the plan's storage type (its
// h buffers and their hand-over).
template <typename E>
__global__ void __launch_bounds__(CTHREADS, 1)
lstm_chain_floor_kernel(float* __restrict__ out, int T, int N, int H, int S, int R) {
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    const ClusterLayout L(H, S, R, row_block(R), (int)sizeof(E));
    const int U = L.U, hrows = L.hrows, hstride = L.hstride;
    E* hbuf = reinterpret_cast<E*>(smem + L.hbuf);
    const int rank = (int)cluster_rank();
    const int row0 = (int)cluster_id() * R;
    const int u0 = rank * U;
    const int uc = max(0, min(U, H - u0));
    for (int i = threadIdx.x; i < 2 * hrows * hstride; i += CTHREADS) hbuf[i] = from_f<E>(0.f);
    cluster_arrive_release();
    cluster_wait_acquire();
    float last = 0.f;
    for (int t = 0; t < T; ++t) {
        const E* hb = hbuf + (t & 1) * hrows * hstride;
        E* hnext = hbuf + ((t + 1) & 1) * hrows * hstride;
        for (int it = threadIdx.x; it < R * U; it += CTHREADS) {
            const int r = it / U, u = it - r * U;
            if (u >= uc || row0 + r >= N) continue;
            last = to_f(hb[r * hstride + (u0 + u + 1) % H]) + 1.f;
            const E* slot = hnext + r * hstride + u0 + u;
            for (int peer = 0; peer < S; ++peer)
                st_cluster(peer_addr(slot, peer), from_f<E>(last));
        }
        cluster_arrive_release();
        cluster_wait_acquire();
    }
    for (int it = threadIdx.x; it < R * U; it += CTHREADS) {
        const int r = it / U, u = it - r * U;
        if (u < uc && row0 + r < N) out[(int64_t)(row0 + r) * H + u0 + u] = last;
    }
}

// ------------------------------------------------------------- host side
struct DeviceLimits {
    int sms = 0, smem_optin = 0, coop = 0, major = 0;
};

std::mutex cache_mu;
std::vector<DeviceLimits> limits_cache;                 // by device
std::vector<std::pair<int, const void*>> attrs_set;     // (device, kernel) prepared
struct Occupancy { int dev; const void* kernel; int S, smem, clusters; };
std::vector<Occupancy> occupancy_cache;

cudaError_t device_limits(DeviceLimits& out, int& dev) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(cache_mu);
    if ((int)limits_cache.size() > dev && limits_cache[dev].sms > 0) {
        out = limits_cache[dev];
        return cudaSuccess;
    }
    DeviceLimits d;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&d.major, cudaDevAttrComputeCapabilityMajor, dev);
    if (err != cudaSuccess) return err;
    if ((int)limits_cache.size() <= dev) limits_cache.resize(dev + 1);
    limits_cache[dev] = d;
    out = d;
    return cudaSuccess;
}

// Once per (device, kernel): allow the device's whole opt-in shared memory
// and, for a cluster kernel, clusters of 16 (a non-portable size).
cudaError_t prepare(const void* kernel, int dev, int smem_optin, bool cluster) {
    std::lock_guard<std::mutex> lock(cache_mu);
    for (const auto& e : attrs_set)
        if (e.first == dev && e.second == kernel) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_optin);
    if (err == cudaSuccess && cluster)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) attrs_set.emplace_back(dev, kernel);
    return err;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int C, int S, int smem,
                                  cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * S);
    cfg.blockDim = dim3(CTHREADS);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The instantiation for a plan's register block and storage type.
template <typename E>
const void* cluster_kernel(int R) {
    // bf16 has no register block of rows (its products are mma tiles)
    if constexpr (std::is_same<E, bf16>::value) {
        return (const void*)lstm_sequence_cluster_kernel<1, E>;
    } else {
        switch (row_block(R)) {
            case 1: return (const void*)lstm_sequence_cluster_kernel<1, E>;
            case 2: return (const void*)lstm_sequence_cluster_kernel<2, E>;
            case 3: return (const void*)lstm_sequence_cluster_kernel<3, E>;
            default: return (const void*)lstm_sequence_cluster_kernel<4, E>;
        }
    }
}

bool bad_plan(int H, int S, int R) { return H <= 0 || S < 1 || S > 16 || R < 1; }

// Checks a cluster plan and prepares `kernel` for it: S in 1..16, the
// shared-memory bytes at least those of ClusterLayout for elements of
// `esize` bytes, within the device's limit, and at least one such cluster
// schedulable (cudaOccupancyMaxActiveClusters, cached). Writes the number
// of clusters that can be resident at once.
cudaError_t check_cluster(const void* kernel, int H, int S, int R, int smem, int esize,
                          cudaStream_t stream, int* clusters) {
    if (bad_plan(H, S, R)) return cudaErrorInvalidValue;
    const ClusterLayout L(H, S, R, row_block(R), esize);
    if ((int64_t)L.total > smem) return cudaErrorInvalidValue;
    DeviceLimits d;
    int dev = 0;
    cudaError_t err = device_limits(d, dev);
    if (err != cudaSuccess) return err;
    if (smem > d.smem_optin) return cudaErrorInvalidValue;
    err = prepare(kernel, dev, d.smem_optin, true);
    if (err != cudaSuccess) return err;
    {
        std::lock_guard<std::mutex> lock(cache_mu);
        for (const auto& o : occupancy_cache)
            if (o.dev == dev && o.kernel == kernel && o.S == S && o.smem == smem) {
                *clusters = o.clusters;
                return o.clusters > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
            }
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(attr, 1, S, smem, stream);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return err;
    }
    std::lock_guard<std::mutex> lock(cache_mu);
    occupancy_cache.push_back({dev, kernel, S, smem, n});
    *clusters = n;
    return n > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The grid plan's launch (see dl4j_lstm_sequence_f32).
template <typename E>
int launch_grid(const void* xw, const void* rw, const void* h0, const void* c0, void* ys,
                void* hn, void* cn, int T, int N, int H, int units, void* stream) {
    if (T <= 0 || N <= 0 || H <= 0 || units < 0) return (int)cudaErrorInvalidValue;
    DeviceLimits d;
    int dev = 0;
    cudaError_t err = device_limits(d, dev);
    if (err != cudaSuccess) return (int)err;
    if (!d.coop) return (int)cudaErrorNotSupported;
    const int sms = d.sms;
    const int smem_max = d.smem_optin;

    const int U = units > 0 ? units : (H + sms - 1) / sms;
    const int blocks = (H + U - 1) / U;
    const int cols = 4 * U;
    const int hstride = H | 1;  // odd row stride: rows of h_s start in distinct banks
    const int64_t rw_row = (int64_t)cols * 4;  // bytes of one row of the slice
    const int64_t row_bytes = ((int64_t)hstride + cols) * 4;  // one row of h and z
    // the whole slice in shared memory when it fits beside min(N, 8) rows of
    // h; else tiles of at least MIN_TILE rows (or H) beside as many rows as fit
    const bool rw_whole = rw_row * H + row_bytes * (N < 8 ? N : 8) <= smem_max;
    const int64_t min_tile = rw_row * (H < MIN_TILE ? H : MIN_TILE);
    const int64_t fit = (smem_max - (rw_whole ? rw_row * H : min_tile)) / row_bytes;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    int rows = (int)(fit < N ? fit : N);
    int ktile = H;
    if (!rw_whole) {
        const int64_t k = (smem_max - row_bytes * rows) / rw_row;
        ktile = (int)(k < H ? k : H);
    }
    const size_t smem = (size_t)(rw_row * ktile + row_bytes * rows);

    const void* kernel = (const void*)lstm_sequence_kernel<E>;
    err = prepare(kernel, dev, smem_max, false);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&xw, (void*)&rw, (void*)&h0, (void*)&c0, (void*)&ys, (void*)&hn,
                    (void*)&cn, (void*)&T, (void*)&N, (void*)&H, (void*)&U, (void*)&rows,
                    (void*)&hstride, (void*)&ktile};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) {
        (void)cudaGetLastError();  // a refused launch leaves no sticky error behind
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// The cluster plan's launch (see dl4j_lstm_sequence_cluster_f32).
template <typename E>
int launch_cluster(const void* xw, const void* rw, const void* h0, const void* c0, void* ys,
                   void* hn, void* cn, int T, int N, int H, int S, int R, int smem,
                   void* stream) {
    if (T <= 0 || N <= 0 || bad_plan(H, S, R)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* kernel = cluster_kernel<E>(R);
    int resident = 0;
    cudaError_t err = check_cluster(kernel, H, S, R, smem, (int)sizeof(E), s, &resident);
    if (err != cudaSuccess) return (int)err;
    // bf16: two units' columns a 4-byte copy where H is even and both
    // sources are 4-byte aligned
    int pairs = (H % 2 == 0 && (reinterpret_cast<uintptr_t>(xw) & 3) == 0 &&
                 (reinterpret_cast<uintptr_t>(rw) & 3) == 0) ? 1 : 0;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, (N + R - 1) / R, S, smem, s);
    void* args[] = {(void*)&xw, (void*)&rw, (void*)&h0, (void*)&c0, (void*)&ys, (void*)&hn,
                    (void*)&cn, (void*)&T, (void*)&N, (void*)&H, (void*)&S, (void*)&R,
                    (void*)&pairs};
    err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

template <typename E>
int launch_chain_floor(void* out, int T, int N, int H, int S, int R, int smem, void* stream) {
    if (T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* kernel = (const void*)lstm_chain_floor_kernel<E>;
    int resident = 0;
    cudaError_t err = check_cluster(kernel, H, S, R, smem, (int)sizeof(E), s, &resident);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, (N + R - 1) / R, S, smem, s);
    err = cudaLaunchKernelEx(&cfg, lstm_chain_floor_kernel<E>, static_cast<float*>(out), T, N,
                             H, S, R);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The current device's SMs, opt-in shared memory a block and largest
// cluster (16 where the non-portable size exists: compute capability 9+).
extern "C" int dl4j_lstm_device_limits(int* sms, int* smem_optin, int* max_cluster) {
    DeviceLimits d;
    int dev = 0;
    const cudaError_t err = device_limits(d, dev);
    if (err != cudaSuccess) return (int)err;
    *sms = d.sms;
    *smem_optin = d.smem_optin;
    *max_cluster = d.major >= 9 ? 16 : 8;
    return 0;
}

// How many clusters of the cluster plan (S CTAs of `smem` bytes for R rows
// at width H, elements of `esize` bytes: 4 for the f32 kernel, 2 for the
// bf16 one) can be resident at once; 0 with cudaErrorInvalidConfiguration
// when none can.
extern "C" int dl4j_lstm_cluster_occupancy(int H, int S, int R, int smem, int esize,
                                           int* clusters) {
    *clusters = 0;
    if (bad_plan(H, S, R) || (esize != 4 && esize != 2)) return (int)cudaErrorInvalidValue;
    const void* kernel = esize == 4 ? cluster_kernel<float>(R) : cluster_kernel<bf16>(R);
    return (int)check_cluster(kernel, H, S, R, smem, esize, 0, clusters);
}

// xw [T, N, 4H], rw [H, 4H], h0, c0 [N, H]: contiguous f32 on the current
// device; ys [T, N, H], hn, cn [N, H] are written. The grid plan. units:
// hidden units per block, 0 for the default (spread over the SMs).
// T, N, H >= 1. Returns a cudaError_t (0 = launched;
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at
// once; cudaErrorInvalidConfiguration when one row of h does not fit in
// shared memory).
extern "C" int dl4j_lstm_sequence_f32(const void* xw, const void* rw,
                                      const void* h0, const void* c0,
                                      void* ys, void* hn, void* cn,
                                      int T, int N, int H, int units,
                                      void* stream) {
    return launch_grid<float>(xw, rw, h0, c0, ys, hn, cn, T, N, H, units, stream);
}

// K1-bf16's grid plan: the same contract on bf16 tensors.
extern "C" int dl4j_lstm_sequence_bf16(const void* xw, const void* rw,
                                       const void* h0, const void* c0,
                                       void* ys, void* hn, void* cn,
                                       int T, int N, int H, int units,
                                       void* stream) {
    return launch_grid<bf16>(xw, rw, h0, c0, ys, hn, cn, T, N, H, units, stream);
}

// The cluster plan: the same contract as dl4j_lstm_sequence_f32, with the
// plan of nn/cuda_kernels.py lstm_plan: S CTAs a cluster, R batch rows a
// cluster, ceil(N / R) clusters, `smem` bytes of shared memory a CTA (as
// ClusterLayout counts them). Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for a plan the layout disagrees with;
// cudaErrorInvalidConfiguration when no such cluster can be scheduled).
extern "C" int dl4j_lstm_sequence_cluster_f32(const void* xw, const void* rw,
                                              const void* h0, const void* c0,
                                              void* ys, void* hn, void* cn,
                                              int T, int N, int H, int S, int R,
                                              int smem, void* stream) {
    return launch_cluster<float>(xw, rw, h0, c0, ys, hn, cn, T, N, H, S, R, smem, stream);
}

// K1-bf16's cluster plan: the same contract on bf16 tensors, with a plan
// sized for 2-byte elements.
extern "C" int dl4j_lstm_sequence_cluster_bf16(const void* xw, const void* rw,
                                               const void* h0, const void* c0,
                                               void* ys, void* hn, void* cn,
                                               int T, int N, int H, int S, int R,
                                               int smem, void* stream) {
    return launch_cluster<bf16>(xw, rw, h0, c0, ys, hn, cn, T, N, H, S, R, smem, stream);
}

// The chain floor of a cluster plan (same S, R, smem; out [N, H] f32):
// T steps of the hand-over of h and the cluster barrier, nothing else.
extern "C" int dl4j_lstm_chain_floor_f32(void* out, int T, int N, int H, int S, int R,
                                         int smem, void* stream) {
    return launch_chain_floor<float>(out, T, N, H, S, R, smem, stream);
}

// The same for a bf16 plan (bf16 h buffers, 2-byte hand-over).
extern "C" int dl4j_lstm_chain_floor_bf16(void* out, int T, int N, int H, int S, int R,
                                          int smem, void* stream) {
    return launch_chain_floor<bf16>(out, T, N, H, S, R, smem, stream);
}
