// Fused LSTM sequence forward (K1), f32, for Hopper (sm_90a).
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
// Design for this card. The TPU kernel walks a sequential grid over T with h
// and c in VMEM scratch. Here blocks run in parallel and in no order, and
// rw is 640 KB at H = 200, more than one SM's 227 KB of shared memory. So
// one persistent kernel is launched cooperatively (every block resident at
// once) and loops over T itself:
//
// - block b owns hidden units [b U, b U + U) with all four of their gates,
//   i.e. the 4U columns {g H + u} of rw; U is chosen so that the blocks
//   cover at most one SM each (U = ceil(H / SMs): 100 blocks at H = 200).
//   Its slice of rw [H, 4U] is copied into shared memory once when it fits
//   beside the staged h, and read through L2 every step when it does not
//   (H = 1500: 125 slices of 288 KB), in tiles of rows staged into shared
//   memory, with z summed tile by tile;
// - at step t every block reads the whole h_{t-1} from L2 (ld.cg: other
//   blocks wrote it) into shared memory, each thread with 8 loads of 16
//   bytes in flight (a trip through L2 costs far more than the copy), then
//   computes z for its columns, applies the cell to its units and writes its
//   slice of h_t into ys[t]. ys[t-1] is h_{t-1}, so no separate double
//   buffer is needed. Rows of the batch are taken in chunks when all of h
//   does not fit in shared memory;
// - c never leaves its owner: the thread that owns (n, u) reads c_{t-1} from
//   cN (c0 at t = 0) and writes c_t back, in the same order every step;
// - one grid barrier (a __threadfence, then cooperative_groups' grid sync)
//   separates step t's writes of h_t from step t+1's reads.
//
// Bound. At the training chunk [T, N, H] = [50, 32, 200] the recurrent
// products are 2 T N H 4H = 512 MFLOP: 7.6 us at the H100 SXM's 67 TFLOP/s
// (f32, CUDA cores). The bytes it must move (xw, rw, h0, c0 in; ys, hN, cN
// out) are 7.1 MB: 2.1 us at 3.35 TB/s. The real limit is the dependency
// chain: T grid barriers and T trips of h through L2, a few microseconds
// each, which no amount of parallelism inside a step removes.
//
// Numerics: expf and tanhf (not the fast intrinsics); the dot products sum
// in another order than the plain version does.
//
// A grid that cannot be resident at once is refused by
// cudaLaunchCooperativeKernel (cudaErrorCooperativeLaunchTooLarge), which
// is returned to the caller: the kernel never waits on a block that cannot
// run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = 8;     // loads each thread keeps in flight while staging
constexpr int MIN_TILE = 32;  // rows of rw in a tile when the slice is read in tiles

__device__ __forceinline__ float sigmoidf(float x) {
    return 1.f / (1.f + expf(-x));
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

// Rows [k0, k0 + kn) of this block's slice of rw, as [kn, 4U] ([gate][unit]
// columns; zero for units past H) in shared memory.
__device__ __forceinline__ void stage_rw(float* __restrict__ rw_s, const float* __restrict__ rw,
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
                v[b] = u < uc ? __ldg(rw + (k0 + k) * H4 + (int64_t)g * H + u0 + u) : 0.f;
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
// memory, starting from xw.
__global__ void __launch_bounds__(THREADS)
lstm_sequence_kernel(const float* __restrict__ xw, const float* __restrict__ rw,
                     const float* __restrict__ h0, const float* __restrict__ c0,
                     float* ys, float* __restrict__ hn, float* __restrict__ cn,
                     int T, int N, int H, int U, int rows, int hstride, int ktile) {
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
        const float* h_prev = t == 0 ? h0 : ys + (int64_t)(t - 1) * N * H;
        const float* xw_t = xw + (int64_t)t * N * H4;
        float* y_t = ys + (int64_t)t * N * H;
        for (int r0 = 0; r0 < N; r0 += rows) {
            const int nr = min(rows, N - r0);
            __syncthreads();  // the last chunk's readers of h_s, z_s and rw_s are done
            stage_rows(h_s, h_prev + (int64_t)r0 * H, nr, H, hstride);
            // each thread owns the same outputs o for every tile, so z_s
            // needs no barrier of its own
            for (int o = threadIdx.x; o < nr * cols; o += THREADS) {
                const int r = o / cols, j = o - r * cols;
                const int g = j / U, u = j - g * U;
                if (u < uc) z_s[o] = xw_t[(int64_t)(r0 + r) * H4 + (int64_t)g * H + u0 + u];
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
                const float ig = sigmoidf(z[u]);
                const float fg = sigmoidf(z[U + u]);
                const float og = sigmoidf(z[2 * U + u]);
                const float gg = tanhf(z[3 * U + u]);
                const int64_t idx = (int64_t)(r0 + r) * H + u0 + u;
                const float c = fg * (t == 0 ? c0[idx] : cn[idx]) + ig * gg;
                const float h = og * tanhf(c);
                cn[idx] = c;
                y_t[idx] = h;
                if (t == T - 1) hn[idx] = h;
            }
        }
        if (t + 1 < T) {
            __threadfence();  // this thread's h_t visible device-wide ...
            grid.sync();      // ... before any block reads ys[t] at step t+1
        }
    }
}

}  // namespace

// xw [T, N, 4H], rw [H, 4H], h0, c0 [N, H]: contiguous f32 on the current
// device; ys [T, N, H], hn, cn [N, H] are written. units: hidden units per
// block, 0 for the default (spread over the SMs). T, N, H >= 1. Returns a
// cudaError_t (0 = launched; cudaErrorCooperativeLaunchTooLarge when the
// grid cannot be resident at once; cudaErrorInvalidConfiguration when one
// row of h does not fit in shared memory).
extern "C" int dl4j_lstm_sequence_f32(const void* xw, const void* rw,
                                      const void* h0, const void* c0,
                                      void* ys, void* hn, void* cn,
                                      int T, int N, int H, int units,
                                      void* stream) {
    if (T <= 0 || N <= 0 || H <= 0 || units < 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, smem_max = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;

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

    const void* kernel = (const void*)lstm_sequence_kernel;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
