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
// The products stay on the CUDA cores: at the main paths' shapes a CTA
// holds R = 1 or 2 rows, and a 16-row tensor-core fragment would be 1/8 or
// 1/16 full; each step's 2 R H 4U multiply-adds are short, and the step's
// latency is set by the barrier and the hand-over (see the chain floor).
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
// Host cost: the device's limits, the kernels' shared-memory and cluster
// attributes and the cluster occupancy are looked up once per device (and
// kernel, cluster size and shared-memory size) and cached.
//
// Numerics: expf and tanhf (not the fast intrinsics); the dot products sum
// in another order than the plain version does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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
__device__ __forceinline__ unsigned peer_addr(const float* p, unsigned rank) {
    const unsigned local = (unsigned)__cvta_generic_to_shared(p);
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(local), "r"(rank));
    return remote;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
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

// The shared-memory layout of one CTA of the cluster plan, in floats. The
// same arithmetic is lstm_plan's in nn/cuda_kernels.py; the launcher
// refuses a plan whose byte count disagrees.
struct ClusterLayout {
    int U, cols, hs, rp, P, ks;
    int rw, hbuf, zpart, xw, c, hst, total;  // offsets (floats) and the size
    __host__ __device__ ClusterLayout(int H, int S, int R, int RB) {
        U = (H + S - 1) / S;
        cols = 4 * U;
        hs = (H + 3) & ~3;                 // h rows padded for float4 loads
        rp = (R + RB - 1) / RB * RB;       // rows padded to the register block
        P = cols >= CTHREADS ? 1 : CTHREADS / cols;  // slices of the H products
        ks = ((hs + P - 1) / P + 3) & ~3;  // rows of rw a slice, a multiple of 4
        rw = 0;                            // [hs][cols], zero past H and uc
        hbuf = rw + hs * cols;             // 2 x [rp][hs]
        zpart = hbuf + 2 * rp * hs;        // [P][rp][cols]
        xw = zpart + P * rp * cols;        // 2 x [R][cols]
        c = xw + 2 * R * cols;             // [R][U]
        hst = c + R * U;                   // [R][U], h_t on its way to ys
        total = hst + R * U;
    }
};

__host__ __device__ inline int row_block(int R) { return R < 4 ? R : 4; }

// One cluster per slice of R batch rows; RB rows of a register block.
template <int RB>
__global__ void __launch_bounds__(CTHREADS, 1)
lstm_sequence_cluster_kernel(const float* __restrict__ xw, const float* __restrict__ rw,
                             const float* __restrict__ h0, const float* __restrict__ c0,
                             float* __restrict__ ys, float* __restrict__ hn,
                             float* __restrict__ cn, int T, int N, int H, int S, int R) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const ClusterLayout L(H, S, R, RB);
    const int U = L.U, cols = L.cols, hs = L.hs, rp = L.rp;
    float* rw_s = smem + L.rw;
    float* hbuf = smem + L.hbuf;
    float* zpart = smem + L.zpart;
    float* xw_s = smem + L.xw;
    float* c_s = smem + L.c;
    float* h_s = smem + L.hst;
    const int rank = (int)cluster_rank();
    const int row0 = (int)cluster_id() * R;
    const int u0 = rank * U;
    const int uc = max(0, min(U, H - u0));  // units this CTA owns
    const int tid = threadIdx.x;
    const int64_t H4 = 4 * (int64_t)H;

    // prologue: the slice of rw (every copy in flight at once: at T = 1
    // this is most of the kernel; a lane's columns are fixed, so it divides
    // once a column, not once an element), h0 into buffer 0, c0, xw_0
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
    for (int i = tid; i < 2 * rp * hs; i += CTHREADS) {
        const int b = i / (rp * hs), rem = i - b * rp * hs;
        const int r = rem / hs, k = rem - r * hs;
        const int n = row0 + r;
        hbuf[i] = (b == 0 && r < R && n < N && k < H) ? h0[(int64_t)n * H + k] : 0.f;
    }
    for (int i = tid; i < R * U; i += CTHREADS) {
        const int r = i / U, u = i - r * U;
        const int n = row0 + r;
        c_s[i] = (u < uc && n < N) ? c0[(int64_t)n * H + u0 + u] : 0.f;
    }
    // xw_t's rows and columns -> xw_s[t & 1], one commit group (empty
    // past the last step, so that the group count stays one a step)
    auto prefetch_xw = [&](int t) {
        float* dst = xw_s + (t & 1) * R * cols;
        const float* src = xw + (int64_t)t * N * H4;
        for (int e = tid; t < T && e < R * cols; e += CTHREADS) {
            const int r = e / cols, j = e - r * cols;
            const int g = j / U, u = j - g * U;
            const int n = row0 + r;
            if (u < uc && n < N) cp_async4(dst + e, src + n * H4 + (int64_t)g * H + u0 + u);
        }
        cp_async_commit();
    };
    prefetch_xw(0);
    cp_async_wait_all();  // this thread's copies of rw and xw_0
    // every CTA of the cluster has started (its shared memory exists) before
    // anyone writes into it; the barrier also publishes rw_s to the CTA
    cluster_arrive_release();
    cluster_wait_acquire();

    for (int t = 0; t < T; ++t) {
        const float* hb = hbuf + (t & 1) * rp * hs;  // h_{t-1}
        // xw_{t+1} does not depend on h: its copy has the whole step to land
        // (its buffer was last read in step t - 1, before the last barrier)
        prefetch_xw(t + 1);
        // 1. zpart[p][r][j] = sum over slice p of h_{t-1}[r][k] rw[k][j]
        for (int item = tid; item < cols * L.P; item += CTHREADS) {
            const int j = item % cols, p = item / cols;
            const int k_begin = p * L.ks, k_end = min(hs, k_begin + L.ks);
            for (int rb = 0; rb < rp; rb += RB) {
                float acc[RB];
#pragma unroll
                for (int q = 0; q < RB; ++q) acc[q] = 0.f;
                const float* hrow = hb + rb * hs;
                for (int k = k_begin; k < k_end; k += 4) {
                    const float w0 = rw_s[(k + 0) * cols + j], w1 = rw_s[(k + 1) * cols + j];
                    const float w2 = rw_s[(k + 2) * cols + j], w3 = rw_s[(k + 3) * cols + j];
#pragma unroll
                    for (int q = 0; q < RB; ++q) {
                        const float4 hv = *reinterpret_cast<const float4*>(hrow + q * hs + k);
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
        const float* xt = xw_s + (t & 1) * R * cols;
        float* hnext = hbuf + ((t + 1) & 1) * rp * hs;
        for (int it = tid; it < R * U; it += CTHREADS) {
            const int r = it / U, u = it - r * U;
            const int n = row0 + r;
            if (u >= uc || n >= N) continue;
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
            const float* slot = hnext + r * hs + u0 + u;
            for (int peer = 0; peer < S; ++peer) st_cluster(peer_addr(slot, peer), h);
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
            if (u < uc && n < N) ys[((int64_t)t * N + n) * H + u0 + u] = h_s[it];
        }
    }
    for (int it = tid; it < R * U; it += CTHREADS) {
        const int r = it / U, u = it - r * U;
        const int n = row0 + r;
        if (u < uc && n < N) {
            hn[(int64_t)n * H + u0 + u] = h_s[it];
            cn[(int64_t)n * H + u0 + u] = c_s[it];
        }
    }
}

// The chain floor: T steps of the cluster plan's hand-over alone, on its
// geometry and shared memory: each (row, unit) owner reads one entry of its
// h buffer, writes a value to every CTA's other buffer, and the cluster
// meets at its barrier. No products, no cell. out [N, H] gets the last
// values, so nothing is optimised away.
__global__ void __launch_bounds__(CTHREADS, 1)
lstm_chain_floor_kernel(float* __restrict__ out, int T, int N, int H, int S, int R) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const ClusterLayout L(H, S, R, row_block(R));
    const int U = L.U, hs = L.hs, rp = L.rp;
    float* hbuf = smem + L.hbuf;
    const int rank = (int)cluster_rank();
    const int row0 = (int)cluster_id() * R;
    const int u0 = rank * U;
    const int uc = max(0, min(U, H - u0));
    for (int i = threadIdx.x; i < 2 * rp * hs; i += CTHREADS) hbuf[i] = 0.f;
    cluster_arrive_release();
    cluster_wait_acquire();
    float last = 0.f;
    for (int t = 0; t < T; ++t) {
        const float* hb = hbuf + (t & 1) * rp * hs;
        float* hnext = hbuf + ((t + 1) & 1) * rp * hs;
        for (int it = threadIdx.x; it < R * U; it += CTHREADS) {
            const int r = it / U, u = it - r * U;
            if (u >= uc || row0 + r >= N) continue;
            last = hb[r * hs + (u0 + u + 1) % H] + 1.f;
            const float* slot = hnext + r * hs + u0 + u;
            for (int peer = 0; peer < S; ++peer) st_cluster(peer_addr(slot, peer), last);
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

// The instantiation for a plan's register block.
const void* cluster_kernel(int R) {
    switch (row_block(R)) {
        case 1: return (const void*)lstm_sequence_cluster_kernel<1>;
        case 2: return (const void*)lstm_sequence_cluster_kernel<2>;
        case 3: return (const void*)lstm_sequence_cluster_kernel<3>;
        default: return (const void*)lstm_sequence_cluster_kernel<4>;
    }
}

bool bad_plan(int H, int S, int R) { return H <= 0 || S < 1 || S > 16 || R < 1; }

// Checks a cluster plan and prepares `kernel` for it: S in 1..16, the
// shared-memory bytes at least those of ClusterLayout, within the device's limit,
// and at least one such cluster schedulable (cudaOccupancyMaxActiveClusters,
// cached). Writes the number of clusters that can be resident at once.
cudaError_t check_cluster(const void* kernel, int H, int S, int R, int smem,
                          cudaStream_t stream, int* clusters) {
    if (bad_plan(H, S, R)) return cudaErrorInvalidValue;
    const ClusterLayout L(H, S, R, row_block(R));
    if ((int64_t)L.total * 4 > smem) return cudaErrorInvalidValue;
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
// at width H) can be resident at once; 0 with cudaErrorInvalidConfiguration
// when none can.
extern "C" int dl4j_lstm_cluster_occupancy(int H, int S, int R, int smem, int* clusters) {
    *clusters = 0;
    if (bad_plan(H, S, R)) return (int)cudaErrorInvalidValue;
    return (int)check_cluster(cluster_kernel(R), H, S, R, smem, 0, clusters);
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

    const void* kernel = (const void*)lstm_sequence_kernel;
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
    if (T <= 0 || N <= 0 || bad_plan(H, S, R)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* kernel = cluster_kernel(R);
    int resident = 0;
    cudaError_t err = check_cluster(kernel, H, S, R, smem, s, &resident);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, (N + R - 1) / R, S, smem, s);
    void* args[] = {(void*)&xw, (void*)&rw, (void*)&h0, (void*)&c0, (void*)&ys, (void*)&hn,
                    (void*)&cn, (void*)&T, (void*)&N, (void*)&H, (void*)&S, (void*)&R};
    err = cudaLaunchKernelExC(&cfg, kernel, args);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// The chain floor of a cluster plan (same S, R, smem; out [N, H] f32):
// T steps of the hand-over of h and the cluster barrier, nothing else.
extern "C" int dl4j_lstm_chain_floor_f32(void* out, int T, int N, int H, int S, int R,
                                         int smem, void* stream) {
    if (T <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const void* kernel = (const void*)lstm_chain_floor_kernel;
    int resident = 0;
    cudaError_t err = check_cluster(kernel, H, S, R, smem, s, &resident);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, (N + R - 1) / R, S, smem, s);
    err = cudaLaunchKernelEx(&cfg, lstm_chain_floor_kernel, static_cast<float*>(out), T, N, H,
                             S, R);
    if (err != cudaSuccess) {
        (void)cudaGetLastError();
        return (int)err;
    }
    return (int)cudaGetLastError();
}
