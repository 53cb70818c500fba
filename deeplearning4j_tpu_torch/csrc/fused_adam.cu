// Fused Adam / AMSGrad / Nadam update, f32, for Hopper (sm_90a).
//
// Replaces _fused_update_rows (deeplearning4j_tpu/nn/pallas_kernels.py:218)
// and its bodies _adam_kernel (:179, Adam and AMSGrad) and _nadam_kernel
// (:200), driven by PallasUpdaterHelper.apply (:280). One launch per
// parameter tensor does the whole read-modify-write IN PLACE on the
// parameter and its state:
//
//   m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g g
//   Adam:    p -= alpha m / (sqrt(v) + eps)
//   AMSGrad: v_hat = max(v_hat, v);  p -= alpha m / (sqrt(v_hat) + eps)
//   Nadam:   m_bar = b1 m / om1 + (1 - b1) g / om1
//            p -= lr m_bar / (sqrt(v / om2) + eps)
//
// with alpha = lr sqrt(1 - b2^t) / (1 - b1^t), om1 = 1 - b1^t and
// om2 = 1 - b2^t computed on the host in float32 from the host's step count
// (the reference computes them outside its kernel too), so nothing here
// waits for the device and no scalar lives in device memory.
//
// Design for this card: the TPU kernel's (R, 128) row tiles and their zero
// padding are gone. A grid-stride loop walks the flat tensor four floats
// at a time with 16-byte loads when every pointer is 16-byte aligned, and
// one float at a time otherwise and for the tail.
//
// Bound: pure streaming. Each element reads p, m, v, g and writes p, m, v:
// 28 bytes (36 with AMSGrad's v_hat). GPT-2-small's 163,087,441 parameters
// are 4.57 GB per Adam step -> 1.36 ms at the H100 SXM's 3.35 TB/s; the
// [768, 50257] output matrix alone is 1.08 GB -> 0.32 ms. Operations (about
// 12 flops an element, one sqrt and one divide) are far below the 67 TFLOP/s
// f32 rate, so the kernel is bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // enough in flight on 132 SMs

enum Kind { ADAM = 0, AMSGRAD = 1, NADAM = 2 };

struct Coef {
    float b1, b2;      // beta1, beta2
    float omb1, omb2;  // 1 - beta1, 1 - beta2 (rounded once, as the stock path)
    float eps;
    float c;           // alpha (Adam, AMSGrad) or lr (Nadam)
    float om1, om2;    // 1 - beta1^t, 1 - beta2^t (Nadam)
};

template <int KIND>
__device__ __forceinline__ void step(float& p, float& m, float& v, float& vh,
                                     float g, const Coef& k) {
    m = k.b1 * m + k.omb1 * g;
    v = k.b2 * v + k.omb2 * g * g;
    if (KIND == NADAM) {
        const float m_hat = m / k.om1;
        const float v_hat = v / k.om2;
        const float m_bar = k.b1 * m_hat + k.omb1 * g / k.om1;
        p = p - k.c * m_bar / (sqrtf(v_hat) + k.eps);
    } else {
        float denom = v;
        if (KIND == AMSGRAD) {
            vh = fmaxf(vh, v);
            denom = vh;
        }
        p = p - k.c * m / (sqrtf(denom) + k.eps);
    }
}

template <int KIND>
__device__ __forceinline__ void step_at(float* __restrict__ p, float* __restrict__ m,
                                        float* __restrict__ v, float* __restrict__ vh,
                                        const float* __restrict__ g, int64_t i,
                                        const Coef& k) {
    float pp = p[i], mm = m[i], vv = v[i], hh = KIND == AMSGRAD ? vh[i] : 0.f;
    step<KIND>(pp, mm, vv, hh, g[i], k);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
    if (KIND == AMSGRAD) vh[i] = hh;
}

template <int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(float* __restrict__ p, float* __restrict__ m,
                  float* __restrict__ v, float* __restrict__ vh,
                  const float* __restrict__ g, int64_t n, Coef k) {
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    int64_t done = 0;
    if (VEC) {
        const int64_t n4 = n / 4;
        float4* p4 = reinterpret_cast<float4*>(p);
        float4* m4 = reinterpret_cast<float4*>(m);
        float4* v4 = reinterpret_cast<float4*>(v);
        float4* h4 = reinterpret_cast<float4*>(vh);
        const float4* g4 = reinterpret_cast<const float4*>(g);
        for (int64_t i = first; i < n4; i += stride) {
            float4 pp = p4[i], mm = m4[i], vv = v4[i], gg = g4[i];
            float4 hh = KIND == AMSGRAD ? h4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
            step<KIND>(pp.x, mm.x, vv.x, hh.x, gg.x, k);
            step<KIND>(pp.y, mm.y, vv.y, hh.y, gg.y, k);
            step<KIND>(pp.z, mm.z, vv.z, hh.z, gg.z, k);
            step<KIND>(pp.w, mm.w, vv.w, hh.w, gg.w, k);
            p4[i] = pp;
            m4[i] = mm;
            v4[i] = vv;
            if (KIND == AMSGRAD) h4[i] = hh;
        }
        done = n4 * 4;
    }
    for (int64_t i = done + first; i < n; i += stride) step_at<KIND>(p, m, v, vh, g, i, k);
}

template <int KIND>
cudaError_t launch(float* p, float* m, float* v, float* vh, const float* g,
                   int64_t n, const Coef& k, cudaStream_t stream) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m)
        | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g)
        | (KIND == AMSGRAD ? reinterpret_cast<uintptr_t>(vh) : 0);
    const bool vec = (bits & 15) == 0;
    const int64_t work = vec ? (n + 3) / 4 : n;
    const int64_t want = (work + THREADS - 1) / THREADS;
    const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
    if (vec)
        fused_adam_kernel<KIND, true><<<blocks, THREADS, 0, stream>>>(p, m, v, vh, g, n, k);
    else
        fused_adam_kernel<KIND, false><<<blocks, THREADS, 0, stream>>>(p, m, v, vh, g, n, k);
    return cudaGetLastError();
}

}  // namespace

// p, m, v, g (and v_hat for AMSGrad, else null): n contiguous f32 on the
// device, updated in place (g is read only). kind: 0 Adam, 1 AMSGrad,
// 2 Nadam. c is alpha for Adam/AMSGrad and lr for Nadam; om1, om2 are
// 1 - b1^t and 1 - b2^t (read by Nadam only). Returns a cudaError_t
// (0 = launched).
extern "C" int dl4j_fused_adam_f32(void* p, void* m, void* v, void* v_hat,
                                   const void* g, long long n, int kind,
                                   float b1, float b2, float omb1, float omb2,
                                   float eps, float c, float om1, float om2,
                                   void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    if (kind == AMSGRAD && v_hat == nullptr) return (int)cudaErrorInvalidValue;
    const Coef k{b1, b2, omb1, omb2, eps, c, om1, om2};
    float* pf = static_cast<float*>(p);
    float* mf = static_cast<float*>(m);
    float* vf = static_cast<float*>(v);
    float* hf = static_cast<float*>(v_hat);
    const float* gf = static_cast<const float*>(g);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case ADAM: return (int)launch<ADAM>(pf, mf, vf, hf, gf, n, k, s);
        case AMSGRAD: return (int)launch<AMSGRAD>(pf, mf, vf, hf, gf, n, k, s);
        case NADAM: return (int)launch<NADAM>(pf, mf, vf, hf, gf, n, k, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
