// Threshold gradient codec — native wire-format encoder/decoder.
//
// Role of the reference's libnd4j thresholdEncode/thresholdDecode kernels
// (reached through Nd4j.getExecutioner().thresholdEncode, used by
// EncodingHandler.java:139 and EncodedGradientsAccumulator.java:257): turn a
// dense residual vector into the sparse signed-index message sent over the
// wire, and apply such messages back onto a dense vector. On-device (ICI)
// the quantization runs inside the jitted step; this native codec is the
// host-side DCN path where messages leave the chip, so encoding must not
// hold the GIL or bounce through numpy loops.
//
// Wire format (matches the Python fallback in parallel/compression.py):
//   entry k: int32 v, v = +(i+1) for +threshold at index i, -(i+1) for
//   -threshold. Worst case size is bounded by `capacity` the same way
//   EncodedGradientsAccumulator.getOptimalBufferSize bounds its buffers.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Returns number of encoded entries, or -1 if capacity would be exceeded
// (caller falls back to dense transmission, the reference's 2-bit bitmap
// worst case). Entries are written in ascending index order.
long threshold_encode(const float* in, long n, float threshold,
                      int32_t* out, long capacity) {
    long count = 0;
    for (long i = 0; i < n; ++i) {
        float v = in[i];
        if (v >= threshold) {
            if (count == capacity) return -1;
            out[count++] = (int32_t)(i + 1);
        } else if (v <= -threshold) {
            if (count == capacity) return -1;
            out[count++] = (int32_t)(-(i + 1));
        }
    }
    return count;
}

// Applies message additively: out[i] += sign * threshold per entry.
void threshold_decode(const int32_t* enc, long count, float threshold,
                      float* out, long n) {
    for (long k = 0; k < count; ++k) {
        int32_t v = enc[k];
        long i = (v > 0 ? (long)v : (long)(-v)) - 1;
        if (i >= 0 && i < n) out[i] += (v > 0 ? threshold : -threshold);
    }
}

// Subtracts the encoded entries from the residual (post-encode bookkeeping:
// residual -= quantized), fused here so Python does one call, not two.
void threshold_extract(float* residual, long n, float threshold,
                       const int32_t* enc, long count) {
    for (long k = 0; k < count; ++k) {
        int32_t v = enc[k];
        long i = (v > 0 ? (long)v : (long)(-v)) - 1;
        if (i >= 0 && i < n) residual[i] -= (v > 0 ? threshold : -threshold);
    }
}

// Multi-threaded count of elements that would be encoded (sizing pass).
long threshold_count(const float* in, long n, float threshold, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n < 1 << 16) {
        long c = 0;
        for (long i = 0; i < n; ++i) {
            float v = in[i];
            if (v >= threshold || v <= -threshold) ++c;
        }
        return c;
    }
    std::vector<std::thread> workers;
    std::vector<long> counts((size_t)n_threads, 0);
    long chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        workers.emplace_back([=, &counts] {
            long lo = (long)t * chunk;
            long hi = lo + chunk < n ? lo + chunk : n;
            long c = 0;
            for (long i = lo; i < hi; ++i) {
                float v = in[i];
                if (v >= threshold || v <= -threshold) ++c;
            }
            counts[(size_t)t] = c;
        });
    }
    long total = 0;
    for (int t = 0; t < n_threads; ++t) {
        workers[(size_t)t].join();
        total += counts[(size_t)t];
    }
    return total;
}

}  // extern "C"
