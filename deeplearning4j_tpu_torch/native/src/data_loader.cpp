// Native prefetching batch loader.
//
// Role of the reference's native ETL path: AsyncDataSetIterator.java:30 runs
// a JVM prefetch thread over DataVec's record pipeline with device-aware
// buffering; the heavy parsing/copy work happens outside the training
// thread. A Python-thread version of that still serializes on the GIL while
// it shuffles/gathers/casts numpy slices, so this loader does the batch
// assembly in real C++ threads: parse IDX files (or adopt caller-owned float
// buffers), then worker threads fill a bounded ring of ready batches
// (shuffled gather + dtype cast + optional normalization + one-hot) that the
// training loop pops with a single memcpy-free handoff.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
    std::vector<float> x;
    std::vector<float> y;
    long count = 0;
};

struct Loader {
    // dataset (owned or adopted)
    std::vector<float> own_x, own_y;
    const float* data_x = nullptr;  // [n, x_elems]
    const float* data_y = nullptr;  // [n, y_elems]
    long n = 0, x_elems = 0, y_elems = 0;
    long batch = 0;
    bool shuffle = false;
    unsigned seed = 0;
    bool drop_last = false;

    // epoch state: the order vector is an immutable per-epoch snapshot so
    // workers can read it lock-free while reset() installs a fresh one
    std::shared_ptr<const std::vector<long>> order;
    long epoch = 0;

    // ready batches keyed by batch index: the consumer pops strictly in
    // claim order so multi-threaded assembly cannot reorder delivery
    std::map<long, Batch> ready;
    size_t prefetch = 2;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::vector<std::thread> workers;
    std::atomic<bool> stopping{false};
    long produced = 0, consumed = 0, total_batches = 0;

    void start(int n_threads) {
        reset_epoch();
        for (int t = 0; t < n_threads; ++t)
            workers.emplace_back([this] { work(); });
    }

    void reset_epoch() {
        auto fresh = std::make_shared<std::vector<long>>((size_t)n);
        for (long i = 0; i < n; ++i) (*fresh)[(size_t)i] = i;
        if (shuffle) {
            std::mt19937_64 rng(seed + (unsigned long)epoch);
            std::shuffle(fresh->begin(), fresh->end(), rng);
        }
        order = std::move(fresh);
        total_batches = drop_last ? n / batch : (n + batch - 1) / batch;
        produced = consumed = 0;
    }

    void work() {
        for (;;) {
            long b = -1, my_epoch = -1;
            std::shared_ptr<const std::vector<long>> ord;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [this] {
                    return stopping.load() ||
                           (ready.size() + (size_t)0 < prefetch &&
                            produced < total_batches);
                });
                if (stopping.load()) return;
                b = produced++;
                my_epoch = epoch;
                ord = order;
            }
            long lo = b * batch;
            long hi = lo + batch < n ? lo + batch : n;
            Batch out;
            out.count = hi - lo;
            out.x.resize((size_t)(out.count * x_elems));
            out.y.resize((size_t)(out.count * y_elems));
            for (long r = lo; r < hi; ++r) {
                long src = (*ord)[(size_t)r];
                std::memcpy(&out.x[(size_t)((r - lo) * x_elems)],
                            data_x + src * x_elems,
                            (size_t)x_elems * sizeof(float));
                std::memcpy(&out.y[(size_t)((r - lo) * y_elems)],
                            data_y + src * y_elems,
                            (size_t)y_elems * sizeof(float));
            }
            {
                std::unique_lock<std::mutex> lk(mu);
                if (my_epoch == epoch)  // drop stale batches after reset()
                    ready.emplace(b, std::move(out));
            }
            cv_ready.notify_all();
        }
    }

    // returns rows copied, 0 at epoch end
    long next(float* x_out, float* y_out) {
        std::unique_lock<std::mutex> lk(mu);
        if (consumed >= total_batches) return 0;
        cv_ready.wait(lk, [this] {
            return stopping.load() || ready.count(consumed) != 0;
        });
        if (stopping.load()) return 0;
        auto it = ready.find(consumed);
        Batch b = std::move(it->second);
        ready.erase(it);
        ++consumed;
        lk.unlock();
        cv_space.notify_all();
        std::memcpy(x_out, b.x.data(), b.x.size() * sizeof(float));
        std::memcpy(y_out, b.y.data(), b.y.size() * sizeof(float));
        return b.count;
    }

    void reset(bool bump_epoch) {
        std::unique_lock<std::mutex> lk(mu);
        // drop whatever the workers queued for the old epoch
        ready.clear();
        if (bump_epoch) ++epoch;
        reset_epoch();
        lk.unlock();
        cv_space.notify_all();
    }

    ~Loader() {
        {
            // take the lock so no worker can be between predicate-check and
            // wait() when the flag flips (lost-wakeup → join deadlock)
            std::unique_lock<std::mutex> lk(mu);
            stopping.store(true);
        }
        cv_space.notify_all();
        cv_ready.notify_all();
        for (auto& w : workers) w.join();
    }
};

static uint32_t read_be32(FILE* f) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return 0;
    return ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
           ((uint32_t)b[2] << 8) | (uint32_t)b[3];
}

}  // namespace

extern "C" {

// Adopt caller-owned float32 buffers (must outlive the loader).
void* loader_create_mem(const float* x, const float* y, long n, long x_elems,
                        long y_elems, long batch, int shuffle, unsigned seed,
                        int prefetch, int n_threads, int drop_last) {
    auto* L = new Loader();
    L->data_x = x;
    L->data_y = y;
    L->n = n;
    L->x_elems = x_elems;
    L->y_elems = y_elems;
    L->batch = batch;
    L->shuffle = shuffle != 0;
    L->seed = seed;
    L->drop_last = drop_last != 0;
    L->prefetch = (size_t)(prefetch < 1 ? 1 : prefetch);
    L->start(n_threads < 1 ? 1 : n_threads);
    return L;
}

// Parse IDX image+label files (the MNIST/EMNIST container format the
// reference's MnistDataFetcher reads), normalize pixels to [0,1], one-hot
// labels. Returns nullptr on parse failure.
void* loader_create_idx(const char* images_path, const char* labels_path,
                        int n_classes, long batch, int shuffle, unsigned seed,
                        int prefetch, int n_threads, int drop_last) {
    FILE* fi = fopen(images_path, "rb");
    if (!fi) return nullptr;
    FILE* fl = fopen(labels_path, "rb");
    if (!fl) {
        fclose(fi);
        return nullptr;
    }
    auto fail = [&]() -> void* {
        fclose(fi);
        fclose(fl);
        return nullptr;
    };
    uint32_t magic_i = read_be32(fi), n_img = read_be32(fi);
    uint32_t rows = read_be32(fi), cols = read_be32(fi);
    uint32_t magic_l = read_be32(fl), n_lab = read_be32(fl);
    if (magic_i != 0x00000803 || magic_l != 0x00000801 || n_img != n_lab)
        return fail();
    long n = (long)n_img, elems = (long)rows * (long)cols;
    auto* L = new Loader();
    L->own_x.resize((size_t)(n * elems));
    L->own_y.assign((size_t)(n * n_classes), 0.0f);
    std::vector<unsigned char> buf((size_t)elems);
    for (long i = 0; i < n; ++i) {
        if (fread(buf.data(), 1, (size_t)elems, fi) != (size_t)elems) {
            delete L;
            return fail();
        }
        float* dst = &L->own_x[(size_t)(i * elems)];
        for (long j = 0; j < elems; ++j) dst[j] = buf[(size_t)j] / 255.0f;
        int lab = fgetc(fl);
        if (lab < 0 || lab >= n_classes) {
            delete L;
            return fail();
        }
        L->own_y[(size_t)(i * n_classes + lab)] = 1.0f;
    }
    fclose(fi);
    fclose(fl);
    L->data_x = L->own_x.data();
    L->data_y = L->own_y.data();
    L->n = n;
    L->x_elems = elems;
    L->y_elems = n_classes;
    L->batch = batch;
    L->shuffle = shuffle != 0;
    L->seed = seed;
    L->drop_last = drop_last != 0;
    L->prefetch = (size_t)(prefetch < 1 ? 1 : prefetch);
    L->start(n_threads < 1 ? 1 : n_threads);
    return L;
}

long loader_next(void* h, float* x_out, float* y_out) {
    return static_cast<Loader*>(h)->next(x_out, y_out);
}

// advance to the next epoch (fresh shuffle order)
void loader_reset(void* h) { static_cast<Loader*>(h)->reset(true); }

// re-arm the SAME epoch (identical order) — used when iteration restarts
// without an explicit reset, matching the Python fallback's semantics
void loader_rewind(void* h) { static_cast<Loader*>(h)->reset(false); }

long loader_num_examples(void* h) { return static_cast<Loader*>(h)->n; }

long loader_x_elems(void* h) { return static_cast<Loader*>(h)->x_elems; }

long loader_y_elems(void* h) { return static_cast<Loader*>(h)->y_elems; }

long loader_batch(void* h) { return static_cast<Loader*>(h)->batch; }

void loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
