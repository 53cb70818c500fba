// Multithreaded streaming corpus word-frequency scan.
//
// The reference's vocabulary construction is a parallel corpus scan across
// JVM threads (VocabConstructor.java:31 + SequenceVectors' per-core
// tokenization); CPython counts tokens under the GIL. This scanner STREAMS
// the file in fixed-size blocks (so memory is O(block + vocab), not
// O(corpus) — the reference's constructor streams sequences the same way),
// splits each block into per-thread chunks at ASCII-whitespace boundaries,
// counts zero-copy string_view tokens in real threads, and merges into a
// global map that only ever copies UNIQUE words.
//
// Tokenization semantics: split on ASCII whitespace (exactly what
// bytes.split() does in the Python fallback); optional ASCII lowercasing.
// Words are returned newline-joined in (count desc, word asc) order so the
// resulting vocabulary is deterministic.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kBlock = 64u << 20;  // 64 MiB per streamed block

struct ScanResult {
    std::vector<std::pair<std::string, long long>> entries;  // sorted
    long long total_tokens = 0;
    long long words_bytes = 0;  // newline-joined serialization size
};

inline bool is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
}

// tokens are string_views into the (already-lowercased) block buffer: no
// per-token allocation; uniques copy once at the block merge
void count_chunk(const char* data, size_t begin, size_t end,
                 std::unordered_map<std::string_view, long long>* out,
                 long long* total) {
    size_t i = begin;
    while (i < end) {
        while (i < end && is_space((unsigned char)data[i])) i++;
        size_t start = i;
        while (i < end && !is_space((unsigned char)data[i])) i++;
        if (i > start) {
            ++(*out)[std::string_view(data + start, i - start)];
            ++(*total);
        }
    }
}

void count_block(const std::string& buf, int nt,
                 std::unordered_map<std::string, long long>* global,
                 long long* total_tokens) {
    if (buf.empty()) return;
    int threads_n = nt;
    if (buf.size() < (size_t)threads_n * 4096) threads_n = 1;

    // chunk boundaries snapped forward to whitespace so no token splits
    std::vector<size_t> bounds(threads_n + 1, 0);
    bounds[threads_n] = buf.size();
    for (int t = 1; t < threads_n; t++) {
        size_t b = buf.size() * t / threads_n;
        while (b < buf.size() && !is_space((unsigned char)buf[b])) b++;
        bounds[t] = b;
    }

    std::vector<std::unordered_map<std::string_view, long long>> maps(threads_n);
    std::vector<long long> totals(threads_n, 0);
    std::vector<std::thread> workers;
    for (int t = 0; t < threads_n; t++)
        workers.emplace_back(count_chunk, buf.data(), bounds[t],
                             bounds[t + 1], &maps[t], &totals[t]);
    for (auto& th : workers) th.join();

    for (int t = 0; t < threads_n; t++) {
        *total_tokens += totals[t];
        for (auto& kv : maps[t])
            (*global)[std::string(kv.first)] += kv.second;
    }
}

}  // namespace

extern "C" {

// Scan `path`; returns an opaque handle (nullptr on IO failure).
// out[0] = unique words, out[1] = total tokens, out[2] = serialized bytes.
void* corpus_scan_file(const char* path, int n_threads, int to_lower,
                       long long* out) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return nullptr;

    const int nt = n_threads < 1 ? 1 : n_threads;
    std::unordered_map<std::string, long long> global;
    long long total_tokens = 0;
    std::string buf;      // carry (partial trailing token) + fresh block
    size_t carry = 0;     // bytes at the front of buf carried over

    while (true) {
        buf.resize(carry + kBlock);
        f.read(&buf[carry], kBlock);
        const size_t got = (size_t)f.gcount();
        buf.resize(carry + got);
        const bool eof = got < kBlock;

        if (to_lower) {  // only the fresh bytes; carry is already lowered
            for (size_t i = carry; i < buf.size(); i++)
                if (buf[i] >= 'A' && buf[i] <= 'Z') buf[i] += 'a' - 'A';
        }

        size_t usable = buf.size();
        if (!eof) {
            // hold back the trailing partial token for the next block
            while (usable > 0 && !is_space((unsigned char)buf[usable - 1]))
                usable--;
        }
        if (usable == 0 && !eof) {
            // a single token longer than the block: keep accumulating
            carry = buf.size();
            continue;
        }
        std::string rest(buf, usable);
        buf.resize(usable);
        count_block(buf, nt, &global, &total_tokens);
        buf = std::move(rest);
        carry = buf.size();
        if (eof) break;
    }

    auto* res = new ScanResult();
    res->total_tokens = total_tokens;
    res->entries.reserve(global.size());
    for (auto it = global.begin(); it != global.end();) {
        auto node = global.extract(it++);
        res->entries.emplace_back(std::move(node.key()), node.mapped());
    }
    std::sort(res->entries.begin(), res->entries.end(),
              [](const auto& a, const auto& b) {
                  if (a.second != b.second) return a.second > b.second;
                  return a.first < b.first;
              });
    for (auto& e : res->entries) res->words_bytes += (long long)e.first.size() + 1;

    out[0] = (long long)res->entries.size();
    out[1] = res->total_tokens;
    out[2] = res->words_bytes;
    return res;
}

// Fill caller-allocated buffers: words newline-joined (words_bytes long),
// counts (n_unique long longs).
void corpus_scan_fill(void* handle, char* words_buf, long long* counts) {
    auto* res = (ScanResult*)handle;
    char* p = words_buf;
    for (size_t i = 0; i < res->entries.size(); i++) {
        const auto& e = res->entries[i];
        std::memcpy(p, e.first.data(), e.first.size());
        p += e.first.size();
        *p++ = '\n';
        counts[i] = e.second;
    }
}

void corpus_scan_free(void* handle) { delete (ScanResult*)handle; }

}  // extern "C"
