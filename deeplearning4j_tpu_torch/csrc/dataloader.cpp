// Native data-loading runtime of the port (its own copy of the JAX
// package's native/dataloader.cpp): DataVec-style record reading and an
// AsyncDataSetIterator-style prefetch ring behind a C ABI for ctypes.
//
//   - CSV parsing into float32 feature / label matrices (record reader)
//   - MNIST IDX binary parsing
//   - a background-thread prefetch ring: a worker shuffles and assembles
//     batches while the consumer (the train step) drains them, keeping
//     the host input pipeline off the card's critical path.
//
// Built at first use by datasets/native_loader.py:
//   g++ -O2 -std=c++17 -fPIC -pthread -shared

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Matrix {
    std::vector<float> data;
    int64_t rows = 0, cols = 0;
};

struct Batch {
    std::vector<float> features;
    std::vector<float> labels;
    int64_t n = 0;
};

struct Loader {
    Matrix features;
    Matrix labels;
    int64_t batch_size = 32;
    bool shuffle = true;
    uint64_t seed = 0;
    // prefetch ring
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    std::queue<Batch> ring;
    size_t capacity = 4;
    std::atomic<bool> done{false};
    std::atomic<bool> stop{false};

    ~Loader() { shutdown(); }

    void shutdown() {
        stop.store(true);
        cv_push.notify_all();
        cv_pop.notify_all();
        if (worker.joinable()) worker.join();
    }

    void start() {
        done.store(false);
        stop.store(false);
        worker = std::thread([this] { produce(); });
    }

    void produce() {
        std::vector<int64_t> order(features.rows);
        for (int64_t i = 0; i < features.rows; ++i) order[i] = i;
        if (shuffle) {
            std::mt19937_64 rng(seed);
            for (int64_t i = features.rows - 1; i > 0; --i) {
                std::uniform_int_distribution<int64_t> dist(0, i);
                std::swap(order[i], order[dist(rng)]);
            }
        }
        const int64_t fc = features.cols, lc = labels.cols;
        for (int64_t s = 0; s < features.rows && !stop.load();
             s += batch_size) {
            int64_t n = std::min(batch_size, features.rows - s);
            Batch b;
            b.n = n;
            b.features.resize(n * fc);
            b.labels.resize(n * lc);
            for (int64_t r = 0; r < n; ++r) {
                int64_t src = order[s + r];
                std::memcpy(&b.features[r * fc], &features.data[src * fc],
                            fc * sizeof(float));
                if (lc)
                    std::memcpy(&b.labels[r * lc], &labels.data[src * lc],
                                lc * sizeof(float));
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_push.wait(lk, [this] {
                return ring.size() < capacity || stop.load();
            });
            if (stop.load()) return;
            ring.push(std::move(b));
            cv_pop.notify_one();
        }
        done.store(true);
        cv_pop.notify_all();
    }
};

uint32_t read_be32(std::ifstream& f) {
    unsigned char b[4];
    f.read(reinterpret_cast<char*>(b), 4);
    return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
           (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

}  // namespace

extern "C" {

// ---------- CSV record reader ----------
// Parses numeric CSV; label_index column becomes a one-hot label of
// num_classes (or regression passthrough when num_classes == 0).
void* csv_loader_create(const char* path, int64_t batch_size,
                        int label_index, int num_classes, int shuffle,
                        uint64_t seed, int skip_lines, char delimiter) {
    std::ifstream f(path);
    if (!f.good()) return nullptr;
    auto* L = new Loader();
    L->batch_size = batch_size;
    L->shuffle = shuffle != 0;
    L->seed = seed;
    std::string line;
    std::vector<std::vector<float>> rows;
    int skipped = 0;
    while (std::getline(f, line)) {
        if (skipped++ < skip_lines || line.empty()) continue;
        std::vector<float> row;
        std::stringstream ss(line);
        std::string cell;
        while (std::getline(ss, cell, delimiter))
            row.push_back(cell.empty() ? 0.f : std::strtof(cell.c_str(),
                                                           nullptr));
        if (!row.empty()) rows.push_back(std::move(row));
    }
    if (rows.empty()) { delete L; return nullptr; }
    int64_t total_cols = rows[0].size();
    int64_t fc = (label_index >= 0) ? total_cols - 1 : total_cols;
    int64_t lc = (label_index >= 0)
                     ? (num_classes > 0 ? num_classes : 1) : 0;
    L->features.rows = rows.size();
    L->features.cols = fc;
    L->features.data.resize(rows.size() * fc);
    L->labels.rows = rows.size();
    L->labels.cols = lc;
    L->labels.data.assign(rows.size() * lc, 0.f);
    for (size_t r = 0; r < rows.size(); ++r) {
        int64_t fi = 0;
        for (int64_t c = 0; c < total_cols; ++c) {
            if (c == label_index) {
                if (num_classes > 0) {
                    int cls = int(rows[r][c]);
                    if (cls >= 0 && cls < num_classes)
                        L->labels.data[r * lc + cls] = 1.f;
                } else if (lc) {
                    L->labels.data[r * lc] = rows[r][c];
                }
            } else {
                L->features.data[r * fc + fi++] = rows[r][c];
            }
        }
    }
    L->start();
    return L;
}

// ---------- MNIST IDX reader ----------
void* idx_loader_create(const char* images_path, const char* labels_path,
                        int64_t batch_size, int shuffle, uint64_t seed) {
    std::ifstream fi(images_path, std::ios::binary);
    std::ifstream fl(labels_path, std::ios::binary);
    if (!fi.good() || !fl.good()) return nullptr;
    uint32_t magic_i = read_be32(fi);
    if ((magic_i & 0xFF) != 3) return nullptr;
    uint32_t n = read_be32(fi), h = read_be32(fi), w = read_be32(fi);
    read_be32(fl);  // label magic
    uint32_t nl = read_be32(fl);
    if (n != nl) return nullptr;
    auto* L = new Loader();
    L->batch_size = batch_size;
    L->shuffle = shuffle != 0;
    L->seed = seed;
    L->features.rows = n;
    L->features.cols = int64_t(h) * w;
    L->features.data.resize(size_t(n) * h * w);
    std::vector<unsigned char> buf(size_t(h) * w);
    for (uint32_t i = 0; i < n; ++i) {
        fi.read(reinterpret_cast<char*>(buf.data()), buf.size());
        for (size_t p = 0; p < buf.size(); ++p)
            L->features.data[size_t(i) * buf.size() + p] = buf[p] / 255.0f;
    }
    L->labels.rows = n;
    L->labels.cols = 10;
    L->labels.data.assign(size_t(n) * 10, 0.f);
    std::vector<unsigned char> lab(n);
    fl.read(reinterpret_cast<char*>(lab.data()), n);
    for (uint32_t i = 0; i < n; ++i)
        L->labels.data[size_t(i) * 10 + lab[i]] = 1.f;
    L->start();
    return L;
}

int64_t loader_num_examples(void* h) {
    return h ? static_cast<Loader*>(h)->features.rows : 0;
}
int64_t loader_feature_cols(void* h) {
    return h ? static_cast<Loader*>(h)->features.cols : 0;
}
int64_t loader_label_cols(void* h) {
    return h ? static_cast<Loader*>(h)->labels.cols : 0;
}

// Pop the next prefetched batch into caller buffers; returns n rows
// (0 = epoch finished).
int64_t loader_next(void* h, float* features_out, float* labels_out) {
    auto* L = static_cast<Loader*>(h);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [L] {
        return !L->ring.empty() || L->done.load() || L->stop.load();
    });
    if (L->ring.empty()) return 0;
    Batch b = std::move(L->ring.front());
    L->ring.pop();
    L->cv_push.notify_one();
    lk.unlock();
    std::memcpy(features_out, b.features.data(),
                b.features.size() * sizeof(float));
    if (labels_out && !b.labels.empty())
        std::memcpy(labels_out, b.labels.data(),
                    b.labels.size() * sizeof(float));
    return b.n;
}

// Restart the epoch (rewinds + reshuffles with seed+1).
void loader_reset(void* h) {
    auto* L = static_cast<Loader*>(h);
    L->shutdown();
    L->seed += 1;
    std::queue<Batch> empty;
    std::swap(L->ring, empty);
    L->start();
}

void loader_destroy(void* h) {
    delete static_cast<Loader*>(h);
}

}  // extern "C"
