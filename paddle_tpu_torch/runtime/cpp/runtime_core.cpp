// paddle_tpu_torch native runtime core: the port's own copy of
// paddle_tpu/runtime/cpp/runtime_core.cpp (host code, unchanged).
//
// Counterpart of Paddle's C++ reader/feeder machinery
// (paddle/fluid/operators/reader/buffered_reader.cc + blocking_queue.h):
// a bounded MPMC ring buffer used by the DataLoader to overlap host-side
// batch assembly with device compute, and a multithreaded memcpy batch
// collator (large numeric batches bypass numpy's single-threaded
// np.stack). The ms_* multislot reader serves distributed/ps_dataset.py,
// which the port does not have yet (ROADMAP.md queue A, item A.13).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11).
#include <atomic>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <locale.h>
#include <chrono>
#include <cstdlib>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------- bounded MPMC ring buffer of opaque handles ------------
struct RingBuffer {
    std::deque<uint64_t> items;
    size_t capacity;
    bool closed = false;
    std::mutex mu;
    std::condition_variable not_full;
    std::condition_variable not_empty;
};

void* rb_create(size_t capacity) {
    auto* rb = new RingBuffer();
    rb->capacity = capacity ? capacity : 1;
    return rb;
}

// returns 0 on success, -1 if closed
int rb_push(void* handle, uint64_t item, int timeout_ms) {
    auto* rb = static_cast<RingBuffer*>(handle);
    std::unique_lock<std::mutex> lk(rb->mu);
    auto pred = [rb] { return rb->closed || rb->items.size() < rb->capacity; };
    if (timeout_ms > 0) {
        if (!rb->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred))
            return -2;  // timeout
    } else {
        rb->not_full.wait(lk, pred);
    }
    if (rb->closed) return -1;
    rb->items.push_back(item);
    rb->not_empty.notify_one();
    return 0;
}

// returns 0 on success, -1 if closed+empty, -2 on timeout
int rb_pop(void* handle, uint64_t* out, int timeout_ms) {
    auto* rb = static_cast<RingBuffer*>(handle);
    std::unique_lock<std::mutex> lk(rb->mu);
    auto pred = [rb] { return rb->closed || !rb->items.empty(); };
    if (timeout_ms > 0) {
        if (!rb->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred))
            return -2;
    } else {
        rb->not_empty.wait(lk, pred);
    }
    if (rb->items.empty()) return -1;  // closed and drained
    *out = rb->items.front();
    rb->items.pop_front();
    rb->not_full.notify_one();
    return 0;
}

void rb_close(void* handle) {
    auto* rb = static_cast<RingBuffer*>(handle);
    {
        std::lock_guard<std::mutex> lk(rb->mu);
        rb->closed = true;
    }
    rb->not_full.notify_all();
    rb->not_empty.notify_all();
}

size_t rb_size(void* handle) {
    auto* rb = static_cast<RingBuffer*>(handle);
    std::lock_guard<std::mutex> lk(rb->mu);
    return rb->items.size();
}

void rb_destroy(void* handle) {
    delete static_cast<RingBuffer*>(handle);
}

// ---------------- multithreaded batch collation ------------------------
// Stack n_samples buffers of item_bytes each into dst (contiguous).
// Released-GIL callers get parallel memcpy across worker threads.
void fast_stack(const void** srcs, size_t n_samples, size_t item_bytes,
                void* dst, int n_threads) {
    if (n_threads <= 1 || n_samples < 4) {
        for (size_t i = 0; i < n_samples; ++i) {
            std::memcpy(static_cast<char*>(dst) + i * item_bytes, srcs[i],
                        item_bytes);
        }
        return;
    }
    std::vector<std::thread> threads;
    size_t per = (n_samples + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        size_t lo = t * per;
        size_t hi = lo + per < n_samples ? lo + per : n_samples;
        if (lo >= hi) break;
        threads.emplace_back([=] {
            for (size_t i = lo; i < hi; ++i) {
                std::memcpy(static_cast<char*>(dst) + i * item_bytes,
                            srcs[i], item_bytes);
            }
        });
    }
    for (auto& th : threads) th.join();
}

// ---------------- host pinned-staging copy (device feed) ----------------
// Chunked parallel memcpy used when staging a large batch into the
// transfer buffer handed to PjRt.
void parallel_copy(const void* src, void* dst, size_t nbytes,
                   int n_threads) {
    if (n_threads <= 1 || nbytes < (1u << 20)) {
        std::memcpy(dst, src, nbytes);
        return;
    }
    std::vector<std::thread> threads;
    size_t per = (nbytes + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        size_t lo = t * per;
        size_t hi = lo + per < nbytes ? lo + per : nbytes;
        if (lo >= hi) break;
        threads.emplace_back([=] {
            std::memcpy(static_cast<char*>(dst) + lo,
                        static_cast<const char*>(src) + lo, hi - lo);
        });
    }
    for (auto& th : threads) th.join();
}

// ---------------- MultiSlot in-memory dataset engine --------------------
// Native counterpart of the reference's MultiSlotInMemoryDataFeed
// (paddle/fluid/framework/data_feed.cc): parse "<n> v1..vn <m> u1..um"
// text records into per-slot CSR arrays with parallel worker threads,
// shuffle by permutation, and fill contiguous batch buffers for numpy.
// Slot types: 0 = float32, 1 = int64.

struct MSSlot {
    std::vector<float> fvals;
    std::vector<int64_t> ivals;
    std::vector<uint64_t> offsets;  // per-record value counts -> prefix sums
};

struct MSDataset {
    int n_slots;
    std::vector<int> types;
    std::vector<MSSlot> slots;   // offsets.size() == n_records + 1
    uint64_t n_records = 0;
    std::vector<uint64_t> perm;  // shuffle permutation over records
    std::mutex mu;
};

namespace {

// number parsing must be locale-independent (an embedding host may have
// set a comma-decimal LC_NUMERIC); one cached "C" locale for strtof_l
locale_t c_numeric_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

// Parse one chunk of complete lines into a thread-local shard.
// Returns false on malformed input. One record per line: a line with
// missing/extra slots is an error (like the reference's CheckFile),
// never silently merged with its neighbours.
bool ms_parse_chunk(const char* p, const char* end, int n_slots,
                    const int* types, std::vector<MSSlot>& shard,
                    uint64_t& n_records) {
    auto skip_sp = [&] {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
            ++p;
    };
    auto skip_blank_lines = [&] {
        while (p < end) {
            skip_sp();
            if (p < end && *p == '\n') { ++p; continue; }
            break;
        }
    };
    while (true) {
        skip_blank_lines();
        if (p >= end) return true;
        for (int s = 0; s < n_slots; ++s) {
            skip_sp();
            if (p >= end || *p == '\n') return false;  // short line
            int64_t n = 0;
            auto rc = std::from_chars(p, end, n);
            if (rc.ec != std::errc() || n < 0) return false;
            p = rc.ptr;
            MSSlot& sl = shard[s];
            for (int64_t i = 0; i < n; ++i) {
                skip_sp();
                if (p >= end || *p == '\n') return false;  // short line
                if (types[s] == 1) {
                    int64_t v = 0;
                    auto r = std::from_chars(p, end, v);
                    if (r.ec != std::errc()) return false;
                    p = r.ptr;
                    sl.ivals.push_back(v);
                } else {
                    // strtof_l in the "C" locale, not std::from_chars:
                    // libstdc++ < 11 ships no floating-point from_chars
                    // overload, and plain strtof would misparse
                    // '.'-decimal data under a comma-decimal LC_NUMERIC
                    // set by an embedding host. The buffer is not
                    // NUL-terminated mid-chunk, but every chunk ends at
                    // a record boundary ('\n' <= end), so the parse
                    // always stops before running past `end`.
                    // strtof skips ANY leading whitespace (\n/\v/\f
                    // included) — guard so a short line can never
                    // silently consume a number from the next record
                    if (std::isspace(static_cast<unsigned char>(*p)))
                        return false;
                    char* stop = nullptr;
                    errno = 0;
                    float v = strtof_l(p, &stop, c_numeric_locale());
                    // ERANGE alone is not an error: glibc sets it on
                    // underflow to a (valid) subnormal too — only
                    // overflow to +/-HUGE_VALF is malformed input
                    if (stop == p || stop > end ||
                        (errno == ERANGE &&
                         (v == HUGE_VALF || v == -HUGE_VALF)))
                        return false;
                    p = stop;
                    sl.fvals.push_back(v);
                }
            }
            sl.offsets.push_back(static_cast<uint64_t>(n));
        }
        skip_sp();
        if (p < end && *p != '\n') return false;  // trailing tokens
        ++n_records;
    }
}

}  // namespace

void* ms_create(int n_slots, const int* types) {
    auto* ds = new MSDataset();
    ds->n_slots = n_slots;
    ds->types.assign(types, types + n_slots);
    ds->slots.resize(n_slots);
    for (auto& s : ds->slots) s.offsets.push_back(0);
    return ds;
}

// Parse `path` with n_threads workers; returns records added, -1 on error.
int64_t ms_load_file(void* handle, const char* path, int n_threads) {
    auto* ds = static_cast<MSDataset*>(handle);
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // non-seekable input (FIFO etc.) -> -1 so the Python reader takes over
    if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return -1; }
    long fsize = std::ftell(f);
    if (fsize < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    std::string buf(static_cast<size_t>(fsize), '\0');
    size_t got = std::fread(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    buf.resize(got);
    if (n_threads < 1) n_threads = 1;
    if (got < (1u << 16)) n_threads = 1;

    // split at line boundaries
    std::vector<const char*> starts{buf.data()};
    const char* bend = buf.data() + buf.size();
    for (int t = 1; t < n_threads; ++t) {
        const char* p = buf.data() + buf.size() * t / n_threads;
        while (p < bend && *p != '\n') ++p;
        starts.push_back(p < bend ? p + 1 : bend);
    }
    starts.push_back(bend);

    int nt = static_cast<int>(starts.size()) - 1;
    std::vector<std::vector<MSSlot>> shards(nt);
    std::vector<uint64_t> counts(nt, 0);
    std::vector<char> ok(nt, 1);
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) {
        shards[t].resize(ds->n_slots);
        threads.emplace_back([&, t] {
            ok[t] = ms_parse_chunk(starts[t], starts[t + 1], ds->n_slots,
                                   ds->types.data(), shards[t], counts[t])
                        ? 1 : 0;
        });
    }
    for (auto& th : threads) th.join();
    for (int t = 0; t < nt; ++t)
        if (!ok[t]) return -1;

    std::lock_guard<std::mutex> lk(ds->mu);
    uint64_t added = 0;
    for (int t = 0; t < nt; ++t) {
        for (int s = 0; s < ds->n_slots; ++s) {
            MSSlot& dst = ds->slots[s];
            MSSlot& src = shards[t][s];
            uint64_t base = dst.offsets.back();
            for (uint64_t c : src.offsets)
                dst.offsets.push_back(base += c);
            if (ds->types[s] == 1)
                dst.ivals.insert(dst.ivals.end(), src.ivals.begin(),
                                 src.ivals.end());
            else
                dst.fvals.insert(dst.fvals.end(), src.fvals.begin(),
                                 src.fvals.end());
        }
        added += counts[t];
    }
    ds->n_records += added;
    ds->perm.resize(ds->n_records);
    for (uint64_t i = 0; i < ds->n_records; ++i) ds->perm[i] = i;
    return static_cast<int64_t>(added);
}

void ms_shuffle(void* handle, uint64_t seed) {
    auto* ds = static_cast<MSDataset*>(handle);
    std::lock_guard<std::mutex> lk(ds->mu);
    std::mt19937_64 rng(seed);
    for (uint64_t i = ds->n_records; i > 1; --i) {
        uint64_t j = rng() % i;
        std::swap(ds->perm[i - 1], ds->perm[j]);
    }
}

uint64_t ms_num_records(void* handle) {
    return static_cast<MSDataset*>(handle)->n_records;
}

// Per-record value counts (post-permutation) for records
// [start, start+count); returns the total across the batch.
uint64_t ms_batch_lens(void* handle, uint64_t start, uint64_t count,
                       int slot, uint64_t* lens_out) {
    auto* ds = static_cast<MSDataset*>(handle);
    const MSSlot& sl = ds->slots[slot];
    uint64_t total = 0;
    for (uint64_t i = 0; i < count; ++i) {
        uint64_t r = ds->perm[start + i];
        uint64_t len = sl.offsets[r + 1] - sl.offsets[r];
        lens_out[i] = len;
        total += len;
    }
    return total;
}

// Concatenate slot values of records [start, start+count) into out
// (caller sized it via ms_batch_lens).
void ms_fill_batch_f32(void* handle, uint64_t start, uint64_t count,
                       int slot, float* out) {
    auto* ds = static_cast<MSDataset*>(handle);
    const MSSlot& sl = ds->slots[slot];
    for (uint64_t i = 0; i < count; ++i) {
        uint64_t r = ds->perm[start + i];
        uint64_t lo = sl.offsets[r], hi = sl.offsets[r + 1];
        std::memcpy(out, sl.fvals.data() + lo, (hi - lo) * sizeof(float));
        out += hi - lo;
    }
}

void ms_fill_batch_i64(void* handle, uint64_t start, uint64_t count,
                       int slot, int64_t* out) {
    auto* ds = static_cast<MSDataset*>(handle);
    const MSSlot& sl = ds->slots[slot];
    for (uint64_t i = 0; i < count; ++i) {
        uint64_t r = ds->perm[start + i];
        uint64_t lo = sl.offsets[r], hi = sl.offsets[r + 1];
        std::memcpy(out, sl.ivals.data() + lo,
                    (hi - lo) * sizeof(int64_t));
        out += hi - lo;
    }
}

void ms_release(void* handle) {
    auto* ds = static_cast<MSDataset*>(handle);
    std::lock_guard<std::mutex> lk(ds->mu);
    ds->slots.assign(ds->n_slots, MSSlot());
    for (auto& s : ds->slots) s.offsets.push_back(0);
    ds->n_records = 0;
    ds->perm.clear();
}

void ms_destroy(void* handle) {
    delete static_cast<MSDataset*>(handle);
}

}  // extern "C"
