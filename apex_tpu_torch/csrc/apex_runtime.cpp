// apex_tpu_torch native runtime -- host-side C++ pieces (a copy of the JAX
// package's apex_runtime.cpp, kept here so that the port imports nothing of
// that package).
//
// Reference mapping:
//  * flatten/unflatten: csrc/flatten_unflatten.cpp (apex_C) -- contiguous
//    bucket packing for gradient buckets / checkpoint IO, on the host, so
//    the hot copy loop is native and multithreaded.
//  * TokenLoader: the role DALI/torch DataLoader workers play in
//    examples/imagenet/main_amp.py:183-254 -- background threads stream
//    fixed-size batches from binary files into a ring of reusable buffers so
//    the accelerator never waits on host IO.
//
// Plain C ABI, bound with ctypes (apex_tpu_torch/csrc/runtime.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// flatten / unflatten (apex_C parity)
// ---------------------------------------------------------------------------

// Copy n buffers (sizes in bytes) into dst back-to-back. Spreads large
// copies over up to `threads` workers.
void apex_flatten(const void** srcs, const int64_t* sizes, int n, void* dst,
                  int threads) {
  std::vector<int64_t> offsets(n);
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    offsets[i] = total;
    total += sizes[i];
  }
  auto copy_range = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      std::memcpy(static_cast<char*>(dst) + offsets[i], srcs[i],
                  static_cast<size_t>(sizes[i]));
    }
  };
  int nt = threads > 1 && n > 1 ? (threads < n ? threads : n) : 1;
  if (nt == 1) {
    copy_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int lo = t * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

void apex_unflatten(const void* src, void** dsts, const int64_t* sizes, int n,
                    int threads) {
  std::vector<int64_t> offsets(n);
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    offsets[i] = total;
    total += sizes[i];
  }
  auto copy_range = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      std::memcpy(dsts[i], static_cast<const char*>(src) + offsets[i],
                  static_cast<size_t>(sizes[i]));
    }
  };
  int nt = threads > 1 && n > 1 ? (threads < n ? threads : n) : 1;
  if (nt == 1) {
    copy_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int lo = t * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// TokenLoader: threaded binary-file batch streamer
// ---------------------------------------------------------------------------

namespace {

struct TokenLoader {
  std::vector<std::string> files;
  int64_t batch_bytes = 0;
  bool loop = false;

  std::vector<std::vector<char>> ring;
  size_t head = 0, tail = 0;  // consumer reads head, producer writes tail
  size_t count = 0;
  bool done = false;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  std::thread worker;

  void produce() {
    std::vector<char> carry;
    carry.reserve(batch_bytes);
    do {
      int64_t pass_bytes = 0;  // guard: a fruitless pass must terminate,
                               // not spin (missing/empty files + loop=true)
      for (const auto& path : files) {
        FILE* f = std::fopen(path.c_str(), "rb");
        if (!f) continue;
        char buf[1 << 16];
        size_t got;
        while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) {
          pass_bytes += static_cast<int64_t>(got);
          size_t off = 0;
          while (off < got) {
            size_t want = static_cast<size_t>(batch_bytes) - carry.size();
            size_t take = got - off < want ? got - off : want;
            carry.insert(carry.end(), buf + off, buf + off + take);
            off += take;
            if (carry.size() == static_cast<size_t>(batch_bytes)) {
              std::unique_lock<std::mutex> lk(mu);
              not_full.wait(lk, [&] { return count < ring.size() || done; });
              if (done) {
                std::fclose(f);
                return;
              }
              ring[tail].swap(carry);
              tail = (tail + 1) % ring.size();
              ++count;
              lk.unlock();
              not_empty.notify_one();
              carry.clear();
              carry.reserve(batch_bytes);
            }
          }
        }
        std::fclose(f);
      }
      if (pass_bytes == 0) break;
    } while (loop && !done);
    std::unique_lock<std::mutex> lk(mu);
    done = true;
    lk.unlock();
    not_empty.notify_all();
  }
};

}  // namespace

void* tl_create(const char** paths, int n_files, int64_t batch_bytes,
                int n_buffers, int loop) {
  auto* tl = new TokenLoader();
  for (int i = 0; i < n_files; ++i) tl->files.emplace_back(paths[i]);
  tl->batch_bytes = batch_bytes;
  tl->loop = loop != 0;
  tl->ring.resize(n_buffers > 0 ? n_buffers : 2);
  for (auto& s : tl->ring) s.reserve(batch_bytes);
  tl->worker = std::thread(&TokenLoader::produce, tl);
  return tl;
}

// Copy the next batch into out. Returns 1 on success, 0 on end-of-data.
int tl_next(void* handle, void* out) {
  auto* tl = static_cast<TokenLoader*>(handle);
  std::unique_lock<std::mutex> lk(tl->mu);
  tl->not_empty.wait(lk, [&] { return tl->count > 0 || tl->done; });
  if (tl->count == 0) return 0;
  std::memcpy(out, tl->ring[tl->head].data(),
              static_cast<size_t>(tl->batch_bytes));
  tl->head = (tl->head + 1) % tl->ring.size();
  --tl->count;
  lk.unlock();
  tl->not_full.notify_one();
  return 1;
}

void tl_destroy(void* handle) {
  auto* tl = static_cast<TokenLoader*>(handle);
  {
    std::lock_guard<std::mutex> lk(tl->mu);
    tl->done = true;
  }
  tl->not_full.notify_all();
  tl->not_empty.notify_all();
  if (tl->worker.joinable()) tl->worker.join();
  delete tl;
}

}  // extern "C"
