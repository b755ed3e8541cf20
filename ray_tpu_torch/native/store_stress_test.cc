// Concurrency stress test for the shm object store, built under
// TSAN/ASAN by the test suite.
//
// Ref analog: the reference's sanitizer strategy (SURVEY.md §4.7 —
// .bazelrc asan/tsan configs run the C++ unit tests instrumented).
// Here: N threads hammer one store with create/seal/get/release/delete
// cycles over overlapping object-id spaces, plus an eviction thread,
// so the arena allocator, the object table, and the process-shared
// robust mutex see real contention. Exit 0 = no sanitizer report (the
// sanitizers abort non-zero on a finding).
//
// Build: native/build.py build_sanitized(["store_stress_test.cc",
// "shm_store.cc"], out_name, "thread" | "address"), into
// .build/ray_tpu_torch/native/; run it with an arena name of its own as
// its one argument (without one it makes a name from its pid).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {
void* shm_store_create(const char* name, uint64_t segment_size);
void shm_store_destroy(void* h, const char* name);
int64_t shm_store_create_object(void* h, const uint8_t* oid,
                                uint64_t data_size, uint64_t meta_size);
int shm_store_seal(void* h, const uint8_t* oid);
int shm_store_get(void* h, const uint8_t* oid, uint64_t* out);
int shm_store_release(void* h, const uint8_t* oid);
int shm_store_delete(void* h, const uint8_t* oid);
int shm_store_evict(void* h, uint64_t need, uint8_t* out_ids, int max_ids);
uint64_t shm_store_bytes_in_use(void* h);
}

namespace {

constexpr int kThreads = 8;
constexpr int kOpsPerThread = 4000;
constexpr int kIdSpace = 64;  // overlapping ids force table contention

void make_oid(uint8_t* buf, int thread_mod, int i) {
  // 20-byte binary ids like the Python side's ObjectID
  std::memset(buf, 0, 20);
  std::snprintf(reinterpret_cast<char*>(buf), 20, "t%02d-obj-%06d",
                thread_mod, i % kIdSpace);
}

void worker(void* h, int tid, std::atomic<int>* errors) {
  uint8_t oid[20];
  uint64_t out[3];
  for (int i = 0; i < kOpsPerThread; ++i) {
    // threads share an id space pairwise so create/get/delete race
    make_oid(oid, tid / 2, i);
    int64_t off = shm_store_create_object(h, oid, 256 + (i % 1024), 16);
    if (off > 0) {
      if (shm_store_seal(h, oid) != 0) {
        // a racing thread deleted it between create and seal: legal
      }
    }
    if (shm_store_get(h, oid, out) == 0) {
      shm_store_release(h, oid);
    }
    if (i % 7 == 0) shm_store_delete(h, oid);
  }
  (void)errors;
}

}  // namespace

int main(int argc, char** argv) {
  // Creating an arena unlinks any of the same name, so each run takes
  // its own: the name given as argv[1], else one made from the pid.
  char pid_name[64];
  std::snprintf(pid_name, sizeof pid_name, "rtpu_torch_stress_%ld",
                static_cast<long>(getpid()));
  const char* name = argc > 1 ? argv[1] : pid_name;
  void* h = shm_store_create(name, 16ull << 20);
  if (!h) {
    std::fprintf(stderr, "store create failed\n");
    return 2;
  }
  std::atomic<int> errors{0};
  std::vector<std::thread> threads;
  threads.reserve(kThreads + 1);
  for (int t = 0; t < kThreads; ++t)
    threads.emplace_back(worker, h, t, &errors);
  // eviction pressure concurrent with the object churn
  std::thread evictor([h] {
    uint8_t evicted[20 * 64];
    for (int i = 0; i < 200; ++i) {
      shm_store_evict(h, 1 << 20, evicted, 64);
      std::this_thread::yield();
    }
  });
  for (auto& t : threads) t.join();
  evictor.join();
  uint64_t used = shm_store_bytes_in_use(h);
  shm_store_destroy(h, name);
  std::printf("ok used=%llu errors=%d\n",
              static_cast<unsigned long long>(used), errors.load());
  return errors.load() == 0 ? 0 : 1;
}
