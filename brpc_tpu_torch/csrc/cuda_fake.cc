// cuda_fake.cc — a fake CUDA driver (libcuda) for the CPU tests of the
// CUDA device plane (cuda_plane.cc), modelled on native/src/pjrt_fake.cc:
// the plane calls about sixteen driver entry points, and this library
// exports exactly those, by their versioned names, against host memory.
// Copies and host functions run in stream order on one background
// completion thread, so completions arrive on a foreign thread as they
// do from a real driver, and the fault knobs below reach the plane's
// error and timeout paths on any host.
//
// Knobs (read per operation, so a test can flip them between calls):
//   TRPC_FAKE_CUDA_DEVICES    device count (default 2)
//   TRPC_FAKE_CUDA_DELAY_US   delay before each queued operation runs
//                             (default 0: still asynchronous)
//   TRPC_FAKE_CUDA_FAIL       "h2d": cuMemcpyHtoDAsync_v2 fails at once;
//                             "ready": the h2d copy leaves an asynchronous
//                             error on its stream; "d2h": the same for
//                             the d2h copy (both read by cuStreamQuery)
//   TRPC_FAKE_CUDA_DROP_D2H_EVENT=1   the next d2h copy never happens and
//                             its host function never runs
//
// The fake also enforces two rules of the real driver that a CPU run
// could otherwise not see: a host function may make no CUDA call (any
// entry point called on the completion thread aborts the process), and
// device memory must not be freed while a queued copy still uses it.
//
// Not a CUDA implementation: no kernels, no modules, no events.

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

namespace {

typedef int CUresult;
typedef unsigned long long CUdeviceptr;
typedef void (*CUhostFn)(void*);

constexpr CUresult kOk = 0;
constexpr CUresult kInvalidValue = 1;
constexpr CUresult kInvalidContext = 201;
constexpr CUresult kInjected = 999;

struct FakeCtx {
  int dev = 0;
};

struct FakeStream {
  int dev = 0;
  CUresult async_err = kOk;      // reported (once) by cuStreamQuery
  bool drop_next_host_fn = false;
};

struct Alloc {
  size_t len = 0;
  int pending = 0;  // queued copies that still read or write it
};

int64_t env_i64(const char* name, int64_t dflt) {
  const char* v = getenv(name);
  return (v != nullptr && v[0] != '\0') ? strtoll(v, nullptr, 10) : dflt;
}

bool fail_mode(const char* what) {
  const char* v = getenv("TRPC_FAKE_CUDA_FAIL");
  return v != nullptr && strcmp(v, what) == 0;
}

int64_t now_us() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000 + ts.tv_nsec / 1000;
}

// Cross-thread singletons are leaked on purpose: the detached completion
// thread outlives main().
std::mutex& mu() {
  static std::mutex* m = new std::mutex();
  return *m;
}
std::vector<FakeCtx*>& ctxs() {
  static std::vector<FakeCtx*>* v = new std::vector<FakeCtx*>();
  return *v;
}
std::map<CUdeviceptr, Alloc>& allocs() {
  static std::map<CUdeviceptr, Alloc>* m = new std::map<CUdeviceptr, Alloc>();
  return *m;
}

thread_local FakeCtx* tl_current = nullptr;
thread_local bool tl_completion_thread = false;

void guard(const char* fn) {
  if (tl_completion_thread) {
    fprintf(stderr, "fake CUDA driver: %s called from a host function\n", fn);
    abort();
  }
}

// An allocation that holds [p, p+n), or nullptr.  Caller holds mu().
Alloc* find_alloc(CUdeviceptr p, size_t n) {
  auto& m = allocs();
  auto it = m.upper_bound(p);
  if (it == m.begin()) {
    return nullptr;
  }
  --it;
  if (p + n > it->first + it->second.len) {
    return nullptr;
  }
  return &it->second;
}

// --- completion thread (FIFO over all streams: stream order holds) --------

struct Job {
  int64_t at_us;
  std::function<void()> fn;
};

std::mutex& jobs_mu() {
  static std::mutex* m = new std::mutex();
  return *m;
}
std::condition_variable& jobs_cv() {
  static std::condition_variable* cv = new std::condition_variable();
  return *cv;
}
std::deque<Job>& jobs() {
  static std::deque<Job>* q = new std::deque<Job>();
  return *q;
}
bool g_worker_up = false;

void worker_loop() {
  tl_completion_thread = true;
  std::deque<Job>& q = jobs();
  std::unique_lock<std::mutex> lk(jobs_mu());
  while (true) {
    if (q.empty()) {
      jobs_cv().wait(lk);
      continue;
    }
    int64_t wait = q.front().at_us - now_us();
    if (wait > 0) {
      jobs_cv().wait_for(lk, std::chrono::microseconds(wait));
      continue;
    }
    Job j = std::move(q.front());
    q.pop_front();
    lk.unlock();
    j.fn();
    lk.lock();
  }
}

void schedule(std::function<void()> fn) {
  int64_t at = now_us() + env_i64("TRPC_FAKE_CUDA_DELAY_US", 0);
  {
    std::lock_guard<std::mutex> lk(jobs_mu());
    if (!g_worker_up) {
      g_worker_up = true;
      std::thread(worker_loop).detach();
    }
    // FIFO: a later job never runs before an earlier one
    if (!jobs().empty() && jobs().back().at_us > at) {
      at = jobs().back().at_us;
    }
    jobs().push_back(Job{at, std::move(fn)});
  }
  jobs_cv().notify_one();
}

// Queue a copy of n bytes; `dev_ptrs` are the device allocations it
// touches (held pending until it ran).
CUresult queue_copy(FakeStream* s, void* dst, const void* src, size_t n,
                    std::vector<CUdeviceptr> dev_ptrs, bool fail_async) {
  {
    std::lock_guard<std::mutex> lk(mu());
    for (CUdeviceptr p : dev_ptrs) {
      Alloc* a = find_alloc(p, n);
      if (a == nullptr) {
        return kInvalidValue;
      }
      a->pending++;
    }
  }
  schedule([s, dst, src, n, dev_ptrs, fail_async]() {
    memcpy(dst, src, n);
    std::lock_guard<std::mutex> lk(mu());
    for (CUdeviceptr p : dev_ptrs) {
      find_alloc(p, n)->pending--;
    }
    if (fail_async) {
      s->async_err = kInjected;
    }
  });
  return kOk;
}

}  // namespace

extern "C" {

CUresult cuInit(unsigned) {
  guard("cuInit");
  std::lock_guard<std::mutex> lk(mu());
  if (ctxs().empty()) {
    int n = (int)env_i64("TRPC_FAKE_CUDA_DEVICES", 2);
    for (int i = 0; i < (n < 1 ? 1 : n); ++i) {
      ctxs().push_back(new FakeCtx{i});
    }
  }
  return kOk;
}

CUresult cuDeviceGetCount(int* n) {
  guard("cuDeviceGetCount");
  std::lock_guard<std::mutex> lk(mu());
  *n = (int)ctxs().size();
  return kOk;
}

CUresult cuDeviceGet(int* dev, int ordinal) {
  guard("cuDeviceGet");
  std::lock_guard<std::mutex> lk(mu());
  if (ordinal < 0 || ordinal >= (int)ctxs().size()) {
    return kInvalidValue;
  }
  *dev = ordinal;
  return kOk;
}

CUresult cuDevicePrimaryCtxRetain(void** ctx, int dev) {
  guard("cuDevicePrimaryCtxRetain");
  std::lock_guard<std::mutex> lk(mu());
  if (dev < 0 || dev >= (int)ctxs().size()) {
    return kInvalidValue;
  }
  *ctx = ctxs()[dev];
  return kOk;
}

CUresult cuCtxGetCurrent(void** ctx) {
  guard("cuCtxGetCurrent");
  *ctx = tl_current;
  return kOk;
}

CUresult cuCtxSetCurrent(void* ctx) {
  guard("cuCtxSetCurrent");
  tl_current = (FakeCtx*)ctx;
  return kOk;
}

CUresult cuStreamCreate(void** stream, unsigned) {
  guard("cuStreamCreate");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  *stream = new FakeStream{tl_current->dev};
  return kOk;
}

CUresult cuStreamQuery(void* stream) {
  guard("cuStreamQuery");
  FakeStream* s = (FakeStream*)stream;
  std::lock_guard<std::mutex> lk(mu());
  CUresult rc = s->async_err;
  s->async_err = kOk;
  return rc;
}

CUresult cuMemAlloc_v2(CUdeviceptr* out, size_t n) {
  guard("cuMemAlloc_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  void* p = malloc(n == 0 ? 1 : n);
  std::lock_guard<std::mutex> lk(mu());
  allocs()[(CUdeviceptr)p] = Alloc{n, 0};
  *out = (CUdeviceptr)p;
  return kOk;
}

CUresult cuMemFree_v2(CUdeviceptr p) {
  guard("cuMemFree_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  std::lock_guard<std::mutex> lk(mu());
  auto it = allocs().find(p);
  if (it == allocs().end()) {
    return kInvalidValue;
  }
  if (it->second.pending != 0) {
    fprintf(stderr, "fake CUDA driver: cuMemFree_v2 under a pending copy\n");
    abort();
  }
  allocs().erase(it);
  free((void*)p);
  return kOk;
}

CUresult cuMemcpyHtoDAsync_v2(CUdeviceptr dst, const void* src, size_t n,
                              void* stream) {
  guard("cuMemcpyHtoDAsync_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  if (fail_mode("h2d")) {
    return kInjected;
  }
  return queue_copy((FakeStream*)stream, (void*)dst, src, n, {dst},
                    fail_mode("ready"));
}

CUresult cuMemcpyDtoHAsync_v2(void* dst, CUdeviceptr src, size_t n,
                              void* stream) {
  guard("cuMemcpyDtoHAsync_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  FakeStream* s = (FakeStream*)stream;
  if (env_i64("TRPC_FAKE_CUDA_DROP_D2H_EVENT", 0) != 0) {
    std::lock_guard<std::mutex> lk(mu());
    s->drop_next_host_fn = true;  // a wedged copy: nothing ever lands
    return kOk;
  }
  return queue_copy(s, dst, (const void*)src, n, {src}, fail_mode("d2h"));
}

CUresult cuMemcpyDtoDAsync_v2(CUdeviceptr dst, CUdeviceptr src, size_t n,
                              void* stream) {
  guard("cuMemcpyDtoDAsync_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  return queue_copy((FakeStream*)stream, (void*)dst, (const void*)src, n,
                    {dst, src}, false);
}

CUresult cuMemcpyPeerAsync(CUdeviceptr dst, void* dst_ctx, CUdeviceptr src,
                           void* src_ctx, size_t n, void* stream) {
  guard("cuMemcpyPeerAsync");
  if (dst_ctx == nullptr || src_ctx == nullptr) {
    return kInvalidContext;
  }
  return queue_copy((FakeStream*)stream, (void*)dst, (const void*)src, n,
                    {dst, src}, false);
}

CUresult cuMemHostRegister_v2(void*, size_t, unsigned) {
  guard("cuMemHostRegister_v2");
  return kOk;
}

CUresult cuMemHostUnregister(void*) {
  guard("cuMemHostUnregister");
  return kOk;
}

CUresult cuLaunchHostFunc(void* stream, CUhostFn fn, void* user) {
  guard("cuLaunchHostFunc");
  FakeStream* s = (FakeStream*)stream;
  {
    std::lock_guard<std::mutex> lk(mu());
    if (s->drop_next_host_fn) {
      s->drop_next_host_fn = false;
      return kOk;  // registered into the void, never runs
    }
  }
  schedule([fn, user]() { fn(user); });
  return kOk;
}

CUresult cuGetErrorString(CUresult rc, const char** out) {
  guard("cuGetErrorString");
  switch (rc) {
    case kOk:
      *out = "no error";
      break;
    case kInvalidValue:
      *out = "invalid argument";
      break;
    case kInvalidContext:
      *out = "invalid device context";
      break;
    case kInjected:
      *out = "injected failure (fake CUDA driver)";
      break;
    default:
      *out = "unknown error (fake CUDA driver)";
  }
  return kOk;
}

}  // extern "C"
