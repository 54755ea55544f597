// cuda_fake.cc — a fake CUDA driver (libcuda) for the CPU tests of the
// CUDA device plane (cuda_plane.cc), modelled on native/src/pjrt_fake.cc:
// the plane calls about twenty driver entry points, and this library
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
//   TRPC_FAKE_CUDA_NO_PEER=1  cuDeviceCanAccessPeer says no for every pair
//   TRPC_FAKE_CUDA_NO_HOST_REGISTER=1   cuMemHostRegister_v2 refuses every
//                             range (CUDA_ERROR_NOT_PERMITTED), as a driver
//                             that may not page-lock that memory
//   TRPC_FAKE_CUDA_MEMORY_TYPE  what cuPointerGetAttribute says the
//                             fake's device memory is: "host" (default,
//                             CU_MEMORYTYPE_HOST: it is host memory) or
//                             "device" (CU_MEMORYTYPE_DEVICE, as a real
//                             card's, which a CPU process cannot view)
//
// Besides, for the tests (through ctypes on the same library):
//   trpc_fake_cuda_calls(name)          how often entry point `name` was
//                                       called in this process
//   trpc_fake_cuda_inject_oom(pool, n)  the next n cuMemAlloc_v2 (pool
//                                       "device") or cuMemHostAlloc
//                                       ("host") calls fail with
//                                       CUDA_ERROR_OUT_OF_MEMORY
//
// The fake also enforces rules of the real driver that a CPU run could
// otherwise not see, and aborts the process when one is broken: a host
// function may make no CUDA call (any entry point called on the
// completion thread); device memory or page-locked host memory must not
// be freed (nor a registered range unregistered) while a queued copy
// still uses it; and a device block may not be written, nor a
// page-locked host block or registered range used at all, by a new copy
// while an earlier copy on it is still pending (a pool that hands a
// block out again too early).  Registration is kept as the driver keeps
// it: cuMemHostRegister_v2 records its range and returns
// CUDA_ERROR_HOST_MEMORY_ALREADY_REGISTERED on an overlap with one it
// holds, and cuMemHostUnregister of a base it does not hold returns
// CUDA_ERROR_HOST_MEMORY_NOT_REGISTERED.  A device-to-device copy's
// source may lie outside every allocation of the fake: memory of another
// allocator in the same context (PyTorch's, which over the fake is host
// memory), which the fake cannot police; its destination may not.
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
#include <iterator>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

typedef int CUresult;
typedef unsigned long long CUdeviceptr;
typedef void (*CUhostFn)(void*);

constexpr CUresult kOk = 0;
constexpr CUresult kInvalidValue = 1;
constexpr CUresult kOutOfMemory = 2;
constexpr CUresult kPeerAlreadyEnabled = 704;
constexpr CUresult kHostAlreadyRegistered = 712;
constexpr CUresult kHostNotRegistered = 713;
constexpr CUresult kNotPermitted = 800;
constexpr CUresult kInvalidContext = 201;
constexpr CUresult kInjected = 999;
constexpr int kAttrMemoryType = 2;     // CU_POINTER_ATTRIBUTE_MEMORY_TYPE
constexpr int kAttrDeviceOrdinal = 9;  // CU_POINTER_ATTRIBUTE_DEVICE_ORDINAL
constexpr unsigned kMemoryTypeHost = 1;
constexpr unsigned kMemoryTypeDevice = 2;

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
  int dev = 0;      // device memory: the device of its context
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
// page-locked host blocks from cuMemHostAlloc, by address
std::map<CUdeviceptr, Alloc>& host_allocs() {
  static std::map<CUdeviceptr, Alloc>* m = new std::map<CUdeviceptr, Alloc>();
  return *m;
}
// host ranges registered with cuMemHostRegister_v2, by base
std::map<CUdeviceptr, Alloc>& registered() {
  static std::map<CUdeviceptr, Alloc>* m = new std::map<CUdeviceptr, Alloc>();
  return *m;
}
// ordered (from, to) device pairs with peer access enabled
std::map<std::pair<int, int>, bool>& peers() {
  static auto* m = new std::map<std::pair<int, int>, bool>();
  return *m;
}

std::mutex& calls_mu() {
  static std::mutex* m = new std::mutex();
  return *m;
}
std::map<std::string, unsigned long long>& calls() {
  static auto* m = new std::map<std::string, unsigned long long>();
  return *m;
}

std::atomic<int> g_oom_device{0}, g_oom_host{0};

thread_local FakeCtx* tl_current = nullptr;
thread_local bool tl_completion_thread = false;

// Every entry point starts here: counted, and refused on the completion
// thread.
void guard(const char* fn) {
  if (tl_completion_thread) {
    fprintf(stderr, "fake CUDA driver: %s called from a host function\n", fn);
    abort();
  }
  std::lock_guard<std::mutex> lk(calls_mu());
  calls()[fn]++;
}

// Take one injected failure off `budget`, if any is left.
bool take_injected(std::atomic<int>& budget) {
  int left = budget.load();
  while (left > 0 && !budget.compare_exchange_weak(left, left - 1)) {
  }
  return left > 0;
}

// An allocation of `m` that holds [p, p+n), or nullptr.  Caller holds
// mu().
Alloc* find_in(std::map<CUdeviceptr, Alloc>& m, CUdeviceptr p, size_t n) {
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

Alloc* find_alloc(CUdeviceptr p, size_t n) { return find_in(allocs(), p, n); }

[[noreturn]] void broken(const char* rule) {
  fprintf(stderr, "fake CUDA driver: %s\n", rule);
  abort();
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

// Whether [p, p+n) lies in a device allocation of the fake.
bool tracked(CUdeviceptr p, size_t n) {
  std::lock_guard<std::mutex> lk(mu());
  return find_alloc(p, n) != nullptr;
}

// Queue an operation `op` on n bytes (a copy or a fill); `dev_ptrs` are
// the device allocations it touches, the first of them written when
// `writes_dev`, and `host` the host side (a page-locked block, or
// pageable memory, which is not tracked).  Each is held pending until
// the operation ran.
CUresult queue_op(FakeStream* s, std::function<void()> op, size_t n,
                  std::vector<CUdeviceptr> dev_ptrs, bool writes_dev,
                  const void* host, bool fail_async) {
  Alloc* pinned = nullptr;
  {
    std::lock_guard<std::mutex> lk(mu());
    for (size_t i = 0; i < dev_ptrs.size(); ++i) {
      Alloc* a = find_alloc(dev_ptrs[i], n);
      if (a == nullptr) {
        return kInvalidValue;
      }
      if (i == 0 && writes_dev && a->pending != 0) {
        broken("a device block written while a copy on it is pending");
      }
    }
    if (host != nullptr) {
      pinned = find_in(host_allocs(), (CUdeviceptr)host, n);
      if (pinned == nullptr) {
        pinned = find_in(registered(), (CUdeviceptr)host, n);
      }
      if (pinned != nullptr && pinned->pending != 0) {
        broken("a page-locked host block reused while a copy on it is "
               "pending");
      }
    }
    for (CUdeviceptr p : dev_ptrs) {
      find_alloc(p, n)->pending++;
    }
    if (pinned != nullptr) {
      pinned->pending++;
    }
  }
  schedule([s, op, n, dev_ptrs, pinned, fail_async]() {
    op();
    std::lock_guard<std::mutex> lk(mu());
    for (CUdeviceptr p : dev_ptrs) {
      find_alloc(p, n)->pending--;
    }
    if (pinned != nullptr) {  // (no pending entry is ever erased)
      pinned->pending--;
    }
    if (fail_async) {
      s->async_err = kInjected;
    }
  });
  return kOk;
}

// Queue a copy of n bytes from src to dst (queue_op's rules).
CUresult queue_copy(FakeStream* s, void* dst, const void* src, size_t n,
                    std::vector<CUdeviceptr> dev_ptrs, bool writes_dev,
                    const void* host, bool fail_async) {
  return queue_op(
      s, [dst, src, n]() { memcpy(dst, src, n); }, n, std::move(dev_ptrs),
      writes_dev, host, fail_async);
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

CUresult cuDeviceCanAccessPeer(int* can, int dev, int peer) {
  guard("cuDeviceCanAccessPeer");
  std::lock_guard<std::mutex> lk(mu());
  int n = (int)ctxs().size();
  if (dev < 0 || dev >= n || peer < 0 || peer >= n) {
    return kInvalidValue;
  }
  *can = dev != peer && env_i64("TRPC_FAKE_CUDA_NO_PEER", 0) == 0;
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

CUresult cuCtxEnablePeerAccess(void* peer, unsigned) {
  guard("cuCtxEnablePeerAccess");
  if (tl_current == nullptr || peer == nullptr) {
    return kInvalidContext;
  }
  std::lock_guard<std::mutex> lk(mu());
  bool& on = peers()[{tl_current->dev, ((FakeCtx*)peer)->dev}];
  if (on) {
    return kPeerAlreadyEnabled;
  }
  on = true;
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
  if (take_injected(g_oom_device)) {
    return kOutOfMemory;
  }
  void* p = malloc(n == 0 ? 1 : n);
  std::lock_guard<std::mutex> lk(mu());
  allocs()[(CUdeviceptr)p] = Alloc{n, 0, tl_current->dev};
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
    broken("cuMemFree_v2 under a pending copy");
  }
  allocs().erase(it);
  free((void*)p);
  return kOk;
}

CUresult cuMemHostAlloc(void** out, size_t n, unsigned) {
  guard("cuMemHostAlloc");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  if (take_injected(g_oom_host)) {
    return kOutOfMemory;
  }
  void* p = malloc(n == 0 ? 1 : n);
  std::lock_guard<std::mutex> lk(mu());
  host_allocs()[(CUdeviceptr)p] = Alloc{n, 0};
  *out = p;
  return kOk;
}

CUresult cuMemFreeHost(void* p) {
  guard("cuMemFreeHost");
  std::lock_guard<std::mutex> lk(mu());
  auto it = host_allocs().find((CUdeviceptr)p);
  if (it == host_allocs().end()) {
    return kInvalidValue;
  }
  if (it->second.pending != 0) {
    broken("cuMemFreeHost under a pending copy");
  }
  host_allocs().erase(it);
  free(p);
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
  return queue_copy((FakeStream*)stream, (void*)dst, src, n, {dst}, true,
                    src, fail_mode("ready"));
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
  return queue_copy(s, dst, (const void*)src, n, {src}, false, dst,
                    fail_mode("d2h"));
}

CUresult cuMemcpyDtoDAsync_v2(CUdeviceptr dst, CUdeviceptr src, size_t n,
                              void* stream) {
  guard("cuMemcpyDtoDAsync_v2");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  std::vector<CUdeviceptr> dev_ptrs{dst};
  if (tracked(src, n)) {
    dev_ptrs.push_back(src);
  }
  return queue_copy((FakeStream*)stream, (void*)dst, (const void*)src, n,
                    std::move(dev_ptrs), true, nullptr, false);
}

CUresult cuMemsetD8Async(CUdeviceptr dst, unsigned char value, size_t n,
                         void* stream) {
  guard("cuMemsetD8Async");
  if (tl_current == nullptr) {
    return kInvalidContext;
  }
  return queue_op(
      (FakeStream*)stream, [dst, value, n]() { memset((void*)dst, value, n); },
      n, {dst}, true, nullptr, false);
}

CUresult cuPointerGetAttribute(void* data, int attribute, CUdeviceptr p) {
  guard("cuPointerGetAttribute");
  std::lock_guard<std::mutex> lk(mu());
  Alloc* a = find_alloc(p, 1);
  if (a == nullptr || data == nullptr) {
    return kInvalidValue;
  }
  if (attribute == kAttrMemoryType) {
    const char* v = getenv("TRPC_FAKE_CUDA_MEMORY_TYPE");
    *(unsigned*)data = (v != nullptr && strcmp(v, "device") == 0)
                           ? kMemoryTypeDevice
                           : kMemoryTypeHost;
    return kOk;
  }
  if (attribute == kAttrDeviceOrdinal) {
    *(int*)data = a->dev;
    return kOk;
  }
  return kInvalidValue;
}

CUresult cuMemcpyPeerAsync(CUdeviceptr dst, void* dst_ctx, CUdeviceptr src,
                           void* src_ctx, size_t n, void* stream) {
  guard("cuMemcpyPeerAsync");
  if (dst_ctx == nullptr || src_ctx == nullptr) {
    return kInvalidContext;
  }
  return queue_copy((FakeStream*)stream, (void*)dst, (const void*)src, n,
                    {dst, src}, true, nullptr, false);
}

CUresult cuMemHostRegister_v2(void* p, size_t n, unsigned) {
  guard("cuMemHostRegister_v2");
  if (p == nullptr || n == 0) {
    return kInvalidValue;
  }
  if (env_i64("TRPC_FAKE_CUDA_NO_HOST_REGISTER", 0) != 0) {
    return kNotPermitted;
  }
  const CUdeviceptr base = (CUdeviceptr)p;
  std::lock_guard<std::mutex> lk(mu());
  auto it = registered().lower_bound(base + n);  // the first at or past the end
  if (it != registered().begin() &&
      std::prev(it)->first + std::prev(it)->second.len > base) {
    return kHostAlreadyRegistered;
  }
  registered()[base] = Alloc{n, 0};
  return kOk;
}

CUresult cuMemHostUnregister(void* p) {
  guard("cuMemHostUnregister");
  std::lock_guard<std::mutex> lk(mu());
  auto it = registered().find((CUdeviceptr)p);
  if (it == registered().end()) {
    return kHostNotRegistered;
  }
  if (it->second.pending != 0) {
    broken("cuMemHostUnregister under a pending copy");
  }
  registered().erase(it);
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
    case kOutOfMemory:
      *out = "out of memory";
      break;
    case kPeerAlreadyEnabled:
      *out = "peer access is already enabled";
      break;
    case kInvalidContext:
      *out = "invalid device context";
      break;
    case kHostAlreadyRegistered:
      *out = "part or all of the requested memory range is already mapped";
      break;
    case kHostNotRegistered:
      *out = "pointer does not correspond to a registered memory region";
      break;
    case kNotPermitted:
      *out = "operation not permitted";
      break;
    case kInjected:
      *out = "injected failure (fake CUDA driver)";
      break;
    default:
      *out = "unknown error (fake CUDA driver)";
  }
  return kOk;
}

unsigned long long trpc_fake_cuda_calls(const char* name) {
  std::lock_guard<std::mutex> lk(calls_mu());
  auto it = calls().find(name);
  return it == calls().end() ? 0 : it->second;
}

void trpc_fake_cuda_inject_oom(const char* pool, int n) {
  (strcmp(pool, "host") == 0 ? g_oom_host : g_oom_device).store(n);
}

}  // extern "C"
