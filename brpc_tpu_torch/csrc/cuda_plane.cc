// cuda_plane.cc — the device data plane of native/src/tpu.h on the CUDA
// driver API.  It replaces native/src/tpu.cc (the PJRT plane) in the
// port's core library; the tpu:// wire, the handshake and TpuPlaneStats
// are unchanged, so capi.cc, rpc.cc and stream.cc compile as they are.
//
// The driver is dlopen'd ($TRPC_CUDA_DRIVER, else libcuda.so.1) and the
// subset used here is declared below, so this file includes no CUDA
// header and builds with g++ anywhere.  The CPU tests bind the fake
// driver in cuda_fake.cc through the same names.
//
// Mapping from the PJRT plane (tpu.cc):
//   client + devices       -> each device's primary context (the one
//                             PyTorch uses) + one non-blocking stream
//   BufferFromHostBuffer   -> cuMemAlloc_v2 + cuMemcpyHtoDAsync_v2
//   ready / done events    -> one cuLaunchHostFunc after the copy: the
//                             source is released, 1 stored into the
//                             butex, waiters woken, the pin dropped
//   ToHostBuffer           -> cuMemcpyDtoHAsync_v2 into a landing zone,
//                             page-locked with cuMemHostRegister_v2 when
//                             the driver allows (else the driver copies
//                             it synchronously; the wait is the same)
//   CopyToDevice           -> cuMemcpyDtoDAsync_v2 on one device,
//                             cuMemcpyPeerAsync across devices
//   Buffer_Destroy         -> cuMemFree_v2 at the last pin
//
// Rules the design keeps:
//   * The current context is per OS thread, and the plane is called from
//     fiber workers, the usercode pool and Python threads: every driver
//     call runs inside a CtxScope, which makes the device's primary
//     context current and gives the thread back its own context (null
//     included) when it ends, on error paths too.  The plane moves none
//     of its caller's CUDA state, as the PJRT plane moves none.  No scope
//     spans a butex wait: a fiber may resume on another thread.
//   * A host function may make no CUDA call.  Completion only releases
//     the source, stores 1, wakes and unpins; a device free or a landing
//     zone unregister that falls due inside it is deferred to the next
//     plane entry point (drain_deferred).
//   * Waits park the fiber on the butex; no worker thread ever calls a
//     synchronizing driver function.  Asynchronous errors are read with
//     cuStreamQuery by the waiter, after the wake.
#include "tpu.h"

#include <dlfcn.h>
#include <errno.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <string>
#include <vector>

#include "fiber.h"
#include "heap_profiler.h"
#include "object_pool.h"
#include "uring.h"

namespace trpc {

namespace {
char* zc_host_alloc(size_t len) {
  void* p = uring_zc_alloc(len);
  return p != nullptr ? (char*)p : (char*)hp_malloc(len);
}

int64_t env_wait_budget_us(const char* name) {
  int64_t budget_us = 30 * 1000 * 1000;
  const char* bv = getenv(name);
  if (bv != nullptr && bv[0] != '\0') {
    int64_t v = strtoll(bv, nullptr, 10);
    if (v > 0) {
      budget_us = v;
    }
  }
  return budget_us;
}
}  // namespace

void tpu_host_free(void* p) {
  if (p != nullptr && !uring_zc_free(p)) {
    hp_free(p);
  }
}

int64_t tpu_d2d_timeout_us() {
  // parsed once per process (the d2h budget stays a per-call read, so a
  // test can change it between transfers)
  static const int64_t cached = env_wait_budget_us("TRPC_TPU_D2D_TIMEOUT_US");
  return cached;
}

namespace {

// --- the driver-API subset ---------------------------------------------------

typedef int CUresult;
typedef int CUdevice;
typedef struct CUctx_st* CUcontext;
typedef struct CUstream_st* CUstream;
typedef unsigned long long CUdeviceptr;
typedef void (*CUhostFn)(void* user);

constexpr CUresult CUDA_SUCCESS = 0;
constexpr CUresult CUDA_ERROR_NOT_READY = 600;
constexpr unsigned CU_STREAM_NON_BLOCKING = 1;
constexpr unsigned CU_MEMHOSTREGISTER_PORTABLE = 1;

struct Driver {
  CUresult (*Init)(unsigned);
  CUresult (*DeviceGetCount)(int*);
  CUresult (*DeviceGet)(CUdevice*, int);
  CUresult (*DevicePrimaryCtxRetain)(CUcontext*, CUdevice);
  CUresult (*CtxGetCurrent)(CUcontext*);
  CUresult (*CtxSetCurrent)(CUcontext);
  CUresult (*StreamCreate)(CUstream*, unsigned);
  CUresult (*StreamQuery)(CUstream);
  CUresult (*MemAlloc)(CUdeviceptr*, size_t);
  CUresult (*MemFree)(CUdeviceptr);
  CUresult (*MemcpyHtoDAsync)(CUdeviceptr, const void*, size_t, CUstream);
  CUresult (*MemcpyDtoHAsync)(void*, CUdeviceptr, size_t, CUstream);
  CUresult (*MemcpyDtoDAsync)(CUdeviceptr, CUdeviceptr, size_t, CUstream);
  CUresult (*MemcpyPeerAsync)(CUdeviceptr, CUcontext, CUdeviceptr, CUcontext,
                              size_t, CUstream);
  CUresult (*MemHostRegister)(void*, size_t, unsigned);
  CUresult (*MemHostUnregister)(void*);
  CUresult (*LaunchHostFunc)(CUstream, CUhostFn, void*);
  CUresult (*GetErrorString)(CUresult, const char**);
};

struct Sym {
  const char* name;
  void** slot;
  bool required;
};

struct Dev {
  CUdevice dev = 0;
  CUcontext ctx = nullptr;
  CUstream stream = nullptr;
};

// A device free or landing-zone release that fell due inside a host
// function, where no CUDA call may be made.
struct Deferred {
  int dev = 0;
  CUdeviceptr dptr = 0;
  void* host = nullptr;
  bool registered = false;
};

struct Plane {
  void* dso = nullptr;
  Driver d{};
  std::vector<Dev> devs;
  std::string error;
  std::atomic<bool> up{false};
  std::mutex init_mu;
  uint64_t uid = 0;

  std::mutex deferred_mu;
  std::vector<Deferred> deferred;
  std::atomic<bool> has_deferred{false};

  std::atomic<uint64_t> h2d_transfers{0}, d2h_transfers{0};
  std::atomic<uint64_t> h2d_bytes{0}, d2h_bytes{0};
  std::atomic<uint64_t> events_fired{0}, gather_copies{0};
  std::atomic<uint64_t> zero_copy_sends{0}, live_buffers{0}, errors{0};
  std::atomic<uint64_t> d2d_transfers{0}, d2d_bytes{0};
};

Plane& plane() {
  static Plane* p = new Plane();  // leaked on purpose
  return *p;
}

std::mutex& err_mu() {
  static std::mutex* m = new std::mutex();
  return *m;
}

void set_plane_error(std::string msg) {
  std::lock_guard<std::mutex> lk(err_mu());
  plane().error = std::move(msg);
}

std::string cu_error(const char* what, CUresult rc) {
  const char* s = nullptr;
  Plane& p = plane();
  if (p.d.GetErrorString == nullptr ||
      p.d.GetErrorString(rc, &s) != CUDA_SUCCESS || s == nullptr) {
    s = "unknown CUDA error";
  }
  return std::string(what) + ": " + s + " (CUresult " + std::to_string(rc) +
         ")";
}

// Device `dev`'s primary context, current on the calling thread while
// the scope lives; the thread's own context (or none) is current again
// when it ends.  ok() is false (and counted) when the switch failed.
class CtxScope {
 public:
  explicit CtxScope(int dev) {
    Plane& p = plane();
    CUcontext want = p.devs[dev].ctx;
    const char* what = "cuCtxGetCurrent";
    CUresult rc = p.d.CtxGetCurrent(&saved_);
    if (rc == CUDA_SUCCESS && saved_ != want) {
      what = "cuCtxSetCurrent";
      rc = p.d.CtxSetCurrent(want);
      switched_ = rc == CUDA_SUCCESS;
    }
    if (rc != CUDA_SUCCESS) {
      p.errors.fetch_add(1, std::memory_order_relaxed);
      set_plane_error(cu_error(what, rc));
    }
    ok_ = rc == CUDA_SUCCESS;
  }
  ~CtxScope() {
    if (switched_) {
      plane().d.CtxSetCurrent(saved_);
    }
  }
  CtxScope(const CtxScope&) = delete;
  CtxScope& operator=(const CtxScope&) = delete;
  bool ok() const { return ok_; }

 private:
  CUcontext saved_ = nullptr;
  bool switched_ = false;
  bool ok_ = false;
};

// Set while a host function runs on the driver's thread.
thread_local bool tl_in_host_fn = false;

struct HostFnScope {
  HostFnScope() { tl_in_host_fn = true; }
  ~HostFnScope() { tl_in_host_fn = false; }
};

void release_landing(void* mem, int dev, bool registered) {
  if (mem == nullptr) {
    return;
  }
  if (registered) {
    if (tl_in_host_fn) {
      Plane& p = plane();
      std::lock_guard<std::mutex> lk(p.deferred_mu);
      p.deferred.push_back(Deferred{dev, 0, mem, true});
      p.has_deferred.store(true, std::memory_order_release);
      return;
    }
    CtxScope ctx(dev);
    if (ctx.ok()) {
      plane().d.MemHostUnregister(mem);
    }
  }
  tpu_host_free(mem);
}

void free_device_mem(int dev, CUdeviceptr dptr) {
  Plane& p = plane();
  if (tl_in_host_fn) {
    std::lock_guard<std::mutex> lk(p.deferred_mu);
    p.deferred.push_back(Deferred{dev, dptr, nullptr, false});
    p.has_deferred.store(true, std::memory_order_release);
    return;
  }
  CtxScope ctx(dev);
  if (ctx.ok()) {
    p.d.MemFree(dptr);
  }
}

// Run the releases that fell due inside host functions.  Called at the
// top of the entry points that allocate or free.
void drain_deferred() {
  Plane& p = plane();
  if (!p.has_deferred.load(std::memory_order_acquire)) {
    return;
  }
  std::vector<Deferred> todo;
  {
    std::lock_guard<std::mutex> lk(p.deferred_mu);
    todo.swap(p.deferred);
    p.has_deferred.store(false, std::memory_order_release);
  }
  for (const Deferred& x : todo) {
    if (x.dptr != 0) {
      free_device_mem(x.dev, x.dptr);
    }
    if (x.host != nullptr) {
      release_landing(x.host, x.dev, x.registered);
    }
  }
}

// --- device buffers ----------------------------------------------------------

struct DeviceBuf {
  CUdeviceptr ptr = 0;
  int dev = 0;
  size_t len = 0;
  uint32_t slot = 0;
  std::atomic<uint32_t> version{1};
  Butex* ready = nullptr;  // 1 = resident on the device (or errored)
  std::atomic<int32_t> error{0};
  // 1 (owned by tpu_buf_free) + 1 per pending host function + 1 per
  // reader; the memory is freed and the slot recycled when it drains
  std::atomic<int32_t> pins{0};
  void (*release)(void*, void*) = nullptr;  // h2d source release hook
  void* release_arg = nullptr;
  void* release_data = nullptr;
  DeviceBuf* src_pin = nullptr;  // d2d: the source, held until the copy ends

  TpuBufId id() const {
    return ((uint64_t)version.load(std::memory_order_relaxed) << 32) | slot;
  }
};

void unpin_buf(DeviceBuf* b) {
  if (b->pins.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    if (b->ptr != 0) {
      free_device_mem(b->dev, b->ptr);
      b->ptr = 0;
      plane().live_buffers.fetch_sub(1, std::memory_order_relaxed);
    }
    ResourcePool<DeviceBuf>::Return(b->slot);
  }
}

DeviceBuf* pin_buf(TpuBufId id) {
  DeviceBuf* b = ResourcePool<DeviceBuf>::Address((uint32_t)id);
  if (b == nullptr) {
    return nullptr;
  }
  int32_t cur = b->pins.load(std::memory_order_acquire);
  do {
    if (cur <= 0) {
      return nullptr;
    }
  } while (!b->pins.compare_exchange_weak(cur, cur + 1,
                                          std::memory_order_acq_rel));
  if (b->version.load(std::memory_order_acquire) != (uint32_t)(id >> 32)) {
    unpin_buf(b);
    return nullptr;
  }
  return b;
}

// A fresh slot, armed (not ready) with the free's pin and the host
// function's pin.
DeviceBuf* arm_buf(CUdeviceptr ptr, int dev, size_t len) {
  DeviceBuf* b = nullptr;
  uint32_t slot = ResourcePool<DeviceBuf>::Get(&b);
  b->slot = slot;
  if (b->ready == nullptr) {
    b->ready = butex_create();
  }
  butex_value(b->ready).store(0, std::memory_order_release);
  b->error.store(0, std::memory_order_relaxed);
  b->pins.store(2, std::memory_order_relaxed);
  b->ptr = ptr;
  b->dev = dev;
  b->len = len;
  b->release = nullptr;
  b->release_arg = nullptr;
  b->release_data = nullptr;
  b->src_pin = nullptr;
  return b;
}

// Completion of an h2d or d2d copy, on the driver's thread: release the
// source, store 1, wake, drop the pin.  No CUDA call.
void on_copy_done(void* user) {
  HostFnScope scope;
  DeviceBuf* b = (DeviceBuf*)user;
  plane().events_fired.fetch_add(1, std::memory_order_relaxed);
  if (b->release != nullptr) {
    auto rel = b->release;
    b->release = nullptr;
    rel(b->release_data, b->release_arg);
  }
  if (b->src_pin != nullptr) {
    DeviceBuf* s = b->src_pin;
    b->src_pin = nullptr;
    unpin_buf(s);
  }
  butex_value(b->ready).store(1, std::memory_order_release);
  butex_wake_all(b->ready);
  unpin_buf(b);
}

// After a wake: an asynchronous fault of the device's stream surfaces
// here (the host function itself may not ask the driver).
int check_stream(int dev, const char* what) {
  Plane& p = plane();
  CtxScope ctx(dev);
  if (!ctx.ok()) {
    return -EIO;
  }
  CUresult rc = p.d.StreamQuery(p.devs[dev].stream);
  if (rc == CUDA_SUCCESS || rc == CUDA_ERROR_NOT_READY) {
    return 0;
  }
  p.errors.fetch_add(1, std::memory_order_relaxed);
  set_plane_error(cu_error(what, rc));
  return -EIO;
}

int wait_ready_pinned(DeviceBuf* b, int64_t timeout_us) {
  while (butex_value(b->ready).load(std::memory_order_acquire) == 0) {
    if (butex_wait(b->ready, 0, timeout_us) != 0 && errno == ETIMEDOUT) {
      if (butex_value(b->ready).load(std::memory_order_acquire) != 0) {
        break;
      }
      return -ETIMEDOUT;
    }
  }
  if (b->error.load(std::memory_order_acquire) == 0 &&
      check_stream(b->dev, "transfer") != 0) {
    b->error.store(EIO, std::memory_order_release);
  }
  return b->error.load(std::memory_order_acquire) == 0 ? 0 : -EIO;
}

// The copy is enqueued but its completion could not be: the source may
// still be read at an unknown time, so it is never released (a leak, not
// a use-after-free) and the buffer is failed.  The driver refuses a host
// function only when its context is already lost.
void fail_unarmed(DeviceBuf* b, CUresult rc) {
  Plane& p = plane();
  p.errors.fetch_add(1, std::memory_order_relaxed);
  set_plane_error(cu_error("cuLaunchHostFunc", rc));
  b->release = nullptr;
  b->error.store(EIO, std::memory_order_release);
  butex_value(b->ready).store(1, std::memory_order_release);
  butex_wake_all(b->ready);
  if (b->src_pin != nullptr) {
    DeviceBuf* s = b->src_pin;
    b->src_pin = nullptr;
    unpin_buf(s);
  }
  unpin_buf(b);  // the host function's pin: it will never run
}

}  // namespace

// --- lifecycle ---------------------------------------------------------------

int tpu_plane_init(const char* driver_path) {
  Plane& p = plane();
  if (p.up.load(std::memory_order_acquire)) {
    return 0;
  }
  std::lock_guard<std::mutex> lk(p.init_mu);
  if (p.up.load(std::memory_order_acquire)) {
    return 0;
  }
  // flag-cached: read once per process under init_mu (the up guard)
  const char* env = getenv("TRPC_CUDA_DRIVER");
  std::string path = "libcuda.so.1";
  if (driver_path != nullptr && driver_path[0] != '\0') {
    path = driver_path;
  } else if (env != nullptr && env[0] != '\0') {
    path = env;
  }
  void* dso = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (dso == nullptr) {
    const char* why = dlerror();
    set_plane_error("CUDA driver not loadable (" + path +
                    "): " + (why != nullptr ? why : "dlopen failed"));
    return -ENOENT;
  }
  Driver d{};
  const Sym syms[] = {
      {"cuInit", (void**)&d.Init, true},
      {"cuDeviceGetCount", (void**)&d.DeviceGetCount, true},
      {"cuDeviceGet", (void**)&d.DeviceGet, true},
      {"cuDevicePrimaryCtxRetain", (void**)&d.DevicePrimaryCtxRetain, true},
      {"cuCtxGetCurrent", (void**)&d.CtxGetCurrent, true},
      {"cuCtxSetCurrent", (void**)&d.CtxSetCurrent, true},
      {"cuStreamCreate", (void**)&d.StreamCreate, true},
      {"cuStreamQuery", (void**)&d.StreamQuery, true},
      {"cuMemAlloc_v2", (void**)&d.MemAlloc, true},
      {"cuMemFree_v2", (void**)&d.MemFree, true},
      {"cuMemcpyHtoDAsync_v2", (void**)&d.MemcpyHtoDAsync, true},
      {"cuMemcpyDtoHAsync_v2", (void**)&d.MemcpyDtoHAsync, true},
      {"cuMemcpyDtoDAsync_v2", (void**)&d.MemcpyDtoDAsync, true},
      {"cuMemcpyPeerAsync", (void**)&d.MemcpyPeerAsync, true},
      {"cuMemHostRegister_v2", (void**)&d.MemHostRegister, false},
      {"cuMemHostUnregister", (void**)&d.MemHostUnregister, false},
      {"cuLaunchHostFunc", (void**)&d.LaunchHostFunc, true},
      {"cuGetErrorString", (void**)&d.GetErrorString, true},
  };
  for (const Sym& s : syms) {
    *s.slot = dlsym(dso, s.name);
    if (*s.slot == nullptr && s.required) {
      set_plane_error(std::string("CUDA driver lacks ") + s.name);
      dlclose(dso);
      return -EIO;
    }
  }
  if (d.MemHostRegister == nullptr || d.MemHostUnregister == nullptr) {
    d.MemHostRegister = nullptr;  // landing zones stay pageable
  }
  p.d = d;
  auto fail = [&](const char* what, CUresult rc) {
    set_plane_error(cu_error(what, rc));
    p.devs.clear();
    dlclose(dso);
    return -EIO;
  };
  CUresult rc = d.Init(0);
  if (rc != CUDA_SUCCESS) {
    return fail("cuInit", rc);
  }
  int n = 0;
  rc = d.DeviceGetCount(&n);
  if (rc != CUDA_SUCCESS) {
    return fail("cuDeviceGetCount", rc);
  }
  if (n <= 0) {
    set_plane_error("CUDA driver reports no device");
    dlclose(dso);
    return -EIO;
  }
  CUcontext caller = nullptr;
  if ((rc = d.CtxGetCurrent(&caller)) != CUDA_SUCCESS) {
    return fail("cuCtxGetCurrent", rc);
  }
  // each device's context is current in turn while its stream is made;
  // the caller's (or none) is current again whatever happened
  const char* what = nullptr;
  p.devs.assign(n, Dev{});
  for (int i = 0; i < n && what == nullptr; ++i) {
    Dev& v = p.devs[i];
    if ((rc = d.DeviceGet(&v.dev, i)) != CUDA_SUCCESS) {
      what = "cuDeviceGet";
    } else if ((rc = d.DevicePrimaryCtxRetain(&v.ctx, v.dev)) !=
               CUDA_SUCCESS) {
      what = "cuDevicePrimaryCtxRetain";
    } else if ((rc = d.CtxSetCurrent(v.ctx)) != CUDA_SUCCESS) {
      what = "cuCtxSetCurrent";
    } else if ((rc = d.StreamCreate(&v.stream, CU_STREAM_NON_BLOCKING)) !=
               CUDA_SUCCESS) {
      what = "cuStreamCreate";
    }
  }
  CUresult back = d.CtxSetCurrent(caller);
  if (what == nullptr && back != CUDA_SUCCESS) {
    rc = back;
    what = "cuCtxSetCurrent (the caller's context)";
  }
  if (what != nullptr) {
    return fail(what, rc);
  }
  p.uid = ((uint64_t)getpid() << 32) ^ (uint64_t)monotonic_ns();
  if (p.uid == 0) {
    p.uid = 1;
  }
  p.dso = dso;
  {
    std::lock_guard<std::mutex> elk(err_mu());
    p.error.clear();
  }
  p.up.store(true, std::memory_order_release);
  return 0;
}

bool tpu_plane_available() {
  return plane().up.load(std::memory_order_acquire);
}

const char* tpu_plane_error() {
  static thread_local std::string* copy = new std::string();
  std::lock_guard<std::mutex> lk(err_mu());
  *copy = plane().error;
  return copy->c_str();
}

int tpu_plane_device_count() {
  Plane& p = plane();
  return p.up.load(std::memory_order_acquire) ? (int)p.devs.size() : 0;
}

const char* tpu_plane_platform() {
  return plane().up.load(std::memory_order_acquire) ? "cuda" : "";
}

uint64_t tpu_plane_uid() {
  Plane& p = plane();
  return p.up.load(std::memory_order_acquire) ? p.uid : 0;
}

// --- transfers ---------------------------------------------------------------

TpuBufId tpu_h2d(const void* data, size_t len, int device_index,
                 void (*release)(void*, void*), void* release_arg) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || device_index < 0 ||
      device_index >= (int)p.devs.size() || len == 0) {
    if (release != nullptr) {
      release((void*)data, release_arg);
    }
    return 0;
  }
  drain_deferred();
  CUdeviceptr ptr = 0;
  CUresult rc = CUDA_SUCCESS;
  const char* what = "h2d: cuMemAlloc_v2";
  CtxScope ctx(device_index);
  bool ok = ctx.ok() && (rc = p.d.MemAlloc(&ptr, len)) == CUDA_SUCCESS;
  if (ok) {
    what = "h2d: cuMemcpyHtoDAsync_v2";
    rc = p.d.MemcpyHtoDAsync(ptr, data, len, p.devs[device_index].stream);
    ok = rc == CUDA_SUCCESS;
  }
  if (!ok) {
    if (rc != CUDA_SUCCESS) {  // (a context failure counted itself)
      p.errors.fetch_add(1, std::memory_order_relaxed);
      set_plane_error(cu_error(what, rc));
    }
    if (ptr != 0) {
      p.d.MemFree(ptr);
    }
    if (release != nullptr) {
      release((void*)data, release_arg);
    }
    return 0;
  }
  DeviceBuf* b = arm_buf(ptr, device_index, len);
  b->release = release;
  b->release_arg = release_arg;
  b->release_data = (void*)data;
  TpuBufId id = b->id();
  p.h2d_transfers.fetch_add(1, std::memory_order_relaxed);
  p.h2d_bytes.fetch_add(len, std::memory_order_relaxed);
  p.live_buffers.fetch_add(1, std::memory_order_relaxed);
  rc = p.d.LaunchHostFunc(p.devs[device_index].stream, on_copy_done, b);
  if (rc != CUDA_SUCCESS) {
    fail_unarmed(b, rc);
  }
  return id;
}

namespace {
void release_block_ref(void* data, void* arg) {
  (void)data;
  ((IOBlock*)arg)->Unref();
}
void release_free(void* data, void* arg) {
  (void)arg;
  hp_free(data);
}
}  // namespace

TpuBufId tpu_h2d_from_iobuf(const IOBuf& buf, int device_index) {
  Plane& p = plane();
  if (buf.empty()) {
    return 0;
  }
  if (buf.block_count() == 1) {
    // pointer identity: the copy reads the IOBuf block itself; the ref
    // taken here is dropped by the completion host function
    const BlockRef& r = buf.ref_at(0);
    r.block->Ref();
    TpuBufId id = tpu_h2d(r.block->data + r.offset, r.length, device_index,
                          release_block_ref, r.block);
    if (id != 0) {
      p.zero_copy_sends.fetch_add(1, std::memory_order_relaxed);
    }
    return id;
  }
  char* staging = (char*)hp_malloc(buf.size());
  buf.copy_to(staging, buf.size());
  p.gather_copies.fetch_add(1, std::memory_order_relaxed);
  return tpu_h2d(staging, buf.size(), device_index, release_free, nullptr);
}

TpuBufId tpu_d2d(TpuBufId src_id, int dst_device) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || dst_device < 0 ||
      dst_device >= (int)p.devs.size()) {
    return 0;
  }
  drain_deferred();
  DeviceBuf* src = pin_buf(src_id);
  if (src == nullptr) {
    return 0;
  }
  int rc = wait_ready_pinned(src, tpu_d2d_timeout_us());
  if (rc != 0 || src->ptr == 0) {
    set_plane_error(rc == -ETIMEDOUT
                        ? "d2d: source never became resident"
                        : "d2d: source transfer failed or buffer gone");
    unpin_buf(src);
    return 0;
  }
  size_t len = src->len;
  CUstream stream = p.devs[dst_device].stream;
  CUdeviceptr ptr = 0;
  CUresult crc = CUDA_SUCCESS;
  const char* what = "d2d: cuMemAlloc_v2";
  CtxScope ctx(dst_device);
  bool ok = ctx.ok() && (crc = p.d.MemAlloc(&ptr, len)) == CUDA_SUCCESS;
  if (ok) {
    if (src->dev == dst_device) {
      what = "d2d: cuMemcpyDtoDAsync_v2";
      crc = p.d.MemcpyDtoDAsync(ptr, src->ptr, len, stream);
    } else {
      what = "d2d: cuMemcpyPeerAsync";
      crc = p.d.MemcpyPeerAsync(ptr, p.devs[dst_device].ctx, src->ptr,
                                p.devs[src->dev].ctx, len, stream);
    }
    ok = crc == CUDA_SUCCESS;
  }
  if (!ok) {
    if (crc != CUDA_SUCCESS) {  // (a context failure counted itself)
      p.errors.fetch_add(1, std::memory_order_relaxed);
      set_plane_error(cu_error(what, crc));
    }
    if (ptr != 0) {
      p.d.MemFree(ptr);
    }
    unpin_buf(src);
    return 0;
  }
  DeviceBuf* b = arm_buf(ptr, dst_device, len);
  b->src_pin = src;  // our reader pin now lasts until the copy completes
  TpuBufId id = b->id();
  p.d2d_transfers.fetch_add(1, std::memory_order_relaxed);
  p.d2d_bytes.fetch_add(len, std::memory_order_relaxed);
  p.live_buffers.fetch_add(1, std::memory_order_relaxed);
  crc = p.d.LaunchHostFunc(stream, on_copy_done, b);
  if (crc != CUDA_SUCCESS) {
    fail_unarmed(b, crc);
  }
  return id;
}

int tpu_buf_wait(TpuBufId id, int64_t timeout_us) {
  DeviceBuf* b = pin_buf(id);
  if (b == nullptr) {
    return -EINVAL;
  }
  int rc = wait_ready_pinned(b, timeout_us);
  unpin_buf(b);
  return rc;
}

int64_t tpu_buf_size(TpuBufId id) {
  DeviceBuf* b = pin_buf(id);
  if (b == nullptr) {
    return -1;
  }
  int64_t n = (int64_t)b->len;
  unpin_buf(b);
  return n;
}

namespace {

// One d2h: the landing zone is owned by this context until the caller
// claims it, so a caller that timed out walks away while a late copy
// still writes valid memory; the last reference out releases it.
struct D2hCtx {
  Butex* done = nullptr;
  std::atomic<int32_t> refs{2};  // caller + host function
  char* mem = nullptr;
  int dev = 0;
  bool registered = false;

  static void Drop(D2hCtx* c) {
    if (c->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      release_landing(c->mem, c->dev, c->registered);
      butex_destroy(c->done);
      delete c;
    }
  }
};

void on_d2h_done(void* user) {
  HostFnScope scope;
  D2hCtx* c = (D2hCtx*)user;
  plane().events_fired.fetch_add(1, std::memory_order_relaxed);
  butex_value(c->done).store(1, std::memory_order_release);
  butex_wake_all(c->done);
  D2hCtx::Drop(c);
}

int tpu_d2h_alloc(TpuBufId id, char** mem_out, size_t* len_out) {
  Plane& p = plane();
  drain_deferred();
  DeviceBuf* b = pin_buf(id);
  if (b == nullptr) {
    return -EINVAL;
  }
  int rc = wait_ready_pinned(b, 30 * 1000 * 1000);
  if (rc != 0 || b->ptr == 0) {
    unpin_buf(b);
    return rc != 0 ? rc : -EINVAL;
  }
  size_t len = b->len;
  int dev = b->dev;
  D2hCtx* ctx = new D2hCtx();
  ctx->done = butex_create();
  ctx->mem = zc_host_alloc(len);
  ctx->dev = dev;
  {
    // the device's context for the enqueue alone: the wait below may
    // resume this fiber on another thread
    CtxScope cu(dev);
    if (!cu.ok()) {
      ctx->refs.store(1, std::memory_order_relaxed);
      D2hCtx::Drop(ctx);
      unpin_buf(b);
      return -EIO;
    }
    // page-locked, the copy is asynchronous and the fiber parks below;
    // pageable (registration refused, e.g. a page shared with another
    // registered zone), the driver copies before returning
    ctx->registered =
        p.d.MemHostRegister != nullptr &&
        p.d.MemHostRegister(ctx->mem, len, CU_MEMHOSTREGISTER_PORTABLE) ==
            CUDA_SUCCESS;
    CUstream stream = p.devs[dev].stream;
    CUresult crc = p.d.MemcpyDtoHAsync(ctx->mem, b->ptr, len, stream);
    if (crc != CUDA_SUCCESS) {
      p.errors.fetch_add(1, std::memory_order_relaxed);
      set_plane_error(cu_error("d2h: cuMemcpyDtoHAsync_v2", crc));
      ctx->refs.store(1, std::memory_order_relaxed);
      D2hCtx::Drop(ctx);
      unpin_buf(b);
      return -EIO;
    }
    crc = p.d.LaunchHostFunc(stream, on_d2h_done, ctx);
    if (crc != CUDA_SUCCESS) {
      // the copy may still land: the context (and its zone) is left to it
      p.errors.fetch_add(1, std::memory_order_relaxed);
      set_plane_error(cu_error("d2h: cuLaunchHostFunc", crc));
      unpin_buf(b);
      return -EIO;
    }
  }
  // bounded: a completion that never arrives must not hold a usercode
  // thread or fiber forever (TRPC_TPU_D2H_TIMEOUT_US, read per call)
  int64_t deadline = monotonic_us() + env_wait_budget_us("TRPC_TPU_D2H_TIMEOUT_US");
  bool timed_out = false;
  while (butex_value(ctx->done).load(std::memory_order_acquire) == 0) {
    int64_t left = deadline - monotonic_us();
    if (left <= 0) {
      timed_out = true;
      break;
    }
    butex_wait(ctx->done, 0, left < 100 * 1000 ? left : 100 * 1000);
  }
  if (timed_out) {
    p.errors.fetch_add(1, std::memory_order_relaxed);
    set_plane_error("d2h: copy never completed (completion dropped)");
    D2hCtx::Drop(ctx);
    unpin_buf(b);
    return -ETIMEDOUT;
  }
  int qrc = check_stream(dev, "d2h");
  char* mem = nullptr;
  bool registered = ctx->registered;
  if (qrc == 0) {
    mem = ctx->mem;  // claimed: the last context ref must not free it
    ctx->mem = nullptr;
  }
  D2hCtx::Drop(ctx);
  unpin_buf(b);
  if (qrc != 0) {
    return -EIO;
  }
  if (registered) {
    CtxScope cu(dev);
    if (cu.ok()) {
      p.d.MemHostUnregister(mem);
    }
  }
  p.d2h_transfers.fetch_add(1, std::memory_order_relaxed);
  p.d2h_bytes.fetch_add(len, std::memory_order_relaxed);
  *mem_out = mem;
  *len_out = len;
  return 0;
}

}  // namespace

int tpu_d2h_into_iobuf(TpuBufId id, IOBuf* out) {
  char* mem = nullptr;
  size_t len = 0;
  int rc = tpu_d2h_alloc(id, &mem, &len);
  if (rc != 0) {
    return rc;
  }
  out->append_user_data(
      mem, len, [](void* d, void*) { tpu_host_free(d); }, nullptr);
  return 0;
}

int tpu_d2h_raw(TpuBufId id, char** mem_out, size_t* len_out) {
  return tpu_d2h_alloc(id, mem_out, len_out);
}

void tpu_buf_free(TpuBufId id) {
  drain_deferred();
  DeviceBuf* b = ResourcePool<DeviceBuf>::Address((uint32_t)id);
  if (b == nullptr) {
    return;
  }
  // one freer wins the version bump; the memory goes at the last pin
  // (usually right here; after a pending copy, at its host function,
  // deferred to the next entry point)
  uint32_t ver = (uint32_t)(id >> 32);
  uint32_t expected = ver;
  if (!b->version.compare_exchange_strong(expected, ver + 1,
                                          std::memory_order_acq_rel)) {
    return;
  }
  unpin_buf(b);
}

TpuPlaneStats tpu_plane_stats() {
  Plane& p = plane();
  TpuPlaneStats s;
  s.h2d_transfers = p.h2d_transfers.load(std::memory_order_relaxed);
  s.d2h_transfers = p.d2h_transfers.load(std::memory_order_relaxed);
  s.h2d_bytes = p.h2d_bytes.load(std::memory_order_relaxed);
  s.d2h_bytes = p.d2h_bytes.load(std::memory_order_relaxed);
  s.events_fired = p.events_fired.load(std::memory_order_relaxed);
  s.gather_copies = p.gather_copies.load(std::memory_order_relaxed);
  s.zero_copy_sends = p.zero_copy_sends.load(std::memory_order_relaxed);
  s.live_buffers = p.live_buffers.load(std::memory_order_relaxed);
  s.errors = p.errors.load(std::memory_order_relaxed);
  s.d2d_transfers = p.d2d_transfers.load(std::memory_order_relaxed);
  s.d2d_bytes = p.d2d_bytes.load(std::memory_order_relaxed);
  return s;
}

}  // namespace trpc
