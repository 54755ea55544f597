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
//                             PyTorch uses) + one non-blocking stream;
//                             peer access enabled between every pair of
//                             devices the driver allows
//   BufferFromHostBuffer   -> a block of the device's buffer cache (a
//                             cuMemAlloc_v2 only on a miss) +
//                             cuMemcpyHtoDAsync_v2
//   ready / done events    -> one cuLaunchHostFunc after the copy: the
//                             source is released, 1 stored into the
//                             butex, waiters woken, the pin dropped
//   ToHostBuffer           -> cuMemcpyDtoHAsync_v2 into a landing zone:
//                             an io_uring registered slot when the ring
//                             has one free and the zone fits it (as
//                             tpu.cc's zc_host_alloc), else a block of the
//                             page-locked pool (cuMemHostAlloc, PORTABLE,
//                             only on a miss)
//   CopyToDevice           -> cuMemcpyDtoDAsync_v2 on one device and
//                             between peers, cuMemcpyPeerAsync across
//                             devices the driver gives no peer access
//   (no PJRT counterpart)  -> a block filled on its device: one
//                             cuMemcpyDtoDAsync_v2 from memory the
//                             caller's tensors hold, or cuMemsetD8Async
//                             to zeros; its address and length for the
//                             caller to view (trpc_cuda_fill,
//                             trpc_cuda_buf_addr), and what the driver
//                             says the memory is (cuPointerGetAttribute)
//   Buffer_Destroy         -> the block back to its device's cache at
//                             its last use
//
// Pools.  In steady state a transfer makes no allocation, free,
// page-locking or unregistering in the driver: only the copy, its host
// function and the butex wake.
//   * Device buffers: one cache per device, free lists by size class
//     (powers of two from 4 KiB up to kExactAbove, exact sizes above it:
//     a power of two above 32 MiB could waste more than a KV pool holds).
//     A device keeps free blocks cached up to the most it ever had live
//     at once less what is live now, and at least kDevCacheBytes
//     (256 MiB): what the device once held it may hold again, so a
//     burst of frees (a KV pool's retirements) waits for the
//     allocations that follow (the next admits) instead of going back
//     to the driver, whose cuMemFree waits for the device.  The plane's
//     own CUDA_ERROR_OUT_OF_MEMORY releases them: the device's cached
//     blocks go back to the driver, the most live drops to what is live,
//     and the allocation is tried once more.  An out-of-memory error
//     inside PyTorch's caching allocator never reaches them, so up to
//     that much stays held while PyTorch runs short.
//   * Host landing zones and h2d staging blocks: one pool of page-locked
//     blocks from cuMemHostAlloc(PORTABLE), by the same classes, at most
//     kHostCacheBytes cached.  tpu_host_free hands a pool block back (the
//     IOBuf deleter of tpu_d2h_into_iobuf and trpc_tpu_buf_release both
//     end there), so a zone is reused once the socket sent it or Python
//     copied it out.  PORTABLE is paid once per block, not once a d2h.
//   * io_uring's registered slots (uring_zc_alloc: with the ring
//     transport up, a few fixed-size slots registered with the ring as
//     fixed buffers) come first for a d2h zone, as in tpu.cc: the zone
//     becomes an IOBuf block that leaves the host as a fixed-buffer
//     SEND_ZC.  A slot is page-locked with the driver once, on its first
//     use (cuMemHostRegister_v2, PORTABLE, over its whole extent, probed
//     with uring_zc_buf_index), and stays so; tpu_host_free hands it back
//     to the ring (uring_zc_free) before it tries the pool.  A slot the
//     driver refuses, or one outside the ring's fixed-buffer table (then
//     it gives a zone nothing the pool does not), goes back to the ring
//     and is never tried again: its zones come from the pool, with no
//     driver call per transfer.  The slots stay registered for the life
//     of the process, as the pool's blocks stay allocated: the plane has
//     no teardown.
//   Handing a block back is a push onto a list, not a CUDA call, so a
//   host function does it directly.  A device block goes back once its
//   owner freed it and every copy on it has completed (DeviceBuf::users:
//   the copy that fills it drops its use in its host function, before
//   the wake, so a caller that waited and freed finds the block cached);
//   a staging block goes back in its copy's host function, a landing
//   zone when its reader is done.  So a reused block is never under a
//   pending copy; the one exception, a d2h whose completion never came,
//   is safe because every copy that writes a device block runs on that
//   block's device stream, behind the stalled read.
//
// Rules the design keeps:
//   * The current context is per OS thread, and the plane is called from
//     fiber workers, the usercode pool and Python threads: every driver
//     call runs inside a CtxScope, which makes the device's primary
//     context current and gives the thread back its own context (null
//     included) when it ends, on error paths too.  No scope spans a
//     butex wait: a fiber may resume on another thread.
//   * The plane moves none of its caller's CUDA state, with one piece of
//     context-wide state set on purpose: init enables peer access from
//     each device's primary context to every other device it may reach.
//     That only widens what kernels and copies in those contexts may
//     address; PyTorch enables the same access itself for its own peer
//     copies (the driver's "already enabled" counts as success here), and
//     nothing of PyTorch's depends on it being off.
//   * A host function may make no CUDA call.  Completion only releases
//     the source, stores 1, wakes and unpins; a block handed back there
//     goes onto its free list, and a list left above its limit is trimmed
//     by the next plane call outside a host function.
//   * Waits park the fiber on the butex; no worker thread ever calls a
//     synchronizing driver function.  Asynchronous errors are read with
//     cuStreamQuery by the waiter, after the wake.
//   * No fallback hides the device: a pool miss allocates, and an
//     allocation or copy that fails surfaces with its reason.
#include "tpu.h"

#include <dlfcn.h>
#include <errno.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

#include "fiber.h"
#include "heap_profiler.h"
#include "object_pool.h"
#include "uring.h"

namespace trpc {

namespace {
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
constexpr CUresult CUDA_ERROR_OUT_OF_MEMORY = 2;
constexpr CUresult CUDA_ERROR_NOT_READY = 600;
constexpr CUresult CUDA_ERROR_PEER_ACCESS_ALREADY_ENABLED = 704;
constexpr unsigned CU_STREAM_NON_BLOCKING = 1;
constexpr unsigned CU_MEMHOSTALLOC_PORTABLE = 1;
constexpr unsigned CU_MEMHOSTREGISTER_PORTABLE = 1;
constexpr int CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2;
constexpr int CU_POINTER_ATTRIBUTE_DEVICE_ORDINAL = 9;

// Size classes and the pools' limits (see the header comment).
constexpr size_t kMinClass = 4096;
constexpr size_t kExactAbove = 32u << 20;
constexpr size_t kDevCacheBytes = 256u << 20;   // cache floor, per device
constexpr size_t kHostCacheBytes = 256u << 20;  // free page-locked blocks

size_t size_class(size_t len) {
  if (len > kExactAbove) {
    return len;
  }
  size_t c = kMinClass;
  while (c < len) {
    c <<= 1;
  }
  return c;
}

struct Driver {
  CUresult (*Init)(unsigned);
  CUresult (*DeviceGetCount)(int*);
  CUresult (*DeviceGet)(CUdevice*, int);
  CUresult (*DeviceCanAccessPeer)(int*, CUdevice, CUdevice);
  CUresult (*DevicePrimaryCtxRetain)(CUcontext*, CUdevice);
  CUresult (*CtxGetCurrent)(CUcontext*);
  CUresult (*CtxSetCurrent)(CUcontext);
  CUresult (*CtxEnablePeerAccess)(CUcontext, unsigned);
  CUresult (*StreamCreate)(CUstream*, unsigned);
  CUresult (*StreamQuery)(CUstream);
  CUresult (*MemAlloc)(CUdeviceptr*, size_t);
  CUresult (*MemFree)(CUdeviceptr);
  CUresult (*MemHostAlloc)(void**, size_t, unsigned);
  CUresult (*MemFreeHost)(void*);
  CUresult (*MemHostRegister)(void*, size_t, unsigned);
  CUresult (*MemcpyHtoDAsync)(CUdeviceptr, const void*, size_t, CUstream);
  CUresult (*MemcpyDtoHAsync)(void*, CUdeviceptr, size_t, CUstream);
  CUresult (*MemcpyDtoDAsync)(CUdeviceptr, CUdeviceptr, size_t, CUstream);
  CUresult (*MemcpyPeerAsync)(CUdeviceptr, CUcontext, CUdeviceptr, CUcontext,
                              size_t, CUstream);
  CUresult (*MemsetD8Async)(CUdeviceptr, unsigned char, size_t, CUstream);
  CUresult (*PointerGetAttribute)(void*, int, CUdeviceptr);
  CUresult (*LaunchHostFunc)(CUstream, CUhostFn, void*);
  CUresult (*GetErrorString)(CUresult, const char**);
};

struct Sym {
  const char* name;
  void** slot;
};

struct Dev {
  CUdevice dev = 0;
  CUcontext ctx = nullptr;
  CUstream stream = nullptr;
};

// Free blocks of one pool by size class.  take/put are pushes and pops
// under a mutex, never a CUDA call; evict hands back the blocks above a
// byte limit, for the caller to return to the driver.  A device cache
// also counts the bytes it lent out (lend, and put's `lent`) and their
// most, which set its limit (keep).
struct FreeList {
  std::mutex mu;
  std::map<size_t, std::vector<uint64_t>> by_class;
  size_t cached = 0;
  size_t live = 0, peak = 0;  // device caches: bytes lent out, their most
  std::atomic<uint64_t> hits{0}, misses{0}, releases{0}, oom_retries{0};

  bool take(size_t cls, uint64_t* out) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = by_class.find(cls);
    if (it == by_class.end() || it->second.empty()) {
      misses.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    *out = it->second.back();
    it->second.pop_back();
    cached -= cls;
    hits.fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  // true when the list is now above `limit` (a device cache: above
  // keep(limit)); `lent` when the block was counted by lend
  bool put(uint64_t block, size_t cls, size_t limit, bool lent = false) {
    std::lock_guard<std::mutex> lk(mu);
    by_class[cls].push_back(block);
    cached += cls;
    if (lent) {
      live -= cls;
      return cached > keep_locked(limit);
    }
    return cached > limit;
  }

  // a block of class `cls` handed out, from the list or the driver
  void lend(size_t cls) {
    std::lock_guard<std::mutex> lk(mu);
    live += cls;
    peak = std::max(peak, live);
  }

  // a device cache's limit: the most lent out at once less what is out
  // now, and at least `floor`
  size_t keep(size_t floor) {
    std::lock_guard<std::mutex> lk(mu);
    return keep_locked(floor);
  }

  // after an out-of-memory: the most lent out is what is out now
  void forget_peak() {
    std::lock_guard<std::mutex> lk(mu);
    peak = live;
  }

  // (block, class) pairs taken off the lists until at most `keep` bytes
  // stay cached, the largest classes first
  std::vector<std::pair<uint64_t, size_t>> evict(size_t keep) {
    std::vector<std::pair<uint64_t, size_t>> out;
    std::lock_guard<std::mutex> lk(mu);
    for (auto it = by_class.rbegin(); it != by_class.rend() && cached > keep;
         ++it) {
      while (!it->second.empty() && cached > keep) {
        out.emplace_back(it->second.back(), it->first);
        it->second.pop_back();
        cached -= it->first;
      }
    }
    releases.fetch_add(out.size(), std::memory_order_relaxed);
    return out;
  }

  bool over(size_t limit) {
    std::lock_guard<std::mutex> lk(mu);
    return cached > limit;
  }

 private:
  size_t keep_locked(size_t floor) const {
    return std::max(floor, peak - live);
  }
};

struct Plane {
  void* dso = nullptr;
  Driver d{};
  std::vector<Dev> devs;
  std::vector<uint8_t> peer;  // [i * n + j]: device i's context reaches j
  std::string error;
  std::atomic<bool> up{false};
  std::mutex init_mu;
  uint64_t uid = 0;

  std::vector<std::unique_ptr<FreeList>> dev_cache;  // one per device
  FreeList host;
  std::unordered_map<void*, size_t> host_blocks;  // every pool block, under host.mu
  // io_uring slots the plane has tried, by base: the extent page-locked
  // with the driver, 0 when refused (never tried again)
  std::mutex slot_mu;
  std::unordered_map<void*, size_t> slots;

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

void count_error(const char* what, CUresult rc) {
  plane().errors.fetch_add(1, std::memory_order_relaxed);
  set_plane_error(cu_error(what, rc));
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
      count_error(what, rc);
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

// --- the device-buffer cache -------------------------------------------------

// Return device `dev`'s cached blocks above `keep` bytes to the driver.
// Device dev's context must be current; never inside a host function.
void dev_evict(int dev, size_t keep) {
  Plane& p = plane();
  for (const auto& blk : p.dev_cache[dev]->evict(keep)) {
    p.d.MemFree((CUdeviceptr)blk.first);
  }
}

// A block of class `cls` on device `dev` (its context current): from the
// cache, else from the driver; on out-of-memory the device's cached
// blocks go back to the driver and the allocation is tried once more.
CUresult dev_alloc(int dev, size_t cls, CUdeviceptr* out) {
  Plane& p = plane();
  FreeList& f = *p.dev_cache[dev];
  size_t keep = f.keep(kDevCacheBytes);
  if (f.over(keep)) {  // pushed past the limit in a host function
    dev_evict(dev, keep);
  }
  uint64_t block = 0;
  if (f.take(cls, &block)) {
    *out = (CUdeviceptr)block;
    f.lend(cls);
    return CUDA_SUCCESS;
  }
  CUresult rc = p.d.MemAlloc(out, cls);
  if (rc == CUDA_ERROR_OUT_OF_MEMORY) {
    f.oom_retries.fetch_add(1, std::memory_order_relaxed);
    f.forget_peak();
    dev_evict(dev, 0);
    rc = p.d.MemAlloc(out, cls);
  }
  if (rc == CUDA_SUCCESS) {
    f.lend(cls);
  }
  return rc;
}

// Hand a block back to its device's cache: a push, so a host function
// may do it; above the limit, a caller outside one trims at once.
void dev_release(int dev, CUdeviceptr ptr, size_t cls) {
  Plane& p = plane();
  FreeList& f = *p.dev_cache[dev];
  if (f.put(ptr, cls, kDevCacheBytes, true) && !tl_in_host_fn) {
    CtxScope ctx(dev);
    if (ctx.ok()) {
      dev_evict(dev, f.keep(kDevCacheBytes));
    }
  }
}

// --- the page-locked host pool -----------------------------------------------

// Return the pool's cached blocks above `keep` bytes to the driver.
// Never inside a host function.
void host_evict(size_t keep) {
  Plane& p = plane();
  std::vector<std::pair<uint64_t, size_t>> out = p.host.evict(keep);
  if (out.empty()) {
    return;
  }
  {
    std::lock_guard<std::mutex> lk(p.host.mu);
    for (const auto& blk : out) {
      p.host_blocks.erase((void*)blk.first);
    }
  }
  CtxScope ctx(0);  // PORTABLE blocks: any of the plane's contexts frees
  if (ctx.ok()) {
    for (const auto& blk : out) {
      p.d.MemFreeHost((void*)blk.first);
    }
  }
}

// A page-locked block of at least `len` bytes into *out; a context of
// the plane must be current.  0, or -EIO with the reason recorded.
int host_alloc(size_t len, char** out, const char* what) {
  Plane& p = plane();
  if (p.host.over(kHostCacheBytes)) {
    host_evict(kHostCacheBytes);
  }
  size_t cls = size_class(len);
  uint64_t block = 0;
  if (p.host.take(cls, &block)) {
    *out = (char*)block;
    return 0;
  }
  void* mem = nullptr;
  CUresult rc = p.d.MemHostAlloc(&mem, cls, CU_MEMHOSTALLOC_PORTABLE);
  if (rc == CUDA_ERROR_OUT_OF_MEMORY) {
    p.host.oom_retries.fetch_add(1, std::memory_order_relaxed);
    host_evict(0);
    rc = p.d.MemHostAlloc(&mem, cls, CU_MEMHOSTALLOC_PORTABLE);
  }
  if (rc != CUDA_SUCCESS) {
    count_error(what, rc);
    return -EIO;
  }
  {
    std::lock_guard<std::mutex> lk(p.host.mu);
    p.host_blocks[mem] = cls;
  }
  *out = (char*)mem;
  return 0;
}

// A pool block goes back onto its list (true); anything else is not
// the pool's (false).  A push: a host function may call it.
bool host_release(void* mem) {
  Plane& p = plane();
  size_t cls = 0;
  {
    std::lock_guard<std::mutex> lk(p.host.mu);
    auto it = p.host_blocks.find(mem);
    if (it == p.host_blocks.end()) {
      return false;
    }
    cls = it->second;
  }
  if (p.host.put((uint64_t)mem, cls, kHostCacheBytes) && !tl_in_host_fn) {
    host_evict(kHostCacheBytes);
  }
  return true;
}

// --- io_uring's registered slots ---------------------------------------------

// The bytes of the ring's slot at `s` (its base, from uring_zc_alloc),
// which holds at least `len`: the longest range from s that
// uring_zc_buf_index places in one registered buffer; 0 when the slot is
// not in the ring's fixed-buffer table.
size_t slot_extent(const char* s, size_t len) {
  if (uring_zc_buf_index(s, len) < 0) {
    return 0;
  }
  size_t fits = len;  // a range that fits, then one that does not
  size_t over = len;
  do {
    fits = over;
    over *= 2;
  } while (uring_zc_buf_index(s, over) >= 0);
  while (over - fits > 1) {
    const size_t mid = fits + (over - fits) / 2;
    if (uring_zc_buf_index(s, mid) >= 0) {
      fits = mid;
    } else {
      over = mid;
    }
  }
  return fits;
}

// Whether slot `s` may be a zone of `len` bytes: page-locked with the
// driver, which happens on its first use (a context of the plane
// current; never inside a host function).
bool slot_ready(char* s, size_t len) {
  Plane& p = plane();
  std::lock_guard<std::mutex> lk(p.slot_mu);
  auto it = p.slots.find(s);
  if (it == p.slots.end()) {
    size_t extent = slot_extent(s, len);
    if (extent != 0 && p.d.MemHostRegister(
                           s, extent, CU_MEMHOSTREGISTER_PORTABLE) !=
                           CUDA_SUCCESS) {
      extent = 0;
    }
    it = p.slots.emplace(s, extent).first;
  }
  return it->second >= len;
}

// A d2h landing zone of `len` bytes into *out: a slot of the ring when
// one is free, fits and is page-locked, else a page-locked pool block; a
// context of the plane must be current.  0, or -EIO with the reason
// recorded.
int zone_alloc(size_t len, char** out) {
  char* s = (char*)uring_zc_alloc(len);
  if (s != nullptr) {
    if (slot_ready(s, len)) {
      *out = s;
      return 0;
    }
    uring_zc_free(s);
  }
  return host_alloc(len, out, "d2h: cuMemHostAlloc");
}

// --- device buffers ----------------------------------------------------------

struct DeviceBuf {
  CUdeviceptr ptr = 0;
  int dev = 0;
  size_t len = 0;
  size_t cls = 0;  // the cache block's size class
  uint32_t slot = 0;
  std::atomic<uint32_t> version{1};
  Butex* ready = nullptr;  // 1 = resident on the device (or errored)
  std::atomic<int32_t> error{0};
  // 1 (owned by tpu_buf_free) + 1 per pending host function + 1 per
  // reader; the slot is recycled when it drains
  std::atomic<int32_t> pins{0};
  // uses of the device block: 1 (the owner) + 1 (the copy that fills it,
  // until its host function) + 1 per reading copy (d2h, a d2d's source)
  // until it completed; the block goes back to the cache at 0.  Each use
  // is held under a pin, so the slot outlives it.
  std::atomic<int32_t> users{0};
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
    ResourcePool<DeviceBuf>::Return(b->slot);
  }
}

// One more use of a pinned buffer's block; false when the block is gone
// (its owner freed it and every use ended).
bool use_buf(DeviceBuf* b) {
  int32_t cur = b->users.load(std::memory_order_acquire);
  do {
    if (cur <= 0) {
      return false;
    }
  } while (!b->users.compare_exchange_weak(cur, cur + 1,
                                           std::memory_order_acq_rel));
  return true;
}

// The last use hands the block back to its device's cache (a push: a
// host function may end a use).
void unuse_buf(DeviceBuf* b) {
  if (b->users.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    dev_release(b->dev, b->ptr, b->cls);
    b->ptr = 0;
    plane().live_buffers.fetch_sub(1, std::memory_order_relaxed);
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

// A fresh slot, armed (not ready) with the free's pin and use and the
// host function's pin and use.
DeviceBuf* arm_buf(CUdeviceptr ptr, int dev, size_t len, size_t cls) {
  DeviceBuf* b = nullptr;
  uint32_t slot = ResourcePool<DeviceBuf>::Get(&b);
  b->slot = slot;
  if (b->ready == nullptr) {
    b->ready = butex_create();
  }
  butex_value(b->ready).store(0, std::memory_order_release);
  b->error.store(0, std::memory_order_relaxed);
  b->pins.store(2, std::memory_order_relaxed);
  b->users.store(2, std::memory_order_relaxed);
  b->ptr = ptr;
  b->dev = dev;
  b->len = len;
  b->cls = cls;
  b->release = nullptr;
  b->release_arg = nullptr;
  b->release_data = nullptr;
  b->src_pin = nullptr;
  return b;
}

// Completion of an h2d or d2d copy, on the driver's thread: release the
// source, end the copy's use of the block, store 1, wake, drop the pin.
// No CUDA call.
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
    unuse_buf(s);
    unpin_buf(s);
  }
  unuse_buf(b);
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
  count_error(what, rc);
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

// The copy is enqueued but its completion could not be: the source and
// both blocks may still be read or written at an unknown time, so none
// is ever released or reused (the copy's uses are kept: a leak, not a
// use-after-free) and the buffer is failed.  The driver refuses a host
// function only when its context is already lost.
void fail_unarmed(DeviceBuf* b, CUresult rc) {
  Plane& p = plane();
  count_error("cuLaunchHostFunc", rc);
  b->release = nullptr;
  p.live_buffers.fetch_sub(1, std::memory_order_relaxed);
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

// A ring slot back to the ring, a pool block back to the pool, anything
// else to the heap: pushes, so a host function may call it.
void tpu_host_free(void* p) {
  if (p != nullptr && !uring_zc_free(p) && !host_release(p)) {
    hp_free(p);
  }
}

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
      {"cuInit", (void**)&d.Init},
      {"cuDeviceGetCount", (void**)&d.DeviceGetCount},
      {"cuDeviceGet", (void**)&d.DeviceGet},
      {"cuDeviceCanAccessPeer", (void**)&d.DeviceCanAccessPeer},
      {"cuDevicePrimaryCtxRetain", (void**)&d.DevicePrimaryCtxRetain},
      {"cuCtxGetCurrent", (void**)&d.CtxGetCurrent},
      {"cuCtxSetCurrent", (void**)&d.CtxSetCurrent},
      {"cuCtxEnablePeerAccess", (void**)&d.CtxEnablePeerAccess},
      {"cuStreamCreate", (void**)&d.StreamCreate},
      {"cuStreamQuery", (void**)&d.StreamQuery},
      {"cuMemAlloc_v2", (void**)&d.MemAlloc},
      {"cuMemFree_v2", (void**)&d.MemFree},
      {"cuMemHostAlloc", (void**)&d.MemHostAlloc},
      {"cuMemFreeHost", (void**)&d.MemFreeHost},
      {"cuMemHostRegister_v2", (void**)&d.MemHostRegister},
      {"cuMemcpyHtoDAsync_v2", (void**)&d.MemcpyHtoDAsync},
      {"cuMemcpyDtoHAsync_v2", (void**)&d.MemcpyDtoHAsync},
      {"cuMemcpyDtoDAsync_v2", (void**)&d.MemcpyDtoDAsync},
      {"cuMemcpyPeerAsync", (void**)&d.MemcpyPeerAsync},
      {"cuMemsetD8Async", (void**)&d.MemsetD8Async},
      {"cuPointerGetAttribute", (void**)&d.PointerGetAttribute},
      {"cuLaunchHostFunc", (void**)&d.LaunchHostFunc},
      {"cuGetErrorString", (void**)&d.GetErrorString},
  };
  for (const Sym& s : syms) {
    *s.slot = dlsym(dso, s.name);
    if (*s.slot == nullptr) {
      set_plane_error(std::string("CUDA driver lacks ") + s.name);
      dlclose(dso);
      return -EIO;
    }
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
  // each device's context is current in turn while its stream is made
  // and its peer access enabled; the caller's (or none) is current again
  // whatever happened
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
  // peer access: a pair the driver refuses keeps cuMemcpyPeerAsync
  p.peer.assign((size_t)n * n, 0);
  for (int i = 0; i < n && what == nullptr; ++i) {
    for (int j = 0; j < n && what == nullptr; ++j) {
      int can = 0;
      if (i == j) {
        continue;
      }
      if ((rc = d.DeviceCanAccessPeer(&can, p.devs[i].dev, p.devs[j].dev)) !=
          CUDA_SUCCESS) {
        what = "cuDeviceCanAccessPeer";
      } else if (can != 0 &&
                 (rc = d.CtxSetCurrent(p.devs[i].ctx)) != CUDA_SUCCESS) {
        what = "cuCtxSetCurrent";
      } else if (can != 0) {
        rc = d.CtxEnablePeerAccess(p.devs[j].ctx, 0);
        p.peer[(size_t)i * n + j] =
            rc == CUDA_SUCCESS || rc == CUDA_ERROR_PEER_ACCESS_ALREADY_ENABLED;
      }
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
  p.dev_cache.clear();
  for (int i = 0; i < n; ++i) {
    p.dev_cache.emplace_back(new FreeList());
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
  CUdeviceptr ptr = 0;
  CUresult rc = CUDA_SUCCESS;
  const char* what = "h2d: cuMemAlloc_v2";
  size_t cls = size_class(len);
  CtxScope ctx(device_index);
  bool ok = ctx.ok() && (rc = dev_alloc(device_index, cls, &ptr)) ==
                            CUDA_SUCCESS;
  if (ok) {
    what = "h2d: cuMemcpyHtoDAsync_v2";
    rc = p.d.MemcpyHtoDAsync(ptr, data, len, p.devs[device_index].stream);
    ok = rc == CUDA_SUCCESS;
  }
  if (!ok) {
    if (rc != CUDA_SUCCESS) {  // (a context failure counted itself)
      count_error(what, rc);
    }
    if (ptr != 0) {
      dev_release(device_index, ptr, cls);
    }
    if (release != nullptr) {
      release((void*)data, release_arg);
    }
    return 0;
  }
  DeviceBuf* b = arm_buf(ptr, device_index, len, cls);
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
void release_staging(void* data, void* arg) {
  (void)arg;
  host_release(data);
}

// `len` bytes at `data` copied into a page-locked staging block and sent
// to device `device` from there; the block goes back to the pool when
// the copy's host function runs.
TpuBufId h2d_staged(size_t len, int device,
                    void (*fill)(char*, size_t, const void*),
                    const void* src) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || device < 0 ||
      device >= (int)p.devs.size() || len == 0) {
    return 0;
  }
  char* block = nullptr;
  {
    CtxScope ctx(device);  // a pool miss allocates page-locked memory
    if (!ctx.ok() || host_alloc(len, &block, "h2d: cuMemHostAlloc") != 0) {
      return 0;
    }
  }
  fill(block, len, src);
  return tpu_h2d(block, len, device, release_staging, nullptr);
}

// A block of `len` bytes on `device` filled on the device, on its
// stream: one copy from `src` (device memory that the device's primary
// context addresses, written in full before this call and kept by the
// caller until the buffer is ready), or zeros when `src` is 0.  No host
// memory is read or written; the buffer becomes ready as an h2d's does,
// in the host function after the fill.
TpuBufId device_fill(CUdeviceptr src, size_t len, int device) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || device < 0 ||
      device >= (int)p.devs.size() || len == 0) {
    return 0;
  }
  CUdeviceptr ptr = 0;
  CUresult rc = CUDA_SUCCESS;
  const char* what = "fill: cuMemAlloc_v2";
  size_t cls = size_class(len);
  CUstream stream = p.devs[device].stream;
  CtxScope ctx(device);
  bool ok = ctx.ok() && (rc = dev_alloc(device, cls, &ptr)) == CUDA_SUCCESS;
  if (ok) {
    if (src != 0) {
      what = "fill: cuMemcpyDtoDAsync_v2";
      rc = p.d.MemcpyDtoDAsync(ptr, src, len, stream);
    } else {
      what = "fill: cuMemsetD8Async";
      rc = p.d.MemsetD8Async(ptr, 0, len, stream);
    }
    ok = rc == CUDA_SUCCESS;
  }
  if (!ok) {
    if (rc != CUDA_SUCCESS) {  // (a context failure counted itself)
      count_error(what, rc);
    }
    if (ptr != 0) {
      dev_release(device, ptr, cls);
    }
    return 0;
  }
  DeviceBuf* b = arm_buf(ptr, device, len, cls);
  TpuBufId id = b->id();
  p.live_buffers.fetch_add(1, std::memory_order_relaxed);
  rc = p.d.LaunchHostFunc(stream, on_copy_done, b);
  if (rc != CUDA_SUCCESS) {
    fail_unarmed(b, rc);
  }
  return id;
}

// A ready buffer's device address and length; -EINVAL for a buffer that
// is gone, -EAGAIN for one not ready, -EIO for one that failed.
int buf_addr(TpuBufId id, uint64_t* ptr, uint64_t* len) {
  DeviceBuf* b = pin_buf(id);
  if (b == nullptr) {
    return -EINVAL;
  }
  int rc = 0;
  if (butex_value(b->ready).load(std::memory_order_acquire) == 0) {
    rc = -EAGAIN;
  } else if (b->error.load(std::memory_order_acquire) != 0) {
    rc = -EIO;
  } else if (!use_buf(b)) {
    rc = -EINVAL;
  } else {
    *ptr = (uint64_t)b->ptr;
    *len = (uint64_t)b->len;
    unuse_buf(b);
  }
  unpin_buf(b);
  return rc;
}

// What the driver says device `device`'s buffers are, asked of one block
// of its cache: the CUmemorytype (2 device memory, 1 host memory) and
// the ordinal of the device that holds it.  0, or -EIO with the reason
// recorded.
int buffer_memory(int device, int* memtype, int* ordinal) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || device < 0 ||
      device >= (int)p.devs.size()) {
    return -EINVAL;
  }
  CtxScope ctx(device);
  CUdeviceptr ptr = 0;
  CUresult rc = CUDA_SUCCESS;
  if (!ctx.ok()) {
    return -EIO;
  }
  if ((rc = dev_alloc(device, kMinClass, &ptr)) != CUDA_SUCCESS) {
    count_error("buffer memory: cuMemAlloc_v2", rc);
    return -EIO;
  }
  unsigned type = 0;
  int ord = -1;
  if ((rc = p.d.PointerGetAttribute(&type, CU_POINTER_ATTRIBUTE_MEMORY_TYPE,
                                    ptr)) != CUDA_SUCCESS ||
      (rc = p.d.PointerGetAttribute(&ord, CU_POINTER_ATTRIBUTE_DEVICE_ORDINAL,
                                    ptr)) != CUDA_SUCCESS) {
    count_error("cuPointerGetAttribute", rc);
  }
  dev_release(device, ptr, kMinClass);
  if (rc != CUDA_SUCCESS) {
    return -EIO;
  }
  *memtype = (int)type;
  *ordinal = ord;
  return 0;
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
  p.gather_copies.fetch_add(1, std::memory_order_relaxed);
  return h2d_staged(
      buf.size(), device_index,
      [](char* dst, size_t n, const void* src) {
        ((const IOBuf*)src)->copy_to(dst, n);
      },
      &buf);
}

TpuBufId tpu_d2d(TpuBufId src_id, int dst_device) {
  Plane& p = plane();
  if (!p.up.load(std::memory_order_acquire) || dst_device < 0 ||
      dst_device >= (int)p.devs.size()) {
    return 0;
  }
  DeviceBuf* src = pin_buf(src_id);
  if (src == nullptr) {
    return 0;
  }
  int rc = wait_ready_pinned(src, tpu_d2d_timeout_us());
  if (rc != 0 || !use_buf(src)) {
    set_plane_error(rc == -ETIMEDOUT
                        ? "d2d: source never became resident"
                        : "d2d: source transfer failed or buffer gone");
    unpin_buf(src);
    return 0;
  }
  size_t len = src->len;
  size_t cls = size_class(len);
  size_t n = p.devs.size();
  CUstream stream = p.devs[dst_device].stream;
  CUdeviceptr ptr = 0;
  CUresult crc = CUDA_SUCCESS;
  const char* what = "d2d: cuMemAlloc_v2";
  CtxScope ctx(dst_device);
  bool ok = ctx.ok() && (crc = dev_alloc(dst_device, cls, &ptr)) ==
                            CUDA_SUCCESS;
  if (ok) {
    if (src->dev == dst_device ||
        p.peer[(size_t)dst_device * n + (size_t)src->dev] != 0) {
      // one device, or a peer the destination's context reaches directly
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
      count_error(what, crc);
    }
    if (ptr != 0) {
      dev_release(dst_device, ptr, cls);
    }
    unuse_buf(src);
    unpin_buf(src);
    return 0;
  }
  DeviceBuf* b = arm_buf(ptr, dst_device, len, cls);
  b->src_pin = src;  // our reader pin and use last until the copy completes
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
// still writes valid memory; the last reference out hands it back.
struct D2hCtx {
  Butex* done = nullptr;
  std::atomic<int32_t> refs{2};  // caller + host function
  char* mem = nullptr;

  static void Drop(D2hCtx* c) {
    if (c->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      tpu_host_free(c->mem);
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
  DeviceBuf* b = pin_buf(id);
  if (b == nullptr) {
    return -EINVAL;
  }
  int rc = wait_ready_pinned(b, 30 * 1000 * 1000);
  if (rc != 0 || !use_buf(b)) {
    unpin_buf(b);
    return rc != 0 ? rc : -EINVAL;
  }
  size_t len = b->len;
  int dev = b->dev;
  D2hCtx* ctx = new D2hCtx();
  ctx->done = butex_create();
  {
    // the device's context for the enqueue alone: the wait below may
    // resume this fiber on another thread
    CtxScope cu(dev);
    if (!cu.ok() || zone_alloc(len, &ctx->mem) != 0) {
      ctx->refs.store(1, std::memory_order_relaxed);
      D2hCtx::Drop(ctx);
      unuse_buf(b);
      unpin_buf(b);
      return -EIO;
    }
    CUstream stream = p.devs[dev].stream;
    CUresult crc = p.d.MemcpyDtoHAsync(ctx->mem, b->ptr, len, stream);
    if (crc != CUDA_SUCCESS) {
      count_error("d2h: cuMemcpyDtoHAsync_v2", crc);
      ctx->refs.store(1, std::memory_order_relaxed);
      D2hCtx::Drop(ctx);
      unuse_buf(b);
      unpin_buf(b);
      return -EIO;
    }
    crc = p.d.LaunchHostFunc(stream, on_d2h_done, ctx);
    if (crc != CUDA_SUCCESS) {
      // the copy may still land: the context (and its zone) is left to
      // it, and so is the block (its use is kept)
      count_error("d2h: cuLaunchHostFunc", crc);
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
    unuse_buf(b);  // a later writer of the block queues behind the read
    unpin_buf(b);
    return -ETIMEDOUT;
  }
  int qrc = check_stream(dev, "d2h");
  char* mem = nullptr;
  if (qrc == 0) {
    mem = ctx->mem;  // claimed: the last context ref must not release it
    ctx->mem = nullptr;
  }
  D2hCtx::Drop(ctx);
  unuse_buf(b);
  unpin_buf(b);
  if (qrc != 0) {
    return -EIO;
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
  DeviceBuf* b = ResourcePool<DeviceBuf>::Address((uint32_t)id);
  if (b == nullptr) {
    return;
  }
  // one freer wins the version bump; the block goes back to the cache at
  // its last use (usually right here; after a pending copy, at its end)
  uint32_t ver = (uint32_t)(id >> 32);
  uint32_t expected = ver;
  if (!b->version.compare_exchange_strong(expected, ver + 1,
                                          std::memory_order_acq_rel)) {
    return;
  }
  unuse_buf(b);
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

// --- the port's own C entries (beside capi.cc's, which stay as they are) -----

extern "C" {

// h2d from caller memory through a page-locked staging block: the bytes
// are copied once, into the block, and the DMA reads them from there
// asynchronously; the block goes back to the pool when the copy's host
// function runs.  (capi.cc's trpc_tpu_h2d copies into fresh pageable
// memory, which the driver then copies again before it returns.)  0 on
// failure, with the reason in trpc_tpu_plane_error.
uint64_t trpc_cuda_h2d_staged(const uint8_t* data, size_t len, int device) {
  return trpc::h2d_staged(
      len, device,
      [](char* dst, size_t n, const void* src) { memcpy(dst, src, n); },
      data);
}

// A block of `len` bytes on `device` filled on the device: one copy of
// `len` bytes from device address `src` (written in full before the
// call; the caller keeps it until the buffer is ready), or zeros when
// `src` is 0.  Returns the buffer, ready once filled (trpc_tpu_buf_wait);
// 0 on failure, with the reason in trpc_tpu_plane_error.
uint64_t trpc_cuda_fill(uint64_t src, size_t len, int device) {
  return trpc::device_fill((trpc::CUdeviceptr)src, len, device);
}

// A ready buffer's device address and length into *ptr and *len, valid
// until the buffer is freed: 0, -EINVAL (gone), -EAGAIN (not ready) or
// -EIO (its transfer failed).
int trpc_cuda_buf_addr(uint64_t id, uint64_t* ptr, uint64_t* len) {
  return trpc::buf_addr(id, ptr, len);
}

// What device `device`'s buffers are: *memtype the driver's
// CUmemorytype of its memory (2 device, 1 host) and *ordinal the device
// that holds it.  0, or a negative errno with the reason recorded.
int trpc_cuda_buffer_memory(int device, int* memtype, int* ordinal) {
  return trpc::buffer_memory(device, memtype, ordinal);
}

// The pools' counters: out[0..4] the device-buffer caches summed over
// devices, out[5..9] the page-locked host pool, each as hits, misses,
// bytes cached, releases (blocks handed back to the driver) and
// out-of-memory retries.
void trpc_cuda_pool_stats(uint64_t out[10]) {
  using trpc::FreeList;
  trpc::Plane& p = trpc::plane();
  for (int i = 0; i < 10; ++i) {
    out[i] = 0;
  }
  auto add = [](uint64_t* o, FreeList& f) {
    o[0] += f.hits.load(std::memory_order_relaxed);
    o[1] += f.misses.load(std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(f.mu);
      o[2] += f.cached;
    }
    o[3] += f.releases.load(std::memory_order_relaxed);
    o[4] += f.oom_retries.load(std::memory_order_relaxed);
  };
  if (!p.up.load(std::memory_order_acquire)) {
    return;
  }
  for (auto& f : p.dev_cache) {
    add(out, *f);
  }
  add(out + 5, p.host);
}

// io_uring's slots the plane has tried as d2h zones: out[0] page-locked
// with the driver (each once, on its first use), out[1] refused (never
// tried again).  Both only grow, and only on a slot's first use.
void trpc_cuda_slot_stats(uint64_t out[2]) {
  trpc::Plane& p = trpc::plane();
  out[0] = out[1] = 0;
  std::lock_guard<std::mutex> lk(p.slot_mu);
  for (const auto& slot : p.slots) {
    ++out[slot.second != 0 ? 0 : 1];
  }
}

// Which ordered device pairs have peer access: out[i * n + j] is 1 when
// device i's context reaches device j's memory.  Returns n (0 when the
// plane is down); fills at most `cap` entries.
int trpc_cuda_peer_access(uint8_t* out, int cap) {
  trpc::Plane& p = trpc::plane();
  if (!p.up.load(std::memory_order_acquire)) {
    return 0;
  }
  for (size_t i = 0; i < p.peer.size() && (int)i < cap; ++i) {
    out[i] = p.peer[i];
  }
  return (int)p.devs.size();
}

}  // extern "C"
