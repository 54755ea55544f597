// test_plane_races.cc — races of the CUDA device plane (cuda_plane.cc) on
// the fake CUDA driver (cuda_fake.cc), the port of the reference's
// tpu_plane_races scenario (native/src/test_stress.cc), which binds the
// fake PJRT plugin and so cannot reach this plane.
//
// Six threads h2d onto both devices while the fake's completions fire on
// its own thread after a delay.  Half the rounds hand the id to a thread
// that frees it mid-flight while this thread waits on it and reads it
// back (any return code is legal; a crash, a use after free or a free
// under a pending copy is not), then free it again (idempotent).  The
// other half round-trip the bytes, every other one through a d2d hop to
// the other device.  Even threads hold device 0's primary context, odd
// threads none: each must still hold its own after every round, as must
// every freeing thread.  At the end every slot has drained.
//
// Then the pools: the same six threads send sizes that share size
// classes (6000 and 8192 bytes both take an 8 KiB block) through the
// staged h2d entry and through multi-block IOBufs (the gather, staged
// too), so every transfer reuses blocks that other threads just handed
// back.  Frees race the transfers as above, every landing zone is
// released on another thread than the one that read it, and half the
// reads hop through the other device first.  The fake aborts if a block
// is handed out while a copy on it is pending; at the end both pools
// have served hits and every slot has drained.
//
// Then io_uring's registered slots, where the kernel takes io_uring: with
// the ring transport on, the same six threads read buffers of sizes that
// fit a slot (64 KiB and 1 MiB) back, so the d2h zones come from the
// ring's slots (page-locked with the driver on their first use, under
// the plane's slot table) while they last and from the pool when every
// slot is out; each zone goes back on another thread, while other
// threads take slots.  The fake holds a registered slot to the
// pending-copy rule, so a slot handed out again under its copy aborts;
// at the end every slot is back in the ring, each was registered once
// at most, and every buffer has drained.
//
// Built by brpc_tpu_torch._native.build_plane_races() against the core
// library, or with -fsanitize=address from the core's sources; run with
// TRPC_CUDA_DRIVER naming libcuda_fake.so:
//
//   TRPC_CUDA_DRIVER=.../libcuda_fake.so ./test_plane_races
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include "fiber.h"
#include "iobuf.h"
#include "tpu.h"
#include "uring.h"

using namespace trpc;

extern "C" uint64_t trpc_cuda_h2d_staged(const uint8_t* data, size_t len,
                                         int device);
extern "C" void trpc_cuda_pool_stats(uint64_t out[10]);

namespace {

int g_failures = 0;
#define CHECK_TRUE(x)                                     \
  do {                                                    \
    if (!(x)) {                                           \
      printf("FAIL %s:%d: %s\n", __FILE__, __LINE__, #x); \
      ++g_failures;                                       \
    }                                                     \
  } while (0)

typedef int (*CtxGetFn)(void**);
typedef int (*CtxSetFn)(void*);
typedef int (*InitFn)(unsigned);
typedef int (*RetainFn)(void**, int);
typedef unsigned long long (*CallsFn)(const char*);

// The driver the plane binds, opened again: the same library, so the
// same per-thread current context.
struct Cu {
  CtxGetFn get = nullptr;
  CtxSetFn set = nullptr;
  CallsFn calls = nullptr;  // the fake's count of an entry point's calls
  void* ctx0 = nullptr;  // device 0's primary context

  void* current() const {
    void* c = nullptr;
    return get(&c) == 0 ? c : (void*)-1;
  }
};

bool open_driver(Cu* cu) {
  const char* path = getenv("TRPC_CUDA_DRIVER");
  if (path == nullptr || path[0] == '\0') {
    printf("TRPC_CUDA_DRIVER must name libcuda_fake.so\n");
    return false;
  }
  void* dso = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (dso == nullptr) {
    printf("dlopen %s: %s\n", path, dlerror());
    return false;
  }
  cu->get = (CtxGetFn)dlsym(dso, "cuCtxGetCurrent");
  cu->set = (CtxSetFn)dlsym(dso, "cuCtxSetCurrent");
  InitFn init = (InitFn)dlsym(dso, "cuInit");
  RetainFn retain = (RetainFn)dlsym(dso, "cuDevicePrimaryCtxRetain");
  cu->calls = (CallsFn)dlsym(dso, "trpc_fake_cuda_calls");
  return cu->get != nullptr && cu->calls != nullptr && cu->set != nullptr && init != nullptr &&
         retain != nullptr && init(0) == 0 && retain(&cu->ctx0, 0) == 0;
}

void plane_races(const Cu& cu) {
  CHECK_TRUE(tpu_plane_device_count() >= 2);
  const int kThreads = 6;
  const int kRounds = 120;
  std::string payload(8192, '\x5a');
  std::atomic<uint64_t> roundtrips{0}, freed_races{0}, hops{0};
  std::atomic<int> bad{0}, moved{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t) {
    ts.emplace_back([&, t]() {
      void* mine = t % 2 == 0 ? cu.ctx0 : nullptr;
      cu.set(mine);
      for (int i = 0; i < kRounds; ++i) {
        IOBuf src;
        src.append(payload.data(), payload.size());
        TpuBufId id = tpu_h2d_from_iobuf(src, (t + i) % 2);
        if (id == 0) {
          bad.fetch_add(1);
          continue;
        }
        if (i % 2 == 0) {
          // a racing thread frees the buffer while the copy is in flight
          std::thread killer([id, &cu, &moved]() {
            tpu_buf_free(id);
            if (cu.current() != nullptr) {
              moved.fetch_add(1);
            }
          });
          (void)tpu_buf_wait(id, 1000000);  // wait and d2h race the free
          char* mem = nullptr;
          size_t len = 0;
          if (tpu_d2h_raw(id, &mem, &len) == 0) {
            tpu_host_free(mem);
          }
          killer.join();
          tpu_buf_free(id);  // double free: idempotent
          freed_races.fetch_add(1);
        } else {
          if (tpu_buf_wait(id, 5000000) != 0) {
            bad.fetch_add(1);
          } else {
            TpuBufId read_id = id;
            TpuBufId hop = 0;
            if (i % 4 == 1) {  // through the other device first
              hop = tpu_d2d(id, (t + i + 1) % 2);
              if (hop != 0) {
                read_id = hop;
                hops.fetch_add(1);
              } else {
                bad.fetch_add(1);
              }
            }
            char* mem = nullptr;
            size_t len = 0;
            int rc = tpu_d2h_raw(read_id, &mem, &len);
            if (rc != 0 || len != payload.size() ||
                memcmp(mem, payload.data(), len) != 0) {
              bad.fetch_add(1);
            }
            if (rc == 0) {
              tpu_host_free(mem);
            }
            if (hop != 0) {
              tpu_buf_free(hop);
            }
            roundtrips.fetch_add(1);
          }
          tpu_buf_free(id);
        }
        if (cu.current() != mine) {
          moved.fetch_add(1);
        }
      }
    });
  }
  for (auto& t : ts) {
    t.join();
  }
  // the delayed completions run out, then every slot has drained
  for (int spin = 0; spin < 200 && tpu_plane_stats().live_buffers != 0;
       ++spin) {
    usleep(10000);
  }
  TpuPlaneStats st = tpu_plane_stats();
  CHECK_TRUE(bad.load() == 0);
  CHECK_TRUE(moved.load() == 0);
  CHECK_TRUE(st.live_buffers == 0);
  CHECK_TRUE(roundtrips.load() == (uint64_t)kThreads * kRounds / 2);
  printf("ok plane_races roundtrips=%llu freed_races=%llu hops=%llu "
         "moved_contexts=%d errors=%llu\n",
         (unsigned long long)roundtrips.load(),
         (unsigned long long)freed_races.load(),
         (unsigned long long)hops.load(), moved.load(),
         (unsigned long long)st.errors);
}

void pool_races(const Cu& cu) {
  const int kThreads = 6;
  const int kRounds = 120;
  const size_t kSizes[] = {4096, 6000, 8192, 65536};
  uint64_t before[10];
  trpc_cuda_pool_stats(before);
  uint64_t gathers = tpu_plane_stats().gather_copies;
  std::atomic<uint64_t> roundtrips{0}, freed_races{0};
  std::atomic<int> bad{0}, moved{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t) {
    ts.emplace_back([&, t]() {
      void* mine = t % 2 == 0 ? cu.ctx0 : nullptr;
      cu.set(mine);
      for (int i = 0; i < kRounds; ++i) {
        size_t len = kSizes[(t + i) % 4];
        std::string payload(len, (char)('a' + (t + i) % 26));
        int dev = (t + i) % 2;
        TpuBufId id = 0;
        if (i % 3 == 2) {  // the gather: an IOBuf of several blocks
          IOBuf src;
          for (size_t off = 0; off < len; off += 1000) {
            IOBuf part;
            part.append(payload.data() + off,
                        len - off < 1000 ? len - off : 1000);
            src.append(std::move(part));
          }
          id = tpu_h2d_from_iobuf(src, dev);
        } else {
          id = trpc_cuda_h2d_staged((const uint8_t*)payload.data(), len, dev);
        }
        if (id == 0) {
          bad.fetch_add(1);
          continue;
        }
        if (i % 2 == 0) {
          std::thread killer([id, &cu, &moved]() {
            tpu_buf_free(id);
            if (cu.current() != nullptr) {
              moved.fetch_add(1);
            }
          });
          char* mem = nullptr;
          size_t n = 0;
          if (tpu_d2h_raw(id, &mem, &n) == 0) {
            std::thread([mem]() { tpu_host_free(mem); }).join();
          }
          killer.join();
          tpu_buf_free(id);
          freed_races.fetch_add(1);
        } else {
          TpuBufId read_id = id;
          TpuBufId hop = 0;
          if (i % 4 == 1) {
            hop = tpu_d2d(id, 1 - dev);
            read_id = hop != 0 ? hop : id;
            if (hop == 0) {
              bad.fetch_add(1);
            }
          }
          char* mem = nullptr;
          size_t n = 0;
          int rc = tpu_d2h_raw(read_id, &mem, &n);
          if (rc != 0 || n != len || memcmp(mem, payload.data(), n) != 0) {
            bad.fetch_add(1);
          }
          if (hop != 0) {
            tpu_buf_free(hop);
          }
          tpu_buf_free(id);
          if (rc == 0) {  // the zone goes back from another thread
            std::thread([mem]() { tpu_host_free(mem); }).join();
          }
          roundtrips.fetch_add(1);
        }
        if (cu.current() != mine) {
          moved.fetch_add(1);
        }
      }
    });
  }
  for (auto& t : ts) {
    t.join();
  }
  for (int spin = 0; spin < 200 && tpu_plane_stats().live_buffers != 0;
       ++spin) {
    usleep(10000);
  }
  uint64_t after[10];
  trpc_cuda_pool_stats(after);
  TpuPlaneStats st = tpu_plane_stats();
  CHECK_TRUE(bad.load() == 0);
  CHECK_TRUE(moved.load() == 0);
  CHECK_TRUE(st.live_buffers == 0);
  CHECK_TRUE(roundtrips.load() == (uint64_t)kThreads * kRounds / 2);
  CHECK_TRUE(after[0] > before[0]);  // device-cache hits
  CHECK_TRUE(after[5] > before[5]);  // host-pool hits
  CHECK_TRUE(st.gather_copies == gathers + (uint64_t)kThreads * kRounds / 3);
  printf("ok pool_races roundtrips=%llu freed_races=%llu device_hits=%llu "
         "device_misses=%llu host_hits=%llu host_misses=%llu "
         "moved_contexts=%d\n",
         (unsigned long long)roundtrips.load(),
         (unsigned long long)freed_races.load(),
         (unsigned long long)(after[0] - before[0]),
         (unsigned long long)(after[1] - before[1]),
         (unsigned long long)(after[5] - before[5]),
         (unsigned long long)(after[6] - before[6]), moved.load());
}

void slot_races(const Cu& cu) {
  if (!uring_available()) {
    printf("skip slot_races: the kernel refuses io_uring\n");
    return;
  }
  uring_set_enabled(true);
  if (!uring_enabled()) {
    printf("skip slot_races: the ring engine did not come up\n");
    return;
  }
  const int kThreads = 6;
  const int kRounds = 40;
  const size_t kSizes[] = {65536, 1u << 20};
  int64_t slots = 0, in_use = 0;
  uring_zc_pool_stats(&slots, &in_use);
  std::atomic<uint64_t> roundtrips{0};
  std::atomic<int> bad{0}, moved{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t) {
    ts.emplace_back([&, t]() {
      void* mine = t % 2 == 0 ? cu.ctx0 : nullptr;
      cu.set(mine);
      for (int i = 0; i < kRounds; ++i) {
        size_t len = kSizes[(t + i) % 2];
        std::string payload(len, (char)('A' + (t + i) % 26));
        TpuBufId id =
            trpc_cuda_h2d_staged((const uint8_t*)payload.data(), len, i % 2);
        if (id == 0) {
          bad.fetch_add(1);
          continue;
        }
        char* mem = nullptr;
        size_t n = 0;
        int rc = tpu_d2h_raw(id, &mem, &n);
        if (rc != 0 || n != len || memcmp(mem, payload.data(), n) != 0) {
          bad.fetch_add(1);
        }
        tpu_buf_free(id);
        if (rc == 0) {  // the zone goes back from another thread
          std::thread([mem]() { tpu_host_free(mem); }).join();
        }
        roundtrips.fetch_add(1);
        if (cu.current() != mine) {
          moved.fetch_add(1);
        }
      }
    });
  }
  for (auto& t : ts) {
    t.join();
  }
  for (int spin = 0; spin < 200 && tpu_plane_stats().live_buffers != 0;
       ++spin) {
    usleep(10000);
  }
  int64_t slots_after = 0, in_use_after = 0;
  uring_zc_pool_stats(&slots_after, &in_use_after);
  unsigned long long registered = cu.calls("cuMemHostRegister_v2");
  CHECK_TRUE(bad.load() == 0);
  CHECK_TRUE(moved.load() == 0);
  CHECK_TRUE(tpu_plane_stats().live_buffers == 0);
  CHECK_TRUE(roundtrips.load() == (uint64_t)kThreads * kRounds);
  CHECK_TRUE(in_use_after == 0);
  CHECK_TRUE(registered >= 1 && (int64_t)registered <= slots);
  printf("ok slot_races roundtrips=%llu slots=%lld registered=%llu "
         "moved_contexts=%d\n",
         (unsigned long long)roundtrips.load(), (long long)slots, registered,
         moved.load());
}

}  // namespace

int main() {
  Cu cu;
  if (!open_driver(&cu)) {
    return 2;
  }
  if (getenv("TRPC_FAKE_CUDA_DELAY_US") == nullptr) {
    setenv("TRPC_FAKE_CUDA_DELAY_US", "300", 1);
  }
  fiber_runtime_init(4);
  if (tpu_plane_init(nullptr) != 0) {
    printf("plane init: %s\n", tpu_plane_error());
    return 2;
  }
  CHECK_TRUE(cu.current() == nullptr);  // init left the main thread as is
  plane_races(cu);
  pool_races(cu);
  slot_races(cu);
  if (g_failures == 0) {
    printf("ALL PLANE RACES PASSED\n");
    return 0;
  }
  printf("%d FAILURES\n", g_failures);
  return 1;
}
