// libcudahook.so.1 — CUDA driver-API interposer, the PyTorch port's
// counterpart of native/shim/interposer.cc (libtpushim.so.1) and of
// KubeShare's Gemini hook libgemhook.so.1.
//
// LD_PRELOADed into a fractional pod whose workload knows nothing of
// tokens (the scheduler injects it as it injects the JAX shim).  It gates
// the pod's work on the card through the chip's token broker
// (tpushare-pmgr / tpushare-tokend, native/shim/client.cc compiled in),
// charges *device* time measured at completion, and charges every device
// allocation against the pod's cap through the broker's MEM protocol.
//
// Where it hooks.  A process reaches the driver three ways, all covered:
//  1. exported symbols that shadow libcuda.so.1's (direct linking);
//  2. dlsym: lookups of a hooked cu* name (and of cuGetProcAddress) in
//     libcuda come back as the wrapper (the JAX shim's technique; the real
//     dlsym is found through dlvsym);
//  3. cuGetProcAddress(_v2): the CUDA 12 runtime resolves every driver
//     function through it, by base name, cudaVersion and flags.  The hook
//     calls the real one and maps the pointer it returns onto the wrapper
//     of the variant it is (compared with dlsym of each variant in
//     libcuda); a pointer that is none of them is mapped by name, version
//     and the per-thread flag; every other symbol passes untouched.
//
// What it gates.
//  * Graph launches (cuGraphLaunch, _ptsz) are captured steps.  A graph
//    that runs kGraphGrantMs (10 ms) or more takes a token for each
//    launch, like the JAX shim's Execute, and is charged
//    completion-to-completion after it.  A shorter one (a decode step, an
//    engine dispatch) rides a lease as eager launches do: a grant's round
//    trip through the pod's broker took 1-3 ms on an H100 machine's host,
//    and one per 3.6 ms engine dispatch cost the serving engine 44% of
//    its tokens/s there.
//    A graph's first launch takes a token, which measures it.  Its class
//    is kept by the exec's address until cuGraphExecDestroy, which the
//    hook wraps to forget it: a graph instantiated later at that address
//    is measured anew.
//  * Eager launches (cuLaunchKernel, cuLaunchKernelEx,
//    cuLaunchCooperativeKernel and their _ptsz forms) come by the
//    thousand; a round trip each would cost more than the launch.  So one
//    acquire grants a lease for the quota the broker returns, launches
//    pass while it lasts, and the lease is then settled and its token
//    released.  A lease that sees no launch for kIdleMs (200 ms, the
//    guard's idle_release_ms) is returned.
//  * While any stream captures (tracked through cuStreamBeginCapture*,
//    cuStreamEndCapture), launches pass ungated and uncharged: they are
//    recorded, not run, and the graph's launch is charged later.  The hook
//    then makes no capture-unsafe call: no marker is enqueued anywhere
//    until the capture ends.
//
// How it measures.  Completion is observed by a host function
// (cuLaunchHostFunc) enqueued behind the work on each stream the work
// used; it only stamps the time (no CUDA call).  A lease's launches fall
// into segments, each closed by markers once launches go quiet (kQuietMs,
// 2 ms) or the host is about to wait (cuCtxSynchronize,
// cuStreamSynchronize, cuEventSynchronize): the lease is charged its
// segments' device spans, not the host's gaps between them nor the wait
// before it went back.  A helper thread releases each completed charge
// over TCP; every span is ready - max(start, previous ready), so
// overlapping streams are never charged twice.  The launching thread
// never waits for the device: settling a lease enqueues its markers and
// moves on, and the next acquire waits at the broker if it must (in the
// broker's exclusive mode, until the helper's release arrives; the
// helper waits on markers alone, so neither side can hold up the
// other).  Where no marker can be enqueued, the charge ends at the last
// launch (a graph: at the end of its dispatch), the documented lower
// bound.
//
// Memory.  Every allocation is a call the hook sees before the memory
// exists: cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged,
// cuMemAllocAsync, cuMemAllocFromPoolAsync (and _ptsz) and cuMemCreate
// (the VMM path of PyTorch's expandable segments) are charged with
// tpushare_mem_request before the real call; a DENY returns
// CUDA_ERROR_OUT_OF_MEMORY (TPUSHARE_MEM_ENFORCE=soft logs and lets it
// pass).  The charge is rolled back when the real call fails, and a
// pointer (or handle) -> bytes ledger credits exactly the charge on
// cuMemFree_v2, cuMemFreeAsync (_ptsz) and cuMemRelease: the JAX shim's
// symmetry rules.  cuMemGetInfo_v2 reports the pod's cap
// (TPUSHARE_MEM_FRACTION of the card) as total and cap - charged as free,
// so torch.cuda.mem_get_info sees the cap.  Not seen: the primary
// context's own memory (never a cuMemAlloc), the 32-bit v1 entry points
// (cuMemAlloc, cuMemFree: passed through), pinned host memory, and
// memory mapped from a handle released before its unmap.
//
// Modes, as the JAX shim's: no POD_MANAGER_PORT (or no broker at start)
// runs ungated with one stderr line; a broker that goes away fails open;
// at process exit the lease is settled, so that no grant is left held.
//
// Counters (launches by kind and by kernel name, acquires, charged ms,
// charged / credited bytes, denials, the resolution paths by calling
// library) are written as JSON at exit to $CUDAHOOK_STATS and read
// in-process through cudahook_stats().  CUDAHOOK_LOG=1 logs every cu*
// symbol the dlsym and cuGetProcAddress hooks see.
//
// Build: g++ -std=c++17 -shared -fPIC -O2 cuda_hook.cc
//        native/shim/client.cc -ldl -pthread -o libcudahook.so.1
// (kubeshare_tpu_torch/isolation/hook.py: hook_path()).

#include <dlfcn.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <type_traits>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include "cuda_driver_api.h"

extern "C" {
int tpushare_init_from_env(void);
double tpushare_acquire(double est_ms);
int tpushare_release(double used_ms);
int tpushare_mem_request(long long delta_bytes);
}

using namespace cudahook;

namespace {

double NowMs() {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// The real dlsym and libcuda.
// ---------------------------------------------------------------------------

typedef void* (*DlsymFn)(void*, const char*);

DlsymFn RealDlsym() {
  static DlsymFn real = [] {
    for (const char* version : {"GLIBC_2.34", "GLIBC_2.2.5", "GLIBC_2.17"}) {
      void* fn = dlvsym(RTLD_NEXT, "dlsym", version);
      if (fn != nullptr) return reinterpret_cast<DlsymFn>(fn);
    }
    return static_cast<DlsymFn>(nullptr);
  }();
  return real;
}

// libcuda.so.1 as loaded in this process (loaded here if it is not yet:
// a hooked entry point is being called, so the process uses it anyway)
void* Libcuda() {
  static std::atomic<void*> handle{nullptr};
  void* h = handle.load();
  if (h != nullptr) return h;
  h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
  if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
  if (h != nullptr) handle.store(h);
  return h;
}

void* LibcudaSymbol(const char* name) {
  DlsymFn real = RealDlsym();
  void* lib = Libcuda();
  return real != nullptr && lib != nullptr ? real(lib, name) : nullptr;
}

// Entry points the hook calls but does not wrap, resolved once.
template <typename F>
F* Unwrapped(const char* name, std::atomic<void*>* slot) {
  void* fn = slot->load();
  if (fn == nullptr) {
    fn = LibcudaSymbol(name);
    slot->store(fn);
  }
  return reinterpret_cast<F*>(fn);
}
#define CUDAHOOK_UNWRAPPED(fn)                                   \
  fn##_t* Real_##fn() {                                          \
    static std::atomic<void*> slot{nullptr};                     \
    return Unwrapped<fn##_t>(#fn, &slot);                        \
  }
CUDAHOOK_UNWRAPPED(cuLaunchHostFunc)
CUDAHOOK_UNWRAPPED(cuCtxGetCurrent)
CUDAHOOK_UNWRAPPED(cuCtxSetCurrent)
CUDAHOOK_UNWRAPPED(cuFuncGetName)
CUDAHOOK_UNWRAPPED(cuKernelGetName)
#undef CUDAHOOK_UNWRAPPED

// ---------------------------------------------------------------------------
// The table of wrapped entry points: (variant, its type, base name, the
// cudaVersion it appeared in, per-thread-stream form, wrapper).
// ---------------------------------------------------------------------------

#define CUDAHOOK_ENTRIES(X)                                                   \
  X(cuGetProcAddress, cuGetProcAddress_t, cuGetProcAddress, 11030, 0,          \
    HookedGetProcAddress)                                                      \
  X(cuGetProcAddress_v2, cuGetProcAddress_v2_t, cuGetProcAddress, 12000, 0,    \
    HookedGetProcAddress_v2)                                                   \
  X(cuLaunchKernel, cuLaunchKernel_t, cuLaunchKernel, 4000, 0,                 \
    HookedLaunchKernel)                                                        \
  X(cuLaunchKernel_ptsz, cuLaunchKernel_t, cuLaunchKernel, 7000, 1,            \
    HookedLaunchKernel)                                                        \
  X(cuLaunchKernelEx, cuLaunchKernelEx_t, cuLaunchKernelEx, 11060, 0,          \
    HookedLaunchKernelEx)                                                      \
  X(cuLaunchKernelEx_ptsz, cuLaunchKernelEx_t, cuLaunchKernelEx, 11060, 1,     \
    HookedLaunchKernelEx)                                                      \
  X(cuLaunchCooperativeKernel, cuLaunchCooperativeKernel_t,                    \
    cuLaunchCooperativeKernel, 9000, 0, HookedLaunchCooperativeKernel)         \
  X(cuLaunchCooperativeKernel_ptsz, cuLaunchCooperativeKernel_t,               \
    cuLaunchCooperativeKernel, 9000, 1, HookedLaunchCooperativeKernel)         \
  X(cuGraphLaunch, cuGraphLaunch_t, cuGraphLaunch, 10000, 0,                   \
    HookedGraphLaunch)                                                         \
  X(cuGraphLaunch_ptsz, cuGraphLaunch_t, cuGraphLaunch, 10000, 1,              \
    HookedGraphLaunch)                                                         \
  X(cuStreamBeginCapture, cuStreamBeginCapture_t, cuStreamBeginCapture,       \
    10000, 0, HookedBeginCapture)                                              \
  X(cuStreamBeginCapture_ptsz, cuStreamBeginCapture_t, cuStreamBeginCapture,  \
    10000, 1, HookedBeginCapture)                                              \
  X(cuStreamBeginCapture_v2, cuStreamBeginCapture_v2_t, cuStreamBeginCapture, \
    10010, 0, HookedBeginCapture_v2)                                           \
  X(cuStreamBeginCapture_v2_ptsz, cuStreamBeginCapture_v2_t,                   \
    cuStreamBeginCapture, 10010, 1, HookedBeginCapture_v2)                     \
  X(cuStreamBeginCaptureToGraph, cuStreamBeginCaptureToGraph_t,                \
    cuStreamBeginCaptureToGraph, 12030, 0, HookedBeginCaptureToGraph)          \
  X(cuStreamBeginCaptureToGraph_ptsz, cuStreamBeginCaptureToGraph_t,           \
    cuStreamBeginCaptureToGraph, 12030, 1, HookedBeginCaptureToGraph)          \
  X(cuStreamEndCapture, cuStreamEndCapture_t, cuStreamEndCapture, 10000, 0,    \
    HookedEndCapture)                                                          \
  X(cuStreamEndCapture_ptsz, cuStreamEndCapture_t, cuStreamEndCapture, 10000,  \
    1, HookedEndCapture)                                                       \
  X(cuStreamDestroy, cuStreamDestroy_t, cuStreamDestroy, 2000, 0,              \
    HookedStreamDestroy)                                                       \
  X(cuGraphExecDestroy, cuGraphExecDestroy_t, cuGraphExecDestroy, 10000, 0,    \
    HookedGraphExecDestroy)                                                    \
  X(cuCtxSynchronize, cuCtxSynchronize_t, cuCtxSynchronize, 2000, 0,           \
    HookedCtxSynchronize)                                                      \
  X(cuStreamSynchronize, cuStreamSynchronize_t, cuStreamSynchronize, 2000, 0,  \
    HookedStreamSynchronize)                                                   \
  X(cuStreamSynchronize_ptsz, cuStreamSynchronize_t, cuStreamSynchronize,      \
    7000, 1, HookedStreamSynchronize)                                          \
  X(cuEventSynchronize, cuEventSynchronize_t, cuEventSynchronize, 2000, 0,     \
    HookedEventSynchronize)                                                    \
  X(cuStreamDestroy_v2, cuStreamDestroy_t, cuStreamDestroy, 4000, 0,           \
    HookedStreamDestroy)                                                       \
  X(cuMemAlloc_v2, cuMemAlloc_v2_t, cuMemAlloc, 3020, 0, HookedMemAlloc)       \
  X(cuMemAllocPitch_v2, cuMemAllocPitch_v2_t, cuMemAllocPitch, 3020, 0,        \
    HookedMemAllocPitch)                                                       \
  X(cuMemAllocManaged, cuMemAllocManaged_t, cuMemAllocManaged, 6000, 0,        \
    HookedMemAllocManaged)                                                     \
  X(cuMemAllocAsync, cuMemAllocAsync_t, cuMemAllocAsync, 11020, 0,             \
    HookedMemAllocAsync)                                                       \
  X(cuMemAllocAsync_ptsz, cuMemAllocAsync_t, cuMemAllocAsync, 11020, 1,        \
    HookedMemAllocAsync)                                                       \
  X(cuMemAllocFromPoolAsync, cuMemAllocFromPoolAsync_t,                        \
    cuMemAllocFromPoolAsync, 11020, 0, HookedMemAllocFromPoolAsync)            \
  X(cuMemAllocFromPoolAsync_ptsz, cuMemAllocFromPoolAsync_t,                   \
    cuMemAllocFromPoolAsync, 11020, 1, HookedMemAllocFromPoolAsync)            \
  X(cuMemCreate, cuMemCreate_t, cuMemCreate, 10020, 0, HookedMemCreate)        \
  X(cuMemFree_v2, cuMemFree_v2_t, cuMemFree, 3020, 0, HookedMemFree)           \
  X(cuMemFreeAsync, cuMemFreeAsync_t, cuMemFreeAsync, 11020, 0,                \
    HookedMemFreeAsync)                                                        \
  X(cuMemFreeAsync_ptsz, cuMemFreeAsync_t, cuMemFreeAsync, 11020, 1,           \
    HookedMemFreeAsync)                                                        \
  X(cuMemRelease, cuMemRelease_t, cuMemRelease, 10020, 0, HookedMemRelease)    \
  X(cuMemGetInfo_v2, cuMemGetInfo_v2_t, cuMemGetInfo, 3020, 0,                 \
    HookedMemGetInfo)

enum Index {
#define X(NAME, TYPE, BASE, SINCE, PTSZ, IMPL) k_##NAME,
  CUDAHOOK_ENTRIES(X)
#undef X
  kEntries
};

struct Entry {
  const char* name;
  const char* base;
  int since;
  bool ptsz;
  void* wrapper;
  std::atomic<void*> real;
};

Entry* Entries();  // defined after the wrappers

// libcuda's own definition of entry i (null while libcuda is not loaded)
void* RealPtr(int i) {
  Entry& e = Entries()[i];
  void* fn = e.real.load();
  if (fn == nullptr) {
    fn = LibcudaSymbol(e.name);
    if (fn != nullptr) e.real.store(fn);
  }
  return fn;
}

template <typename F>
F* Real(int i) {
  return reinterpret_cast<F*>(RealPtr(i));
}

int IndexOfName(const char* name) {
  for (int i = 0; i < kEntries; i++) {
    if (std::strcmp(Entries()[i].name, name) == 0) return i;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Counters (no side effects beyond memory: safe to touch from dlsym).
// ---------------------------------------------------------------------------

struct KernelCount {
  std::string name;
  std::atomic<long long> launches{0};
};

struct Stats {
  // the process the counters and the gate belong to: a forked child
  // (a data loader's worker) inherits them, and the broker's connection,
  // but must not settle or write them at its exit
  pid_t owner = getpid();
  std::mutex mu;  // names, paths and the direct-caller cache
  std::unordered_map<const void*, KernelCount*> kernels;  // by handle
  // calling library -> path -> lookups of cu* names
  std::map<std::string, std::map<std::string, long long>> paths;
  std::unordered_set<const void*> direct_callers;
  std::atomic<long long> graph_launches{0}, eager_launches{0},
      captured_launches{0}, graph_launches_in_lease{0};
};

void WriteStatsAtExit();

Stats& S() {
  static Stats* stats = [] {
    auto* s = new Stats;  // leaked: host functions may fire after main
    if (std::getenv("CUDAHOOK_STATS") != nullptr) std::atexit(WriteStatsAtExit);
    return s;
  }();
  return *stats;
}

bool LogOn() {
  static bool on = [] {
    const char* v = std::getenv("CUDAHOOK_LOG");
    return v != nullptr && *v != '\0' && std::strcmp(v, "0") != 0;
  }();
  return on;
}

std::string CallerLibrary(const void* address) {
  Dl_info info;
  if (address == nullptr || dladdr(address, &info) == 0 ||
      info.dli_fname == nullptr) {
    return "?";
  }
  const char* slash = std::strrchr(info.dli_fname, '/');
  return slash != nullptr ? slash + 1 : info.dli_fname;
}

void RecordPath(const char* path, const void* caller) {
  std::string library = CallerLibrary(caller);
  std::lock_guard<std::mutex> lock(S().mu);
  S().paths[library][path]++;
}

// Direct calls: the calling library, recorded once per call site.
void RecordDirect(const void* caller) {
  Stats& s = S();
  {
    std::lock_guard<std::mutex> lock(s.mu);
    if (!s.direct_callers.insert(caller).second) return;
  }
  RecordPath("direct", caller);
}

// The launched kernel's name: cuFuncGetName, else cuKernelGetName (a
// CUkernel launched as a CUfunction); cached per handle.
void CountKernel(CUfunction f) {
  Stats& s = S();
  KernelCount* count = nullptr;
  {
    std::lock_guard<std::mutex> lock(s.mu);
    auto it = s.kernels.find(f);
    if (it != s.kernels.end()) count = it->second;
  }
  if (count == nullptr) {
    const char* name = nullptr;
    cuFuncGetName_t* func_name = Real_cuFuncGetName();
    if (func_name == nullptr || func_name(&name, f) != CUDA_SUCCESS ||
        name == nullptr) {
      name = nullptr;
      cuKernelGetName_t* kernel_name = Real_cuKernelGetName();
      if (kernel_name == nullptr ||
          kernel_name(&name, reinterpret_cast<CUkernel>(f)) != CUDA_SUCCESS) {
        name = nullptr;
      }
    }
    auto* fresh = new KernelCount;
    fresh->name = name != nullptr ? name : "?";
    std::lock_guard<std::mutex> lock(s.mu);
    auto inserted = s.kernels.emplace(f, fresh);
    if (!inserted.second) delete fresh;
    count = inserted.first->second;
  }
  count->launches++;
}

// ---------------------------------------------------------------------------
// The gate: lease, capture state, completion charging, memory ledger.
// ---------------------------------------------------------------------------

// A charge in flight.  Three kinds: a graph launch's (its own grant), a
// lease's (a grant, charged the sum of its segments), and a segment's
// (launches under a lease between two quiet gaps; charged into its lease).
struct Pending {
  double start_ms;
  double ready_ms;   // the latest marker, or the lower bound
  int markers;       // outstanding markers (a lease: open segments), plus
                     // one hold while the owner may still add some
  bool graph;
  CUgraphExec exec = nullptr;  // a graph launch's graph
  Pending* lease = nullptr;   // a segment's lease
  double segments_ms = 0.0;   // a lease's charge so far
  bool abandoned = false;  // released at exit before its markers fired
};

// A lease with no launch for this long is returned (the guard's default
// idle_release_ms).
constexpr double kIdleMs = 200.0;

struct Gate {
  bool gated = false;
  bool soft = false;
  double mem_fraction = -1.0;

  // lease and capture state; never held across a blocking call
  std::mutex mu;
  std::condition_variable cv;  // an acquire in flight finished
  int capturing = 0;
  std::unordered_set<CUstream> capture_streams;
  bool acquiring = false;
  bool lease = false;
  std::atomic<bool> lease_held{false};  // `lease`, for the helper's tick
  double lease_end = 0.0, last_launch = 0.0;
  Pending* lease_charge = nullptr;
  Pending* segment = nullptr;  // the lease's open segment, if any
  struct LeaseStream {
    CUstream stream;
    CUcontext ctx;
    bool unmarked;  // launched on since its last marker
  };
  std::vector<LeaseStream> lease_streams;
  long long acquires = 0, leases = 0, segments = 0, markers = 0,
            broker_errors = 0;
  double acquire_ms = 0.0;  // time the launching threads spent acquiring

  // completion charging (taken by the host functions: never held across
  // a CUDA call)
  std::mutex charge_mu;
  std::condition_variable charge_cv;
  std::deque<Pending*> done;  // completed, in completion order
  std::unordered_set<Pending*> live;  // not yet released
  double last_complete_ms = 0.0;
  // EMA of each graph's charges under its own grants: its acquire asks
  // for at least this (the JAX shim's estimate), and a graph shorter than
  // kGraphGrantMs rides a lease instead.  A lease asks for nothing: it
  // lasts whatever quota the broker grants, and its long charges must not
  // inflate a graph's quota, and with it the broker's per-grant floor
  // (5% of the quota, tokend Release).  Keyed by the exec's address, which
  // the driver hands out again after cuGraphExecDestroy: the destroy
  // erases the entry (ForgetGraph)
  std::unordered_map<CUgraphExec, double> graph_ms;
  double charged_ms = 0.0;
  long long releases = 0, graph_destroys = 0;

  // memory ledger
  std::mutex mem_mu;
  std::unordered_map<CUdeviceptr, long long> pointers;
  std::unordered_map<CUmemGenericAllocationHandle, long long> handles;
  long long held_bytes = 0, charged_bytes = 0, credited_bytes = 0,
            rolled_back_bytes = 0, denials = 0, soft_overs = 0;
};

void HelperLoop(Gate* g);
void SettleAtExit();

double EnvDouble(const char* name, double fallback) {
  const char* raw = std::getenv(name);
  if (raw == nullptr || *raw == '\0') return fallback;
  char* end = nullptr;
  double value = std::strtod(raw, &end);
  return end == raw ? fallback : value;
}

Gate& G() {
  static Gate* gate = [] {
    S();  // its exit handler first, so that it runs after the settle
    auto* g = new Gate;  // leaked, as every container a host function touches
    const char* mode = std::getenv("TPUSHARE_MEM_ENFORCE");
    g->soft = mode != nullptr && std::strcmp(mode, "soft") == 0;
    double fraction = EnvDouble("TPUSHARE_MEM_FRACTION", -1.0);
    g->mem_fraction = fraction > 0.0 && fraction <= 1.0 ? fraction : -1.0;
    g->gated = tpushare_init_from_env() == 0;
    if (!g->gated) {
      const char* port = std::getenv("POD_MANAGER_PORT");
      if (port == nullptr || *port == '\0') {
        std::fprintf(stderr, "cudahook: no POD_MANAGER_PORT, running ungated\n");
      } else {
        std::fprintf(stderr,
                     "cudahook: no broker at POD_MANAGER_PORT=%s, running "
                     "ungated\n", port);
      }
    } else {
      std::thread(HelperLoop, g).detach();
      // registered here, after the CUDA runtime's own exit handler (it
      // initialised before the first hooked call): runs before it
      std::atexit(SettleAtExit);
    }
    return g;
  }();
  return *gate;
}

// Called with charge_mu held or from the sole owner of p.
void MarkerDoneLocked(Gate& g, Pending* p, double when) {
  if (when > p->ready_ms) p->ready_ms = when;
  if (--p->markers == 0 && !p->abandoned) {
    g.done.push_back(p);
    g.charge_cv.notify_all();
  }
}

void MarkerDone(Gate& g, Pending* p, double when) {
  std::lock_guard<std::mutex> lock(g.charge_mu);
  MarkerDoneLocked(g, p, when);
}

// The host function: stamps the completion and nothing else (no CUDA
// call is permitted here).
void Marker(void* arg) {
  MarkerDone(G(), static_cast<Pending*>(arg), NowMs());
}

Pending* NewPending(Gate& g, double start_ms, double ready_ms, bool graph,
                    CUgraphExec exec = nullptr) {
  auto* p = new Pending{start_ms, ready_ms, 1, graph};
  p->exec = exec;
  std::lock_guard<std::mutex> lock(g.charge_mu);
  g.live.insert(p);
  return p;
}

// Enqueue p's marker behind the work on `stream` (in its context).
// Caller holds g.mu and has checked that no capture is live.
bool EnqueueMarker(Gate& g, Pending* p, CUstream stream, CUcontext ctx,
                   bool other_thread) {
  cuLaunchHostFunc_t* launch_host = Real_cuLaunchHostFunc();
  if (launch_host == nullptr) return false;
  CUcontext current = nullptr;
  cuCtxGetCurrent_t* get_ctx = Real_cuCtxGetCurrent();
  cuCtxSetCurrent_t* set_ctx = Real_cuCtxSetCurrent();
  bool switched = false;
  if (ctx != nullptr && get_ctx != nullptr && set_ctx != nullptr &&
      get_ctx(&current) == CUDA_SUCCESS && current != ctx) {
    switched = set_ctx(ctx) == CUDA_SUCCESS;
  }
  // another thread's per-thread default stream is not this thread's: the
  // legacy stream waits for it (and for every blocking stream)
  if (other_thread && stream == StreamPerThread()) stream = StreamLegacy();
  {
    std::lock_guard<std::mutex> lock(g.charge_mu);
    p->markers++;
  }
  bool ok = launch_host(stream, Marker, p) == CUDA_SUCCESS;
  if (ok) {
    g.markers++;
  } else {
    MarkerDone(g, p, 0.0);
  }
  if (switched) set_ctx(current);
  return ok;
}

// Close the lease's open segment: markers behind its work on every
// stream it launched on.  The helper does this once launches go quiet
// (kQuietMs), so that a lease is charged its segments' device spans, not
// the host's gaps between them, nor the wait before it was returned (for
// idleness, at exit).  Caller holds g.mu.
void MarkLeaseLocked(Gate& g, bool other_thread) {
  if (g.capturing > 0 || g.segment == nullptr) return;  // none while capturing
  for (auto& entry : g.lease_streams) {
    if (!entry.unmarked) continue;
    EnqueueMarker(g, g.segment, entry.stream, entry.ctx, other_thread);
    entry.unmarked = false;
  }
  MarkerDone(g, g.segment, g.last_launch);  // its lower bound: the last launch
  g.segment = nullptr;
}

// Settle the lease: its open segment closed (at its last launch when a
// capture forbids a marker), the hold dropped; the helper releases the
// token once every segment's markers have fired.  Caller holds g.mu.
void EndLeaseLocked(Gate& g, bool other_thread) {
  MarkLeaseLocked(g, other_thread);
  if (g.segment != nullptr) {
    MarkerDone(g, g.segment, g.last_launch);
    g.segment = nullptr;
  }
  Pending* p = g.lease_charge;
  g.lease_charge = nullptr;
  g.lease = false;
  g.lease_held = false;
  g.lease_streams.clear();
  MarkerDone(g, p, 0.0);
}

void StartLeaseLocked(Gate& g, double now, double quota) {
  g.lease_charge = NewPending(g, now, now, false);
  g.lease = true;
  g.lease_held = true;
  g.lease_end = now + quota;
  g.acquires++;
  g.leases++;
  g.charge_cv.notify_all();  // the helper's tick turns fine
}

// A launch under the lease: it joins the open segment (or opens one), and
// its stream is owed a marker.
void LaunchedInLeaseLocked(Gate& g, CUstream stream, double now) {
  g.last_launch = now;
  if (g.segment == nullptr) {
    g.segment = NewPending(g, now, now, false);
    g.segment->lease = g.lease_charge;
    std::lock_guard<std::mutex> lock(g.charge_mu);
    g.lease_charge->markers++;
    g.segments++;
  }
  for (auto& entry : g.lease_streams) {
    if (entry.stream == stream) {
      entry.unmarked = true;
      return;
    }
  }
  CUcontext ctx = nullptr;
  cuCtxGetCurrent_t* get_ctx = Real_cuCtxGetCurrent();
  if (get_ctx != nullptr && get_ctx(&ctx) != CUDA_SUCCESS) ctx = nullptr;
  g.lease_streams.push_back({stream, ctx, true});
}

CUstream Normalize(CUstream stream, bool ptsz) {
  return ptsz && stream == nullptr ? StreamPerThread() : stream;
}

// A graph's EMA charge, or -1 before its first one.
double GraphMs(Gate& g, CUgraphExec exec) {
  std::lock_guard<std::mutex> lock(g.charge_mu);
  auto it = g.graph_ms.find(exec);
  return it == g.graph_ms.end() ? -1.0 : it->second;
}

// A completed charge.  A graph's and a segment's span is the JAX shim's
// ChargeCompletion, ready - max(start, previous ready): overlapping
// streams are never charged twice.  A segment's goes into its lease; a
// lease (all its segments in) and a graph release their grant.
void Release(Gate& g, Pending* p) {
  double charged;
  {
    std::lock_guard<std::mutex> lock(g.charge_mu);
    if (p->graph || p->lease != nullptr) {
      double base = std::max(g.last_complete_ms, p->start_ms);
      charged = std::max(0.0, p->ready_ms - base);
      g.last_complete_ms = std::max(g.last_complete_ms, p->ready_ms);
    } else {
      charged = p->segments_ms;
    }
    if (p->lease != nullptr) {
      p->lease->segments_ms += charged;
      MarkerDoneLocked(g, p->lease, 0.0);
      g.live.erase(p);
      if (!p->abandoned) delete p;
      g.charge_cv.notify_all();
      return;
    }
    // a graph destroyed while its charge was in flight has no exec left
    // (ForgetGraph): its class is not recorded again
    if (p->graph && p->exec != nullptr) {
      auto seen = g.graph_ms.emplace(p->exec, charged);
      if (!seen.second) {
        seen.first->second = 0.8 * seen.first->second + 0.2 * charged;
      }
    }
    g.charged_ms += charged;
    g.releases++;
  }
  if (tpushare_release(charged) < 0) {
    std::lock_guard<std::mutex> lock(g.mu);
    g.broker_errors++;
  }
  std::lock_guard<std::mutex> lock(g.charge_mu);
  g.live.erase(p);
  if (!p->abandoned) delete p;
  g.charge_cv.notify_all();
}

constexpr double kQuietMs = 2.0;

// The helper's tick: progress markers once launches go quiet, the lease
// returned once it has been idle for kIdleMs.
void Tick(Gate& g) {
  std::lock_guard<std::mutex> lock(g.mu);
  if (!g.lease || g.capturing > 0 || g.acquiring) return;
  double quiet = NowMs() - g.last_launch;
  if (quiet >= kIdleMs) {
    EndLeaseLocked(g, /*other_thread=*/true);
  } else if (g.segment != nullptr && quiet >= kQuietMs) {
    MarkLeaseLocked(g, /*other_thread=*/true);
  }
}

void HelperLoop(Gate* g) {
  using Ms = std::chrono::duration<double, std::milli>;
  while (true) {
    std::deque<Pending*> done;
    {
      // a fine tick while a lease is held (its quiet gaps), a coarse one
      // otherwise; a lease taken meanwhile ends the coarse wait
      bool coarse = !g->lease_held;
      Ms tick(coarse ? kIdleMs / 4 : kQuietMs / 2);
      std::unique_lock<std::mutex> lock(g->charge_mu);
      g->charge_cv.wait_for(lock, tick, [g, coarse] {
        return !g->done.empty() || (coarse && g->lease_held);
      });
      done.swap(g->done);
    }
    for (Pending* p : done) Release(*g, p);
    Tick(*g);
  }
}

// An eager launch: under the lease (taken, or renewed once expired), or
// ungated while a capture is live.  The launch itself is issued under
// g.mu, so that no marker can slip in between its bookkeeping and it.
template <typename Call>
CUresult EagerLaunch(CUstream stream, Call call) {
  Gate& g = G();
  std::unique_lock<std::mutex> lock(g.mu);
  if (g.capturing > 0) {
    S().captured_launches++;
    lock.unlock();
    return call();
  }
  if (!g.gated) {
    lock.unlock();
    return call();
  }
  while (g.acquiring) g.cv.wait(lock);
  double now = NowMs();
  if (g.lease && now >= g.lease_end && g.capturing == 0) {
    EndLeaseLocked(g, false);
  }
  if (!g.lease) {
    g.acquiring = true;
    lock.unlock();
    double asked = NowMs();
    double quota = tpushare_acquire(0.0);
    lock.lock();
    g.acquire_ms += NowMs() - asked;
    g.acquiring = false;
    g.cv.notify_all();
    if (quota < 0) {  // broker gone: fail open
      g.broker_errors++;
      lock.unlock();
      return call();
    }
    now = NowMs();
    if (!g.lease) StartLeaseLocked(g, now, quota);
  }
  CUresult rc = call();
  if (g.capturing == 0) LaunchedInLeaseLocked(g, stream, now);
  return rc;
}

template <int I>
CUresult HookedLaunchKernel(CUfunction f, unsigned int gx, unsigned int gy,
                            unsigned int gz, unsigned int bx, unsigned int by,
                            unsigned int bz, unsigned int shared,
                            CUstream stream, void** params, void** extra) {
  S().eager_launches++;
  CountKernel(f);
  return EagerLaunch(Normalize(stream, Entries()[I].ptsz), [&] {
    return Real<cuLaunchKernel_t>(I)(f, gx, gy, gz, bx, by, bz, shared, stream,
                                     params, extra);
  });
}

template <int I>
CUresult HookedLaunchKernelEx(const CUlaunchConfig* config, CUfunction f,
                              void** params, void** extra) {
  S().eager_launches++;
  CountKernel(f);
  CUstream stream =
      config != nullptr
          ? reinterpret_cast<const LaunchConfigLayout*>(config)->hStream
          : nullptr;
  return EagerLaunch(Normalize(stream, Entries()[I].ptsz), [&] {
    return Real<cuLaunchKernelEx_t>(I)(config, f, params, extra);
  });
}

template <int I>
CUresult HookedLaunchCooperativeKernel(CUfunction f, unsigned int gx,
                                       unsigned int gy, unsigned int gz,
                                       unsigned int bx, unsigned int by,
                                       unsigned int bz, unsigned int shared,
                                       CUstream stream, void** params) {
  S().eager_launches++;
  CountKernel(f);
  return EagerLaunch(Normalize(stream, Entries()[I].ptsz), [&] {
    return Real<cuLaunchCooperativeKernel_t>(I)(f, gx, gy, gz, bx, by, bz,
                                                shared, stream, params);
  });
}

// A graph launch: its own grant, like the JAX shim's Execute, when its
// graph runs kGraphGrantMs or more (a grant's round trip through the
// pod's broker costs 1-3 ms, see the top of this file); a ride on the live
// lease, or a lease of its own, otherwise.  Its first launch takes a
// grant, which measures it.
constexpr double kGraphGrantMs = 10.0;

template <int I>
CUresult HookedGraphLaunch(CUgraphExec exec, CUstream stream) {
  auto* real = Real<cuGraphLaunch_t>(I);
  Gate& g = G();
  S().graph_launches++;
  CUstream key = Normalize(stream, Entries()[I].ptsz);
  double known = GraphMs(g, exec);
  {
    std::lock_guard<std::mutex> lock(g.mu);
    if (g.capturing > 0) {
      S().captured_launches++;
      return real(exec, stream);
    }
    if (!g.gated) return real(exec, stream);
    double now = NowMs();
    if (g.lease && now < g.lease_end) {
      S().graph_launches_in_lease++;
      CUresult rc = real(exec, stream);
      LaunchedInLeaseLocked(g, key, now);
      return rc;
    }
    if (known < 0 || known >= kGraphGrantMs) {
      // an expired lease goes back first: in the broker's exclusive mode
      // the graph's grant waits for its release
      if (g.lease) EndLeaseLocked(g, false);
    }
  }
  if (known >= 0 && known < kGraphGrantMs) {
    S().graph_launches_in_lease++;
    return EagerLaunch(key, [&] { return real(exec, stream); });
  }
  double asked = NowMs();
  double quota = tpushare_acquire(std::max(known, 1.0));
  {
    std::lock_guard<std::mutex> lock(g.mu);
    g.acquire_ms += NowMs() - asked;
  }
  if (quota < 0) {  // broker gone: fail open
    std::lock_guard<std::mutex> lock(g.mu);
    g.broker_errors++;
    return real(exec, stream);
  }
  double start = NowMs();
  CUresult rc = real(exec, stream);
  double dispatched = NowMs();
  Pending* p = NewPending(g, start, dispatched, true, exec);
  {
    std::lock_guard<std::mutex> lock(g.mu);
    g.acquires++;
    // charged from the dispatch alone when it failed or a capture began
    // meanwhile (no marker may be enqueued then)
    if (rc == CUDA_SUCCESS && g.capturing == 0) {
      EnqueueMarker(g, p, key, nullptr, false);
    }
  }
  MarkerDone(g, p, 0.0);
  return rc;
}

// ---- capture tracking ------------------------------------------------------

void CaptureBegun(CUstream stream) {
  Gate& g = G();
  std::lock_guard<std::mutex> lock(g.mu);
  if (g.capture_streams.insert(stream).second) g.capturing++;
}

void CaptureEnded(CUstream stream) {
  Gate& g = G();
  std::lock_guard<std::mutex> lock(g.mu);
  if (g.capture_streams.erase(stream) > 0) g.capturing--;
}

// Marked capturing before the real call, so that no marker can be
// enqueued between the capture's start and the hook's knowing of it.
template <typename Call>
CUresult BeginCapture(CUstream stream, Call call) {
  CaptureBegun(stream);
  CUresult rc = call();
  if (rc != CUDA_SUCCESS) CaptureEnded(stream);
  return rc;
}

template <int I>
CUresult HookedBeginCapture(CUstream stream) {
  CUstream key = Normalize(stream, Entries()[I].ptsz);
  return BeginCapture(key, [&] {
    return Real<cuStreamBeginCapture_t>(I)(stream);
  });
}

template <int I>
CUresult HookedBeginCapture_v2(CUstream stream, CUstreamCaptureMode mode) {
  CUstream key = Normalize(stream, Entries()[I].ptsz);
  return BeginCapture(key, [&] {
    return Real<cuStreamBeginCapture_v2_t>(I)(stream, mode);
  });
}

template <int I>
CUresult HookedBeginCaptureToGraph(CUstream stream, CUgraph graph,
                                   const CUgraphNode* deps,
                                   const CUgraphEdgeData* edges, size_t n,
                                   CUstreamCaptureMode mode) {
  CUstream key = Normalize(stream, Entries()[I].ptsz);
  return BeginCapture(key, [&] {
    return Real<cuStreamBeginCaptureToGraph_t>(I)(stream, graph, deps, edges,
                                                  n, mode);
  });
}

template <int I>
CUresult HookedEndCapture(CUstream stream, CUgraph* graph) {
  CUresult rc = Real<cuStreamEndCapture_t>(I)(stream, graph);
  CaptureEnded(Normalize(stream, Entries()[I].ptsz));  // ends, valid or not
  return rc;
}

// A stream about to go away: settle a lease that used it while its handle
// is still valid.
template <int I>
CUresult HookedStreamDestroy(CUstream stream) {
  Gate& g = G();
  {
    std::lock_guard<std::mutex> lock(g.mu);
    if (g.lease && g.capturing == 0) {
      for (const auto& entry : g.lease_streams) {
        if (entry.stream == stream) {
          EndLeaseLocked(g, false);
          break;
        }
      }
    }
  }
  return Real<cuStreamDestroy_t>(I)(stream);
}

// A graph about to go away: its class is forgotten before the driver may
// hand its address to the next instantiation, which is then measured anew
// (with the old class, a short graph there would pay a grant on every
// launch, and a long one would ride the lease unmeasured).  A charge of
// this graph still in flight forgets it too: rather than a generation per
// exec, each live charge drops its exec under charge_mu, the lock Release
// takes, so that a release completing after the destroy finds no exec and
// cannot record the dead graph's class again.
void ForgetGraph(Gate& g, CUgraphExec exec) {
  std::lock_guard<std::mutex> lock(g.charge_mu);
  g.graph_ms.erase(exec);
  for (Pending* p : g.live) {
    if (p->exec == exec) p->exec = nullptr;
  }
  g.graph_destroys++;
}

template <int I>
CUresult HookedGraphExecDestroy(CUgraphExec exec) {
  if (exec != nullptr) ForgetGraph(G(), exec);
  return Real<cuGraphExecDestroy_t>(I)(exec);
}

// ---- host waits --------------------------------------------------------------

// The host is about to wait for the device: mark the lease's open work
// now, so that a synchronous loop's segments end at their completion
// rather than kQuietMs later.  (A wait is itself capture-unsafe: there is
// none while a global capture is live, and the hook adds none.)
void MarkBeforeWait() {
  Gate& g = G();
  if (!g.gated) return;
  std::lock_guard<std::mutex> lock(g.mu);
  if (g.lease) MarkLeaseLocked(g, false);
}

template <int I>
CUresult HookedCtxSynchronize() {
  MarkBeforeWait();
  return Real<cuCtxSynchronize_t>(I)();
}

template <int I>
CUresult HookedStreamSynchronize(CUstream stream) {
  MarkBeforeWait();
  return Real<cuStreamSynchronize_t>(I)(stream);
}

template <int I>
CUresult HookedEventSynchronize(CUevent event) {
  MarkBeforeWait();
  return Real<cuEventSynchronize_t>(I)(event);
}

// ---- memory ----------------------------------------------------------------

// Charge `bytes` before an allocation: false when it must be denied.
// *charged says whether the broker recorded it.
bool Charge(Gate& g, long long bytes, const char* what, bool* charged) {
  *charged = false;
  if (!g.gated || bytes <= 0) return true;
  int rc = tpushare_mem_request(bytes);
  *charged = rc > 0;
  std::lock_guard<std::mutex> lock(g.mem_mu);
  if (rc > 0) {
    g.charged_bytes += bytes;
  } else if (rc == 0) {  // broker DENY; rc < 0 (broker gone) fails open
    if (!g.soft) {
      g.denials++;
      std::fprintf(stderr,
                   "cudahook: device memory cap exceeded: %lld-byte %s "
                   "denied (pod over its gpu_mem cap)\n", bytes, what);
      return false;
    }
    g.soft_overs++;
    std::fprintf(stderr,
                 "cudahook: device memory cap exceeded by %lld-byte %s "
                 "(soft mode; not denied)\n", bytes, what);
  } else {
    std::lock_guard<std::mutex> gate_lock(g.mu);
    g.broker_errors++;
  }
  return true;
}

void RollBack(Gate& g, long long bytes) {
  tpushare_mem_request(-bytes);
  std::lock_guard<std::mutex> lock(g.mem_mu);
  g.charged_bytes -= bytes;
  g.rolled_back_bytes += bytes;
}

template <typename Key>
void Record(Gate& g, std::unordered_map<Key, long long>& ledger, Key key,
            long long bytes) {
  std::lock_guard<std::mutex> lock(g.mem_mu);
  ledger[key] += bytes;
  g.held_bytes += bytes;
}

// Credit exactly what was charged for `key`; nothing for memory the hook
// never charged.
template <typename Key>
void Credit(Gate& g, std::unordered_map<Key, long long>& ledger, Key key) {
  long long credit = 0;
  {
    std::lock_guard<std::mutex> lock(g.mem_mu);
    auto it = ledger.find(key);
    if (it == ledger.end()) return;
    credit = it->second;
    ledger.erase(it);
    g.held_bytes -= credit;
    g.credited_bytes += credit;
  }
  if (credit > 0) tpushare_mem_request(-credit);
}

// Charge, call, then record or roll back: the shape of every allocation.
template <typename Call>
CUresult Allocate(long long bytes, const char* what, CUdeviceptr* dptr,
                  Call call) {
  Gate& g = G();
  bool charged = false;
  if (!Charge(g, bytes, what, &charged)) return CUDA_ERROR_OUT_OF_MEMORY;
  CUresult rc = call();
  if (rc == CUDA_SUCCESS && charged && dptr != nullptr) {
    Record(g, g.pointers, *dptr, bytes);
  } else if (charged) {
    RollBack(g, bytes);
  }
  return rc;
}

template <int I>
CUresult HookedMemAlloc(CUdeviceptr* dptr, size_t bytes) {
  return Allocate(static_cast<long long>(bytes), "cuMemAlloc", dptr, [&] {
    return Real<cuMemAlloc_v2_t>(I)(dptr, bytes);
  });
}

template <int I>
CUresult HookedMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                               unsigned int flags) {
  return Allocate(static_cast<long long>(bytes), "cuMemAllocManaged", dptr,
                  [&] { return Real<cuMemAllocManaged_t>(I)(dptr, bytes, flags); });
}

template <int I>
CUresult HookedMemAllocAsync(CUdeviceptr* dptr, size_t bytes,
                             CUstream stream) {
  return Allocate(static_cast<long long>(bytes), "cuMemAllocAsync", dptr,
                  [&] { return Real<cuMemAllocAsync_t>(I)(dptr, bytes, stream); });
}

template <int I>
CUresult HookedMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                     CUmemoryPool pool, CUstream stream) {
  return Allocate(static_cast<long long>(bytes), "cuMemAllocFromPoolAsync",
                  dptr, [&] {
                    return Real<cuMemAllocFromPoolAsync_t>(I)(dptr, bytes,
                                                              pool, stream);
                  });
}

// Pitched: the pitch is known only after the call, so the row-padding is
// charged afterwards (and the allocation undone if that charge is denied).
template <int I>
CUresult HookedMemAllocPitch(CUdeviceptr* dptr, size_t* pitch, size_t width,
                             size_t height, unsigned int element_bytes) {
  Gate& g = G();
  long long estimate = static_cast<long long>(width * height);
  bool charged = false;
  if (!Charge(g, estimate, "cuMemAllocPitch", &charged)) {
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  CUresult rc =
      Real<cuMemAllocPitch_v2_t>(I)(dptr, pitch, width, height, element_bytes);
  if (rc != CUDA_SUCCESS || !charged) {
    if (charged) RollBack(g, estimate);
    return rc;
  }
  long long bytes = estimate;
  long long padding =
      static_cast<long long>(*pitch * height) - estimate;
  if (padding > 0) {
    bool padding_charged = false;
    if (!Charge(g, padding, "cuMemAllocPitch row padding", &padding_charged)) {
      Real<cuMemFree_v2_t>(k_cuMemFree_v2)(*dptr);
      RollBack(g, estimate);
      return CUDA_ERROR_OUT_OF_MEMORY;
    }
    if (padding_charged) bytes += padding;
  }
  Record(g, g.pointers, *dptr, bytes);
  return rc;
}

template <int I>
CUresult HookedMemCreate(CUmemGenericAllocationHandle* handle, size_t size,
                         const CUmemAllocationProp* prop,
                         unsigned long long flags) {
  Gate& g = G();
  bool charged = false;
  long long bytes = static_cast<long long>(size);
  if (!Charge(g, bytes, "cuMemCreate", &charged)) {
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  CUresult rc = Real<cuMemCreate_t>(I)(handle, size, prop, flags);
  if (rc == CUDA_SUCCESS && charged && handle != nullptr) {
    Record(g, g.handles, *handle, bytes);
  } else if (charged) {
    RollBack(g, bytes);
  }
  return rc;
}

template <int I>
CUresult HookedMemFree(CUdeviceptr dptr) {
  CUresult rc = Real<cuMemFree_v2_t>(I)(dptr);
  if (rc == CUDA_SUCCESS) Credit(G(), G().pointers, dptr);
  return rc;
}

template <int I>
CUresult HookedMemFreeAsync(CUdeviceptr dptr, CUstream stream) {
  CUresult rc = Real<cuMemFreeAsync_t>(I)(dptr, stream);
  if (rc == CUDA_SUCCESS) Credit(G(), G().pointers, dptr);
  return rc;
}

template <int I>
CUresult HookedMemRelease(CUmemGenericAllocationHandle handle) {
  CUresult rc = Real<cuMemRelease_t>(I)(handle);
  if (rc == CUDA_SUCCESS) Credit(G(), G().handles, handle);
  return rc;
}

// The pod's cap as total, cap - charged as free (never more than the
// card has free).
long long CapBytes(Gate& g, size_t total) {
  return g.mem_fraction > 0.0
             ? static_cast<long long>(g.mem_fraction *
                                      static_cast<double>(total))
             : -1;
}

template <int I>
CUresult HookedMemGetInfo(size_t* free, size_t* total) {
  CUresult rc = Real<cuMemGetInfo_v2_t>(I)(free, total);
  Gate& g = G();
  if (rc != CUDA_SUCCESS || free == nullptr || total == nullptr) return rc;
  long long cap = CapBytes(g, *total);
  if (cap < 0) return rc;
  long long held;
  {
    std::lock_guard<std::mutex> lock(g.mem_mu);
    held = g.held_bytes;
  }
  long long room = std::max(0LL, cap - held);
  *total = static_cast<size_t>(cap);
  *free = std::min(*free, static_cast<size_t>(room));
  return rc;
}

// ---- resolution ------------------------------------------------------------

void LogLookup(const char* path, const char* symbol, int version,
               cuuint64_t flags, const void* caller, const char* outcome) {
  if (!LogOn()) return;
  std::fprintf(stderr, "cudahook: %s %s version %d flags %llu from %s: %s\n",
               path, symbol != nullptr ? symbol : "(null)", version,
               static_cast<unsigned long long>(flags),
               CallerLibrary(caller).c_str(), outcome);
}

// The wrapper for a pointer the real cuGetProcAddress returned for
// `symbol`: by identity with a variant's real address, else by name,
// version and the per-thread flag; anything else passes untouched.
void* MapResolved(const char* symbol, void* fn, int version, cuuint64_t flags,
                  const void* caller) {
  for (int i = 0; i < kEntries; i++) {
    if (RealPtr(i) == fn) {
      RecordPath("proc_address", caller);
      LogLookup("cuGetProcAddress", symbol, version, flags, caller,
                Entries()[i].name);
      return Entries()[i].wrapper;
    }
  }
  bool ptsz = (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) != 0;
  int best = -1;
  for (int i = 0; i < kEntries; i++) {
    const Entry& e = Entries()[i];
    bool named = std::strcmp(e.name, symbol) == 0 ||
                 (std::strcmp(e.base, symbol) == 0 && e.since <= version &&
                  e.ptsz == ptsz);
    if (named && RealPtr(i) != nullptr &&
        (best < 0 || e.since > Entries()[best].since)) {
      best = i;
    }
  }
  if (best >= 0) {
    RecordPath("proc_address_by_name", caller);
    LogLookup("cuGetProcAddress", symbol, version, flags, caller,
              (std::string(Entries()[best].name) + " (by name)").c_str());
    return Entries()[best].wrapper;
  }
  if (symbol != nullptr && symbol[0] == 'c' && symbol[1] == 'u') {
    RecordPath("proc_address_passed", caller);
  }
  LogLookup("cuGetProcAddress", symbol, version, flags, caller, "passed");
  return fn;
}

template <int I>
CUresult HookedGetProcAddress(const char* symbol, void** pfn, int version,
                              cuuint64_t flags) {
  CUresult rc = Real<cuGetProcAddress_t>(I)(symbol, pfn, version, flags);
  if (rc == CUDA_SUCCESS && pfn != nullptr && *pfn != nullptr &&
      symbol != nullptr) {
    *pfn = MapResolved(symbol, *pfn, version, flags,
                       __builtin_return_address(0));
  }
  return rc;
}

template <int I>
CUresult HookedGetProcAddress_v2(const char* symbol, void** pfn, int version,
                                 cuuint64_t flags,
                                 CUdriverProcAddressQueryResult* status) {
  CUresult rc =
      Real<cuGetProcAddress_v2_t>(I)(symbol, pfn, version, flags, status);
  if (rc == CUDA_SUCCESS && pfn != nullptr && *pfn != nullptr &&
      symbol != nullptr) {
    *pfn = MapResolved(symbol, *pfn, version, flags,
                       __builtin_return_address(0));
  }
  return rc;
}

// ---- the table --------------------------------------------------------------

Entry* Entries() {
  static Entry* entries = [] {
    auto* table = new Entry[kEntries];  // leaked: resolved lazily, for good
    int i = 0;
#define X(NAME, TYPE, BASE, SINCE, PTSZ, IMPL)                             \
  static_assert(std::is_same<decltype(IMPL<k_##NAME>), TYPE>::value,       \
                #IMPL " does not have the type of " #NAME);                \
  table[i].name = #NAME;                                                   \
  table[i].base = #BASE;                                                   \
  table[i].since = SINCE;                                                  \
  table[i].ptsz = PTSZ != 0;                                               \
  table[i].wrapper = reinterpret_cast<void*>(&IMPL<k_##NAME>);             \
  table[i].real.store(nullptr);                                            \
  i++;
    CUDAHOOK_ENTRIES(X)
#undef X
    return table;
  }();
  return entries;
}

// ---- exit and counters -----------------------------------------------------

// Settle what is outstanding before the CUDA runtime's own exit handler:
// the lease's markers are enqueued, and every charge not released within
// two seconds is released up to now (the broker never sees a grant left
// held by a pod that exited).
void SettleAtExit() {
  if (getpid() != S().owner) return;
  Gate& g = G();
  {
    std::lock_guard<std::mutex> lock(g.mu);
    if (g.lease) EndLeaseLocked(g, false);
  }
  std::vector<Pending*> stuck;
  {
    std::unique_lock<std::mutex> lock(g.charge_mu);
    g.charge_cv.wait_for(lock, std::chrono::seconds(2),
                         [&g] { return g.live.empty(); });
    double now = NowMs();
    for (Pending* p : g.live) {
      // a lease waits on its segments, not on markers of its own
      if (p->markers > 0 && (p->graph || p->lease != nullptr)) {
        p->abandoned = true;  // a late marker must not queue it again
        p->ready_ms = now;
        stuck.push_back(p);
      }
    }
  }
  for (Pending* p : stuck) Release(g, p);
  // the helper may hold completed charges: wait until it has released them
  std::unique_lock<std::mutex> lock(g.charge_mu);
  g.charge_cv.wait_for(lock, std::chrono::seconds(2),
                       [&g] { return g.live.empty(); });
}

void AppendEscaped(std::string* out, const std::string& text) {
  for (char c : text) {
    if (c == '"' || c == '\\') {
      out->push_back('\\');
      out->push_back(c);
    } else if (static_cast<unsigned char>(c) < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof(buf), "\\u%04x", c);
      *out += buf;
    } else {
      out->push_back(c);
    }
  }
}

std::string StatsJson() {
  Stats& s = S();
  Gate& g = G();
  char buf[512];
  std::string out = "{";
  {
    std::lock_guard<std::mutex> lock(g.mu);
    std::snprintf(buf, sizeof(buf),
                  "\"gated\":%s,\"capturing\":%d,\"lease_held\":%s,"
                  "\"acquires\":%lld,\"acquire_ms\":%.6f,\"leases\":%lld,"
                  "\"segments\":%lld,\"markers\":%lld,"
                  "\"broker_errors\":%lld,",
                  g.gated ? "true" : "false", g.capturing,
                  g.lease ? "true" : "false", g.acquires, g.acquire_ms,
                  g.leases, g.segments, g.markers, g.broker_errors);
    out += buf;
  }
  std::snprintf(buf, sizeof(buf),
                "\"graph_launches\":%lld,\"eager_launches\":%lld,"
                "\"captured_launches\":%lld,\"graph_launches_in_lease\":%lld,",
                s.graph_launches.load(), s.eager_launches.load(),
                s.captured_launches.load(), s.graph_launches_in_lease.load());
  out += buf;
  {
    std::lock_guard<std::mutex> lock(g.charge_mu);
    std::snprintf(buf, sizeof(buf),
                  "\"charged_ms\":%.6f,\"releases\":%lld,\"pending\":%zu,"
                  "\"graph_classes\":%zu,\"graph_destroys\":%lld,",
                  g.charged_ms, g.releases, g.live.size(), g.graph_ms.size(),
                  g.graph_destroys);
    out += buf;
  }
  {
    std::lock_guard<std::mutex> lock(g.mem_mu);
    std::snprintf(buf, sizeof(buf),
                  "\"charged_bytes\":%lld,\"credited_bytes\":%lld,"
                  "\"rolled_back_bytes\":%lld,\"held_bytes\":%lld,"
                  "\"denials\":%lld,\"soft_overs\":%lld,\"mem_fraction\":%g,",
                  g.charged_bytes, g.credited_bytes, g.rolled_back_bytes,
                  g.held_bytes, g.denials, g.soft_overs, g.mem_fraction);
    out += buf;
  }
  std::lock_guard<std::mutex> lock(s.mu);
  std::map<std::string, long long> by_name;
  for (const auto& kv : s.kernels) {
    by_name[kv.second->name] += kv.second->launches.load();
  }
  out += "\"kernels\":{";
  bool first = true;
  for (const auto& kv : by_name) {
    if (!first) out += ",";
    first = false;
    out += "\"";
    AppendEscaped(&out, kv.first);
    out += "\":" + std::to_string(kv.second);
  }
  out += "},\"resolution\":{";
  first = true;
  for (const auto& lib : s.paths) {
    if (!first) out += ",";
    first = false;
    out += "\"";
    AppendEscaped(&out, lib.first);
    out += "\":{";
    bool first_path = true;
    for (const auto& path : lib.second) {
      if (!first_path) out += ",";
      first_path = false;
      out += "\"" + path.first + "\":" + std::to_string(path.second);
    }
    out += "}";
  }
  out += "}}";
  return out;
}

void WriteStatsAtExit() {
  if (getpid() != S().owner) return;
  const char* path = std::getenv("CUDAHOOK_STATS");
  if (path == nullptr || *path == '\0') return;
  std::string json = StatsJson();
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "w");
  if (f == nullptr) return;
  std::fwrite(json.data(), 1, json.size(), f);
  std::fputc('\n', f);
  std::fclose(f);
  std::rename(tmp.c_str(), path);
}

}  // namespace

// ---------------------------------------------------------------------------
// Exported: path 1 (the driver's own names), the dlsym hook (path 2), and
// the counters.
// ---------------------------------------------------------------------------

#define CUDAHOOK_CALLER __builtin_return_address(0)

#define CUDAHOOK_EXPORT_LAUNCH_KERNEL(name)                                    \
  extern "C" CUresult name(CUfunction f, unsigned int gx, unsigned int gy,     \
                           unsigned int gz, unsigned int bx, unsigned int by,  \
                           unsigned int bz, unsigned int shared,               \
                           CUstream stream, void** params, void** extra) {     \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedLaunchKernel<k_##name>(f, gx, gy, gz, bx, by, bz, shared,     \
                                        stream, params, extra);                \
  }
CUDAHOOK_EXPORT_LAUNCH_KERNEL(cuLaunchKernel)
CUDAHOOK_EXPORT_LAUNCH_KERNEL(cuLaunchKernel_ptsz)

#define CUDAHOOK_EXPORT_LAUNCH_KERNEL_EX(name)                                 \
  extern "C" CUresult name(const CUlaunchConfig* config, CUfunction f,         \
                           void** params, void** extra) {                      \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedLaunchKernelEx<k_##name>(config, f, params, extra);           \
  }
CUDAHOOK_EXPORT_LAUNCH_KERNEL_EX(cuLaunchKernelEx)
CUDAHOOK_EXPORT_LAUNCH_KERNEL_EX(cuLaunchKernelEx_ptsz)

#define CUDAHOOK_EXPORT_LAUNCH_COOPERATIVE(name)                               \
  extern "C" CUresult name(CUfunction f, unsigned int gx, unsigned int gy,     \
                           unsigned int gz, unsigned int bx, unsigned int by,  \
                           unsigned int bz, unsigned int shared,               \
                           CUstream stream, void** params) {                   \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedLaunchCooperativeKernel<k_##name>(f, gx, gy, gz, bx, by, bz,  \
                                                   shared, stream, params);    \
  }
CUDAHOOK_EXPORT_LAUNCH_COOPERATIVE(cuLaunchCooperativeKernel)
CUDAHOOK_EXPORT_LAUNCH_COOPERATIVE(cuLaunchCooperativeKernel_ptsz)

#define CUDAHOOK_EXPORT_GRAPH_LAUNCH(name)                                     \
  extern "C" CUresult name(CUgraphExec exec, CUstream stream) {                \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedGraphLaunch<k_##name>(exec, stream);                          \
  }
CUDAHOOK_EXPORT_GRAPH_LAUNCH(cuGraphLaunch)
CUDAHOOK_EXPORT_GRAPH_LAUNCH(cuGraphLaunch_ptsz)

extern "C" CUresult cuGraphExecDestroy(CUgraphExec exec) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedGraphExecDestroy<k_cuGraphExecDestroy>(exec);
}

#define CUDAHOOK_EXPORT_BEGIN_CAPTURE(name)                                    \
  extern "C" CUresult name(CUstream stream) {                                  \
    return HookedBeginCapture<k_##name>(stream);                               \
  }
CUDAHOOK_EXPORT_BEGIN_CAPTURE(cuStreamBeginCapture)
CUDAHOOK_EXPORT_BEGIN_CAPTURE(cuStreamBeginCapture_ptsz)

#define CUDAHOOK_EXPORT_BEGIN_CAPTURE_V2(name)                                 \
  extern "C" CUresult name(CUstream stream, CUstreamCaptureMode mode) {        \
    return HookedBeginCapture_v2<k_##name>(stream, mode);                      \
  }
CUDAHOOK_EXPORT_BEGIN_CAPTURE_V2(cuStreamBeginCapture_v2)
CUDAHOOK_EXPORT_BEGIN_CAPTURE_V2(cuStreamBeginCapture_v2_ptsz)

#define CUDAHOOK_EXPORT_BEGIN_CAPTURE_TO_GRAPH(name)                           \
  extern "C" CUresult name(CUstream stream, CUgraph graph,                     \
                           const CUgraphNode* deps,                            \
                           const CUgraphEdgeData* edges, size_t n,             \
                           CUstreamCaptureMode mode) {                         \
    return HookedBeginCaptureToGraph<k_##name>(stream, graph, deps, edges, n,  \
                                               mode);                          \
  }
CUDAHOOK_EXPORT_BEGIN_CAPTURE_TO_GRAPH(cuStreamBeginCaptureToGraph)
CUDAHOOK_EXPORT_BEGIN_CAPTURE_TO_GRAPH(cuStreamBeginCaptureToGraph_ptsz)

#define CUDAHOOK_EXPORT_END_CAPTURE(name)                                      \
  extern "C" CUresult name(CUstream stream, CUgraph* graph) {                  \
    return HookedEndCapture<k_##name>(stream, graph);                          \
  }
CUDAHOOK_EXPORT_END_CAPTURE(cuStreamEndCapture)
CUDAHOOK_EXPORT_END_CAPTURE(cuStreamEndCapture_ptsz)

#define CUDAHOOK_EXPORT_STREAM_DESTROY(name)                                   \
  extern "C" CUresult name(CUstream stream) {                                  \
    return HookedStreamDestroy<k_##name>(stream);                              \
  }
CUDAHOOK_EXPORT_STREAM_DESTROY(cuStreamDestroy)
CUDAHOOK_EXPORT_STREAM_DESTROY(cuStreamDestroy_v2)

extern "C" CUresult cuCtxSynchronize(void) {
  return HookedCtxSynchronize<k_cuCtxSynchronize>();
}

#define CUDAHOOK_EXPORT_STREAM_SYNCHRONIZE(name)                               \
  extern "C" CUresult name(CUstream stream) {                                  \
    return HookedStreamSynchronize<k_##name>(stream);                          \
  }
CUDAHOOK_EXPORT_STREAM_SYNCHRONIZE(cuStreamSynchronize)
CUDAHOOK_EXPORT_STREAM_SYNCHRONIZE(cuStreamSynchronize_ptsz)

extern "C" CUresult cuEventSynchronize(CUevent event) {
  return HookedEventSynchronize<k_cuEventSynchronize>(event);
}

extern "C" CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemAlloc<k_cuMemAlloc_v2>(dptr, bytes);
}

extern "C" CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch,
                                       size_t width, size_t height,
                                       unsigned int element_bytes) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemAllocPitch<k_cuMemAllocPitch_v2>(dptr, pitch, width, height,
                                                   element_bytes);
}

extern "C" CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                                      unsigned int flags) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemAllocManaged<k_cuMemAllocManaged>(dptr, bytes, flags);
}

#define CUDAHOOK_EXPORT_ALLOC_ASYNC(name)                                      \
  extern "C" CUresult name(CUdeviceptr* dptr, size_t bytes, CUstream stream) { \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedMemAllocAsync<k_##name>(dptr, bytes, stream);                 \
  }
CUDAHOOK_EXPORT_ALLOC_ASYNC(cuMemAllocAsync)
CUDAHOOK_EXPORT_ALLOC_ASYNC(cuMemAllocAsync_ptsz)

#define CUDAHOOK_EXPORT_ALLOC_FROM_POOL(name)                                  \
  extern "C" CUresult name(CUdeviceptr* dptr, size_t bytes, CUmemoryPool pool, \
                           CUstream stream) {                                  \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedMemAllocFromPoolAsync<k_##name>(dptr, bytes, pool, stream);   \
  }
CUDAHOOK_EXPORT_ALLOC_FROM_POOL(cuMemAllocFromPoolAsync)
CUDAHOOK_EXPORT_ALLOC_FROM_POOL(cuMemAllocFromPoolAsync_ptsz)

extern "C" CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                                size_t size, const CUmemAllocationProp* prop,
                                unsigned long long flags) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemCreate<k_cuMemCreate>(handle, size, prop, flags);
}

extern "C" CUresult cuMemFree_v2(CUdeviceptr dptr) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemFree<k_cuMemFree_v2>(dptr);
}

#define CUDAHOOK_EXPORT_FREE_ASYNC(name)                                       \
  extern "C" CUresult name(CUdeviceptr dptr, CUstream stream) {                \
    RecordDirect(CUDAHOOK_CALLER);                                             \
    return HookedMemFreeAsync<k_##name>(dptr, stream);                         \
  }
CUDAHOOK_EXPORT_FREE_ASYNC(cuMemFreeAsync)
CUDAHOOK_EXPORT_FREE_ASYNC(cuMemFreeAsync_ptsz)

extern "C" CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemRelease<k_cuMemRelease>(handle);
}

extern "C" CUresult cuMemGetInfo_v2(size_t* free, size_t* total) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedMemGetInfo<k_cuMemGetInfo_v2>(free, total);
}

extern "C" CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                     int version, cuuint64_t flags) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedGetProcAddress<k_cuGetProcAddress>(symbol, pfn, version, flags);
}

extern "C" CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                        int version, cuuint64_t flags,
                                        CUdriverProcAddressQueryResult* status) {
  RecordDirect(CUDAHOOK_CALLER);
  return HookedGetProcAddress_v2<k_cuGetProcAddress_v2>(symbol, pfn, version,
                                                        flags, status);
}

// Path 2: a lookup of a hooked name in libcuda returns the wrapper.  The
// real dlsym is resolved through dlvsym, which is not interposed.  As in
// the JAX shim, a caller's RTLD_NEXT lookup is resolved from this library
// rather than from the caller (no CUDA runtime looks up the driver so).
extern "C" void* dlsym(void* handle, const char* name) {
  DlsymFn real = RealDlsym();
  if (real == nullptr) return nullptr;
  void* symbol = real(handle, name);
  if (symbol == nullptr || name[0] != 'c' ||
      name[1] != 'u') {
    return symbol;
  }
  const void* caller = __builtin_return_address(0);
  int i = IndexOfName(name);
  if (i >= 0 && symbol == RealPtr(i)) {
    RecordPath("dlsym", caller);
    LogLookup("dlsym", name, 0, 0, caller, Entries()[i].name);
    return Entries()[i].wrapper;
  }
  // an unhooked name, or a hooked one found elsewhere than in libcuda
  // (this library's own export, reached through RTLD_DEFAULT)
  if (LogOn()) LogLookup("dlsym", name, 0, 0, caller, "passed");
  return symbol;
}

// The counters as one JSON object: writes at most capacity - 1 bytes and a
// NUL to `out`; returns the object's full length.
extern "C" long cudahook_stats(char* out, long capacity) {
  std::string json = StatsJson();
  if (out != nullptr && capacity > 0) {
    size_t n = std::min(json.size(), static_cast<size_t>(capacity - 1));
    std::memcpy(out, json.data(), n);
    out[n] = '\0';
  }
  return static_cast<long>(json.size());
}

// Settle now: hand back the lease (unless a capture is live) and wait up
// to timeout_ms for every outstanding charge to be released.  Returns the
// number of charges still outstanding.
extern "C" int cudahook_settle(double timeout_ms) {
  Gate& g = G();
  if (!g.gated) return 0;
  {
    std::lock_guard<std::mutex> lock(g.mu);
    if (g.lease && g.capturing == 0) EndLeaseLocked(g, false);
  }
  std::unique_lock<std::mutex> lock(g.charge_mu);
  g.charge_cv.wait_for(lock,
                       std::chrono::duration<double, std::milli>(timeout_ms),
                       [&g] { return g.live.empty(); });
  return static_cast<int>(g.live.size());
}
