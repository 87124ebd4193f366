// Test driver for libcudahook.so.1 (the CUDA counterpart of
// native/test/interposer_driver.cc): reaches the fake libcuda.so.1 the
// three ways a process reaches the driver, then plays the scenarios its
// flags choose.  Run it with LD_PRELOAD=libcudahook.so.1 and a broker in
// POD_MANAGER_PORT; each step prints one line that the tests read.
//
// usage: hook_driver [options]
//   --path cudart|dlsym|direct  how the entry points are found: dlopen +
//                     dlsym("cuGetProcAddress_v2") and every function
//                     through it (the CUDA runtime's way; the default),
//                     dlsym of each cu* name, or the linked symbols
//   --ptsz            resolve with the per-thread default-stream flag
//   --kernel N        the CUfunction handle launches use (default 7)
//   --graphs N        capture one kernel of --graph-us U microseconds
//                     (default 1000) and launch the graph N times; with
//                     --graph-gap-ms G, each launch waits for the one
//                     before it and then G ms
//   --bursts B        B eager bursts of --burst N (default 10) launches
//                     of --kernel-us U (default 100) microseconds over
//                     --streams S (default 1) streams, --gap-ms G apart
//                     (default 0); prints "burst i done" after each
//   --alloc B         cuMemAlloc_v2 of B bytes: "alloc_ok" or
//                     "alloc_denied rc=<rc>"; freed ("freed") unless
//                     --keep; --alloc-over B2 then asks for B2 more
//                     (before the free): "alloc_over_ok" /
//                     "alloc_over_denied rc=<rc>"
//   --pitch W H       cuMemAllocPitch_v2 (then freed): "pitch_ok
//                     pitch=<p>" / "pitch_denied rc=<rc>"
//   --managed B       cuMemAllocManaged, then freed
//   --async B         cuMemAllocAsync + cuMemFreeAsync
//   --pool-async B    cuMemAllocFromPoolAsync + cuMemFreeAsync
//   --vmm B           cuMemCreate (kept if --keep, else cuMemRelease)
//   --mem-info        print "mem_info free=<f> total=<t>" at the end
//   --lookups         resolution checks: cuMemAlloc at 3010 (v1) and at
//                     the --version, the per-thread launch, an unhooked
//                     and an unknown symbol, the four-argument
//                     cuGetProcAddress, a version too low
//   --capture         a capture of 3 launches on a stream (global mode)
//                     while launches run eagerly on another; the capture
//                     outlasts --capture-ms (default 400): "capture_ok" /
//                     "capture_failed rc=<rc>"
//   --unsafe-in-capture  cuStreamSynchronize inside the capture (the
//                     control: the fake driver must invalidate it)
//   --destroy-stream  destroy the eager streams after the bursts
//   --reuse-graph     a graph of --graph-us launched 3 times (each waited
//                     for, then 50 ms), destroyed once its lease has gone
//                     back, then a graph of --reuse-us U (default 20000)
//                     instantiated in its place: "graph_reused=<0|1>"
//                     (same address), "reuse before <json>", one launch,
//                     "reuse after <json>" (the hook's counters)
//   --destroy-in-flight  a graph of --graph-us launched and destroyed at
//                     once, its charge still in flight; then waited for:
//                     "in_flight after <json>"
//   --exclusive-mix   interleave bursts and graph launches (the broker's
//                     exclusive mode must not stall them)
//   --pause-ms P      after everything, print "idle" and sleep P ms
//   --no-sync         skip the final cuCtxSynchronize
//   --sleep-ms S      sleep S ms before exit
// At the end: "fake <stats>" and, under the hook, "hook <json>".

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "../cuda_driver_api.h"

using namespace cudahook;

// the linked entry points (path "direct")
extern "C" {
cuGetProcAddress_v2_t cuGetProcAddress_v2;
cuLaunchKernel_t cuLaunchKernel;
cuLaunchKernel_t cuLaunchKernel_ptsz;
cuGraphLaunch_t cuGraphLaunch;
cuStreamBeginCapture_v2_t cuStreamBeginCapture_v2;
cuStreamEndCapture_t cuStreamEndCapture;
cuStreamDestroy_t cuStreamDestroy_v2;
cuGraphExecDestroy_t cuGraphExecDestroy;
cuMemAlloc_v2_t cuMemAlloc_v2;
cuMemAllocPitch_v2_t cuMemAllocPitch_v2;
cuMemAllocManaged_t cuMemAllocManaged;
cuMemAllocAsync_t cuMemAllocAsync;
cuMemAllocFromPoolAsync_t cuMemAllocFromPoolAsync;
cuMemCreate_t cuMemCreate;
cuMemFree_v2_t cuMemFree_v2;
cuMemFreeAsync_t cuMemFreeAsync;
cuMemRelease_t cuMemRelease;
cuMemGetInfo_v2_t cuMemGetInfo_v2;
}

namespace {

typedef CUresult InitFn(unsigned int);
typedef CUresult RetainFn(CUcontext*, int);
typedef CUresult StreamCreateFn(CUstream*, unsigned int);
typedef CUresult SyncFn(void);
typedef CUresult StreamSyncFn(CUstream);
typedef CUresult InstantiateFn(CUgraphExec*, CUgraph, unsigned long long);
typedef CUresult V1AllocFn(unsigned int*, unsigned int);
typedef void* FakeSymbolFn(const char*);

struct Api {
  InitFn* init;
  RetainFn* retain;
  cuCtxSetCurrent_t* set_ctx;
  StreamCreateFn* stream_create;
  cuStreamDestroy_t* stream_destroy;
  StreamSyncFn* stream_sync;
  SyncFn* ctx_sync;
  cuStreamBeginCapture_v2_t* begin_capture;
  cuStreamEndCapture_t* end_capture;
  InstantiateFn* instantiate;
  cuGraphExecDestroy_t* graph_destroy;
  cuGraphLaunch_t* graph_launch;
  cuLaunchKernel_t* launch;
  cuMemAlloc_v2_t* alloc;
  cuMemAllocPitch_v2_t* alloc_pitch;
  cuMemAllocManaged_t* alloc_managed;
  cuMemAllocAsync_t* alloc_async;
  cuMemAllocFromPoolAsync_t* alloc_pool;
  cuMemCreate_t* create;
  cuMemFree_v2_t* free;
  cuMemFreeAsync_t* free_async;
  cuMemRelease_t* release;
  cuMemGetInfo_v2_t* mem_info;
};

struct Options {
  std::string path = "cudart";
  int version = 12080;  // the cudaVersion the CUDA 12.8 runtime asks for
  bool ptsz = false;
  long kernel = 7;
  int graphs = 0, graph_gap_ms = -1;
  unsigned int graph_us = 1000, reuse_us = 20000;
  int bursts = 0, burst = 10, streams = 1, gap_ms = 0;
  unsigned int kernel_us = 100;
  long long alloc = 0, alloc_over = 0;
  bool keep = false;
  long long pitch_w = 0, pitch_h = 0, managed = 0, async = 0, pool_async = 0,
            vmm = 0;
  bool mem_info = false, lookups = false, capture = false, unsafe = false,
       destroy_streams = false, exclusive_mix = false, sync = true,
       reuse_graph = false, destroy_in_flight = false;
  int capture_ms = 400, pause_ms = 0, sleep_ms = 0;
};

void* g_lib = nullptr;
cuGetProcAddress_v2_t* g_gpa = nullptr;
Options g_opt;

void Die(const char* what) {
  std::fprintf(stderr, "hook_driver: %s\n", what);
  std::exit(1);
}

void* Resolve(const char* base, const char* exported, bool stream_fn) {
  void* fn = nullptr;
  if (g_opt.path == "cudart") {
    cuuint64_t flags = g_opt.ptsz && stream_fn
                           ? CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM
                           : CU_GET_PROC_ADDRESS_DEFAULT;
    CUdriverProcAddressQueryResult status;
    if (g_gpa(base, &fn, g_opt.version, flags, &status) != CUDA_SUCCESS) {
      return nullptr;
    }
  } else {
    fn = dlsym(g_lib, exported);
  }
  return fn;
}

template <typename F>
F* Need(const char* base, const char* exported, bool stream_fn = false) {
  void* fn = Resolve(base, exported, stream_fn);
  if (fn == nullptr) {
    std::fprintf(stderr, "hook_driver: cannot resolve %s\n", exported);
    std::exit(1);
  }
  return reinterpret_cast<F*>(fn);
}

Api Load() {
  g_lib = dlopen("libcuda.so.1", RTLD_NOW);
  if (g_lib == nullptr) Die(dlerror());
  g_gpa = reinterpret_cast<cuGetProcAddress_v2_t*>(
      dlsym(g_lib, "cuGetProcAddress_v2"));
  if (g_gpa == nullptr) Die("no cuGetProcAddress_v2");
  bool p = g_opt.ptsz;
  Api api;
  // helpers the hook does not wrap come the same way
  api.init = Need<InitFn>("cuInit", "cuInit");
  api.retain = Need<RetainFn>("cuDevicePrimaryCtxRetain",
                              "cuDevicePrimaryCtxRetain");
  api.set_ctx = Need<cuCtxSetCurrent_t>("cuCtxSetCurrent", "cuCtxSetCurrent");
  api.stream_create = Need<StreamCreateFn>("cuStreamCreate", "cuStreamCreate");
  api.stream_sync = Need<StreamSyncFn>("cuStreamSynchronize",
                                       "cuStreamSynchronize");
  api.ctx_sync = Need<SyncFn>("cuCtxSynchronize", "cuCtxSynchronize");
  api.instantiate = Need<InstantiateFn>("cuGraphInstantiateWithFlags",
                                        "cuGraphInstantiateWithFlags");
  if (g_opt.path == "direct") {
    api.stream_destroy = &cuStreamDestroy_v2;
    api.graph_destroy = &cuGraphExecDestroy;
    api.begin_capture = &cuStreamBeginCapture_v2;
    api.end_capture = &cuStreamEndCapture;
    api.graph_launch = &cuGraphLaunch;
    api.launch = p ? &cuLaunchKernel_ptsz : &cuLaunchKernel;
    api.alloc = &cuMemAlloc_v2;
    api.alloc_pitch = &cuMemAllocPitch_v2;
    api.alloc_managed = &cuMemAllocManaged;
    api.alloc_async = &cuMemAllocAsync;
    api.alloc_pool = &cuMemAllocFromPoolAsync;
    api.create = &cuMemCreate;
    api.free = &cuMemFree_v2;
    api.free_async = &cuMemFreeAsync;
    api.release = &cuMemRelease;
    api.mem_info = &cuMemGetInfo_v2;
    return api;
  }
  api.stream_destroy = Need<cuStreamDestroy_t>("cuStreamDestroy",
                                               "cuStreamDestroy_v2");
  api.graph_destroy = Need<cuGraphExecDestroy_t>("cuGraphExecDestroy",
                                                 "cuGraphExecDestroy");
  api.begin_capture = Need<cuStreamBeginCapture_v2_t>(
      "cuStreamBeginCapture", p ? "cuStreamBeginCapture_v2_ptsz"
                                : "cuStreamBeginCapture_v2", true);
  api.end_capture = Need<cuStreamEndCapture_t>(
      "cuStreamEndCapture", p ? "cuStreamEndCapture_ptsz"
                              : "cuStreamEndCapture", true);
  api.graph_launch = Need<cuGraphLaunch_t>(
      "cuGraphLaunch", p ? "cuGraphLaunch_ptsz" : "cuGraphLaunch", true);
  api.launch = Need<cuLaunchKernel_t>(
      "cuLaunchKernel", p ? "cuLaunchKernel_ptsz" : "cuLaunchKernel", true);
  api.alloc = Need<cuMemAlloc_v2_t>("cuMemAlloc", "cuMemAlloc_v2");
  api.alloc_pitch = Need<cuMemAllocPitch_v2_t>("cuMemAllocPitch",
                                               "cuMemAllocPitch_v2");
  api.alloc_managed = Need<cuMemAllocManaged_t>("cuMemAllocManaged",
                                                "cuMemAllocManaged");
  api.alloc_async = Need<cuMemAllocAsync_t>(
      "cuMemAllocAsync", p ? "cuMemAllocAsync_ptsz" : "cuMemAllocAsync",
      true);
  api.alloc_pool = Need<cuMemAllocFromPoolAsync_t>("cuMemAllocFromPoolAsync",
                                                   "cuMemAllocFromPoolAsync");
  api.create = Need<cuMemCreate_t>("cuMemCreate", "cuMemCreate");
  api.free = Need<cuMemFree_v2_t>("cuMemFree", "cuMemFree_v2");
  api.free_async = Need<cuMemFreeAsync_t>("cuMemFreeAsync", "cuMemFreeAsync");
  api.release = Need<cuMemRelease_t>("cuMemRelease", "cuMemRelease");
  api.mem_info = Need<cuMemGetInfo_v2_t>("cuMemGetInfo", "cuMemGetInfo_v2");
  return api;
}

CUfunction Kernel() { return reinterpret_cast<CUfunction>(g_opt.kernel); }

CUresult LaunchUs(const Api& api, unsigned int us, CUstream stream) {
  return api.launch(Kernel(), us, 1, 1, 128, 1, 1, 0, stream, nullptr,
                    nullptr);
}

void Burst(const Api& api, const std::vector<CUstream>& streams, int index) {
  for (int i = 0; i < g_opt.burst; i++) {
    CUresult rc = LaunchUs(api, g_opt.kernel_us, streams[i % streams.size()]);
    if (rc != CUDA_SUCCESS) {
      std::printf("launch_failed rc=%d\n", rc);
      return;
    }
  }
  std::printf("burst %d done\n", index);
  std::fflush(stdout);
}

CUgraphExec MakeGraph(const Api& api, CUstream stream, unsigned int us) {
  CUresult rc = api.begin_capture(stream, CU_STREAM_CAPTURE_MODE_GLOBAL);
  if (rc != CUDA_SUCCESS) Die("graph capture did not begin");
  LaunchUs(api, us, stream);
  CUgraph graph = nullptr;
  if (api.end_capture(stream, &graph) != CUDA_SUCCESS) Die("graph capture");
  CUgraphExec exec = nullptr;
  if (api.instantiate(&exec, graph, 0) != CUDA_SUCCESS) Die("instantiate");
  return exec;
}

void Lookups() {
  void* fn = nullptr;
  CUdriverProcAddressQueryResult status = CU_GET_PROC_ADDRESS_SUCCESS;
  auto* fake_symbol =
      reinterpret_cast<FakeSymbolFn*>(dlsym(g_lib, "fake_symbol"));
  // "cuMemAlloc" below 3020 is the 32-bit v1, which passes through
  g_gpa("cuMemAlloc", &fn, 3010, 0, &status);
  bool v1_passed = fn == fake_symbol("cuMemAlloc");
  unsigned int small = 0;
  CUresult rc = reinterpret_cast<V1AllocFn*>(fn)(&small, 4096);
  std::printf("lookup cuMemAlloc@3010 passed=%d alloc_rc=%d\n", v1_passed, rc);
  if (rc == CUDA_SUCCESS) {
    typedef CUresult V1FreeFn(unsigned int);
    void* free_fn = nullptr;
    g_gpa("cuMemFree", &free_fn, 3010, 0, &status);
    reinterpret_cast<V1FreeFn*>(free_fn)(small);
  }
  g_gpa("cuMemAlloc", &fn, g_opt.version, 0, &status);
  std::printf("lookup cuMemAlloc@%d hooked=%d\n", g_opt.version,
              fn != nullptr && fn != fake_symbol("cuMemAlloc_v2"));
  g_gpa("cuLaunchKernel", &fn, g_opt.version,
        CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM, &status);
  std::printf("lookup cuLaunchKernel ptsz hooked=%d\n",
              fn != nullptr && fn != fake_symbol("cuLaunchKernel_ptsz"));
  if (fn != nullptr) {
    rc = reinterpret_cast<cuLaunchKernel_t*>(fn)(Kernel(), 10, 1, 1, 1, 1, 1,
                                                 0, nullptr, nullptr, nullptr);
    std::printf("lookup ptsz launch rc=%d\n", rc);
  }
  fn = nullptr;
  rc = g_gpa("cuDriverGetVersion", &fn, g_opt.version, 0, &status);
  std::printf("lookup cuDriverGetVersion rc=%d status=%d passed=%d\n", rc,
              status, fn == fake_symbol("cuDriverGetVersion"));
  fn = nullptr;
  rc = g_gpa("cuNoSuchEntryPoint", &fn, g_opt.version, 0, &status);
  std::printf("lookup cuNoSuchEntryPoint rc=%d status=%d null=%d\n", rc,
              status, fn == nullptr);
  fn = nullptr;
  rc = g_gpa("cuMemAllocAsync", &fn, 11000, 0, &status);
  std::printf("lookup cuMemAllocAsync@11000 rc=%d status=%d\n", rc, status);
  auto* gpa1 =
      reinterpret_cast<cuGetProcAddress_t*>(dlsym(g_lib, "cuGetProcAddress"));
  std::printf("lookup cuGetProcAddress(4) hooked=%d\n",
              gpa1 != nullptr && reinterpret_cast<void*>(gpa1) !=
                                     fake_symbol("cuGetProcAddress"));
  fn = nullptr;
  if (gpa1 != nullptr) gpa1("cuGraphLaunch", &fn, g_opt.version, 0);
  std::printf("lookup cuGraphLaunch via cuGetProcAddress(4) hooked=%d\n",
              fn != nullptr && fn != fake_symbol("cuGraphLaunch"));
  fn = nullptr;
  g_gpa("cuGetProcAddress", &fn, g_opt.version, 0, &status);
  std::printf("lookup cuGetProcAddress@%d hooked=%d\n", g_opt.version,
              fn != nullptr && fn != fake_symbol("cuGetProcAddress_v2"));
}

void Sleep(int ms) {
  std::this_thread::sleep_for(std::chrono::milliseconds(ms));
}

// "<label> <the hook's counters>", when the hook is loaded
void PrintHookStats(const char* label) {
  auto* stats = reinterpret_cast<long (*)(char*, long)>(
      dlsym(RTLD_DEFAULT, "cudahook_stats"));
  if (stats == nullptr) return;
  std::vector<char> buf(static_cast<size_t>(stats(nullptr, 0)) + 1);
  stats(buf.data(), static_cast<long>(buf.size()));
  std::printf("%s %s\n", label, buf.data());
}

}  // namespace

int main(int argc, char** argv) {
  Options& o = g_opt;
  for (int i = 1; i < argc; i++) {
    std::string flag = argv[i];
    auto next = [&]() -> const char* {
      if (i + 1 >= argc) Die(("missing value for " + flag).c_str());
      return argv[++i];
    };
    if (flag == "--path") o.path = next();
    else if (flag == "--ptsz") o.ptsz = true;
    else if (flag == "--kernel") o.kernel = std::atol(next());
    else if (flag == "--graphs") o.graphs = std::atoi(next());
    else if (flag == "--graph-us") o.graph_us = std::atoi(next());
    else if (flag == "--graph-gap-ms") o.graph_gap_ms = std::atoi(next());
    else if (flag == "--bursts") o.bursts = std::atoi(next());
    else if (flag == "--burst") o.burst = std::atoi(next());
    else if (flag == "--kernel-us") o.kernel_us = std::atoi(next());
    else if (flag == "--streams") o.streams = std::atoi(next());
    else if (flag == "--gap-ms") o.gap_ms = std::atoi(next());
    else if (flag == "--alloc") o.alloc = std::atoll(next());
    else if (flag == "--alloc-over") o.alloc_over = std::atoll(next());
    else if (flag == "--keep") o.keep = true;
    else if (flag == "--pitch") {
      o.pitch_w = std::atoll(next());
      o.pitch_h = std::atoll(next());
    } else if (flag == "--managed") o.managed = std::atoll(next());
    else if (flag == "--async") o.async = std::atoll(next());
    else if (flag == "--pool-async") o.pool_async = std::atoll(next());
    else if (flag == "--vmm") o.vmm = std::atoll(next());
    else if (flag == "--mem-info") o.mem_info = true;
    else if (flag == "--lookups") o.lookups = true;
    else if (flag == "--capture") o.capture = true;
    else if (flag == "--capture-ms") o.capture_ms = std::atoi(next());
    else if (flag == "--unsafe-in-capture") o.unsafe = true;
    else if (flag == "--destroy-stream") o.destroy_streams = true;
    else if (flag == "--exclusive-mix") o.exclusive_mix = true;
    else if (flag == "--reuse-graph") o.reuse_graph = true;
    else if (flag == "--reuse-us") o.reuse_us = std::atoi(next());
    else if (flag == "--destroy-in-flight") o.destroy_in_flight = true;
    else if (flag == "--pause-ms") o.pause_ms = std::atoi(next());
    else if (flag == "--no-sync") o.sync = false;
    else if (flag == "--sleep-ms") o.sleep_ms = std::atoi(next());
    else Die(("unknown flag " + flag).c_str());
  }

  Api api = Load();
  api.init(0);
  CUcontext ctx = nullptr;
  api.retain(&ctx, 0);
  api.set_ctx(ctx);
  std::vector<CUstream> streams(std::max(1, o.streams));
  for (CUstream& s : streams) api.stream_create(&s, 0);
  CUstream graph_stream = nullptr;
  api.stream_create(&graph_stream, 0);

  if (o.lookups) Lookups();

  for (int b = 0; b < o.bursts; b++) {
    if (b > 0 && o.gap_ms > 0) Sleep(o.gap_ms);
    Burst(api, streams, b);
  }

  if (o.graphs > 0) {
    CUgraphExec exec = MakeGraph(api, graph_stream, o.graph_us);
    for (int i = 0; i < o.graphs; i++) {
      CUresult rc = api.graph_launch(exec, graph_stream);
      if (rc != CUDA_SUCCESS) std::printf("graph_failed rc=%d\n", rc);
      if (o.graph_gap_ms >= 0) {
        api.ctx_sync();
        Sleep(o.graph_gap_ms);
      }
    }
    std::printf("graphs %d launched\n", o.graphs);
  }

  if (o.exclusive_mix) {
    CUgraphExec exec = MakeGraph(api, graph_stream, o.graph_us);
    // each graph launch finds the burst's lease expired: the lease goes
    // back and the graph waits for its grant; the next burst waits for
    // the graph's
    for (int round = 0; round < 4; round++) {
      Burst(api, streams, round);
      Sleep(o.gap_ms);
      api.graph_launch(exec, graph_stream);
    }
    std::printf("mix done\n");
  }

  if (o.reuse_graph) {
    CUgraphExec short_graph = MakeGraph(api, graph_stream, o.graph_us);
    for (int i = 0; i < 3; i++) {
      api.graph_launch(short_graph, graph_stream);
      api.ctx_sync();
      Sleep(50);  // its charge released: the next launch knows its class
    }
    Sleep(400);  // the lease it rode goes back for idleness
    api.graph_destroy(short_graph);
    CUgraphExec long_graph = MakeGraph(api, graph_stream, o.reuse_us);
    std::printf("graph_reused=%d\n", long_graph == short_graph);
    PrintHookStats("reuse before");
    api.graph_launch(long_graph, graph_stream);
    api.ctx_sync();
    Sleep(50);
    PrintHookStats("reuse after");
  }

  if (o.destroy_in_flight) {
    CUgraphExec exec = MakeGraph(api, graph_stream, o.graph_us);
    api.graph_launch(exec, graph_stream);
    api.graph_destroy(exec);  // the launch's marker has not fired yet
    api.ctx_sync();
    Sleep(100);
    PrintHookStats("in_flight after");
  }

  if (o.capture) {
    CUstream capture_stream = nullptr;
    api.stream_create(&capture_stream, 0);
    LaunchUs(api, 100, streams[0]);  // a lease is held when it begins
    CUresult rc = api.begin_capture(capture_stream,
                                    CU_STREAM_CAPTURE_MODE_GLOBAL);
    if (rc != CUDA_SUCCESS) Die("capture did not begin");
    for (int i = 0; i < 3; i++) LaunchUs(api, 100, capture_stream);
    Sleep(o.capture_ms / 2);
    for (int i = 0; i < 3; i++) LaunchUs(api, 100, streams[0]);  // eager
    if (o.unsafe) api.stream_sync(streams[0]);
    Sleep(o.capture_ms / 2);
    CUgraph graph = nullptr;
    rc = api.end_capture(capture_stream, &graph);
    if (rc == CUDA_SUCCESS) {
      CUgraphExec exec = nullptr;
      api.instantiate(&exec, graph, 0);
      api.graph_launch(exec, capture_stream);
      std::printf("capture_ok\n");
    } else {
      std::printf("capture_failed rc=%d\n", rc);
    }
  }

  if (o.destroy_streams) {
    for (CUstream s : streams) api.stream_destroy(s);
    streams.clear();
    std::printf("streams destroyed\n");
  }

  if (o.alloc > 0) {
    CUdeviceptr ptr = 0;
    CUresult rc = api.alloc(&ptr, static_cast<size_t>(o.alloc));
    if (rc == CUDA_SUCCESS) {
      std::printf("alloc_ok\n");
    } else {
      std::printf("alloc_denied rc=%d\n", rc);
    }
    if (o.alloc_over > 0) {
      CUdeviceptr over = 0;
      CUresult rc2 = api.alloc(&over, static_cast<size_t>(o.alloc_over));
      if (rc2 == CUDA_SUCCESS) {
        std::printf("alloc_over_ok\n");
        api.free(over);
      } else {
        std::printf("alloc_over_denied rc=%d\n", rc2);
      }
    }
    if (rc == CUDA_SUCCESS && !o.keep) {
      api.free(ptr);
      std::printf("freed\n");
    }
  }
  if (o.pitch_w > 0) {
    CUdeviceptr ptr = 0;
    size_t pitch = 0;
    CUresult rc = api.alloc_pitch(&ptr, &pitch, o.pitch_w, o.pitch_h, 4);
    if (rc == CUDA_SUCCESS) {
      std::printf("pitch_ok pitch=%zu\n", pitch);
      if (!o.keep) api.free(ptr);
    } else {
      std::printf("pitch_denied rc=%d\n", rc);
    }
  }
  if (o.managed > 0) {
    CUdeviceptr ptr = 0;
    CUresult rc = api.alloc_managed(&ptr, o.managed, 1);
    std::printf("managed rc=%d\n", rc);
    if (rc == CUDA_SUCCESS && !o.keep) api.free(ptr);
  }
  if (o.async > 0) {
    CUdeviceptr ptr = 0;
    CUresult rc = api.alloc_async(&ptr, o.async, streams.empty() ? nullptr
                                                               : streams[0]);
    std::printf("async rc=%d\n", rc);
    if (rc == CUDA_SUCCESS && !o.keep) {
      std::printf("async_free rc=%d\n", api.free_async(ptr, nullptr));
    }
  }
  if (o.pool_async > 0) {
    CUdeviceptr ptr = 0;
    CUresult rc = api.alloc_pool(&ptr, o.pool_async, nullptr, nullptr);
    std::printf("pool_async rc=%d\n", rc);
    if (rc == CUDA_SUCCESS && !o.keep) api.free_async(ptr, nullptr);
  }
  if (o.vmm > 0) {
    CUmemGenericAllocationHandle handle = 0;
    CUresult rc = api.create(&handle, o.vmm, nullptr, 0);
    std::printf("vmm rc=%d\n", rc);
    if (rc == CUDA_SUCCESS && !o.keep) {
      std::printf("vmm_release rc=%d\n", api.release(handle));
    }
  }
  if (o.mem_info) {
    size_t free = 0, total = 0;
    CUresult rc = api.mem_info(&free, &total);
    std::printf("mem_info rc=%d free=%zu total=%zu\n", rc, free, total);
  }

  if (o.sync) api.ctx_sync();
  if (o.pause_ms > 0) {
    std::printf("idle\n");
    std::fflush(stdout);
    Sleep(o.pause_ms);
  }
  if (o.sleep_ms > 0) Sleep(o.sleep_ms);

  auto* fake_stats = reinterpret_cast<const char* (*)()>(
      dlsym(g_lib, "fake_stats"));
  if (fake_stats != nullptr) std::printf("fake %s\n", fake_stats());
  auto* settle = reinterpret_cast<int (*)(double)>(
      dlsym(RTLD_DEFAULT, "cudahook_settle"));
  auto* stats = reinterpret_cast<long (*)(char*, long)>(
      dlsym(RTLD_DEFAULT, "cudahook_stats"));
  if (settle != nullptr && stats != nullptr && std::getenv("HOOK_DRIVER_SETTLE")) {
    settle(2000.0);
  }
  if (stats != nullptr) PrintHookStats("hook");
  std::fflush(stdout);
  return 0;
}
