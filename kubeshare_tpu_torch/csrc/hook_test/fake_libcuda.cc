// A stand-in libcuda.so.1 for the CPU tests of libcudahook.so.1 (the CUDA
// counterpart of native/test/fake_pjrt_plugin.cc).  Built by
// tests/test_torch_cuda_hook.py into a temporary directory as libcuda.so.1
// (soname libcuda.so.1, linked -Bsymbolic so that its own references bind
// to its own definitions, as the real driver's do).
//
// It implements the entry points the hook wraps and those a program
// needs around them:
//  * cuGetProcAddress / _v2 with version mapping ("cuMemAlloc" at 3010 is
//    the 32-bit v1, at 3020 and later cuMemAlloc_v2) and the per-thread
//    flag (the _ptsz forms); an unknown name is SYMBOL_NOT_FOUND, a
//    version too low VERSION_NOT_SUFFICIENT.  FAKE_PROC_INTERNAL=1 returns
//    internal pointers instead of the exported ones, as a driver may.
//  * A device clock: one worker thread runs the work of every stream in
//    submission order.  A kernel "runs" gridDimX microseconds; a graph
//    runs the sum of the kernels captured into it; host functions run on
//    the worker, in order, as the driver's callback thread runs them.
//  * Stream capture.  While a capture in global mode is live, any
//    capture-unsafe call from any thread (stream or context synchronize,
//    stream or event query, event synchronize, and host functions, which
//    the hook must never enqueue then) fails with
//    CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED and invalidates the capture;
//    its cuStreamEndCapture then fails with ..._INVALIDATED, as PyTorch
//    sees it under the real driver.
//  * Graphs: cuGraphExecDestroy keeps the exec's memory and hands its
//    address to the next cuGraphInstantiateWithFlags, as a driver may
//    reuse a freed address.
//  * Contexts: stream work needs a current context on the calling thread
//    (cuDevicePrimaryCtxRetain + cuCtxSetCurrent), as with the real
//    driver's legacy stream.
//  * Memory of 2,000,000 bytes: allocations, frees, VMM handles,
//    cuMemGetInfo.  FAKE_FAIL_ALLOC=1 fails every allocation
//    with CUDA_ERROR_OUT_OF_MEMORY (the hook's rollback path).
//  * Names: a CUfunction below 0x10000 is "kernel_<n>" to cuFuncGetName;
//    one above is a CUkernel that only cuKernelGetName names
//    ("library_kernel_<n>").
//  * fake_stats() reports what it saw; fake_symbol(name) returns its own
//    definition of a name, bypassing any dlsym interposer.

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
#include <unordered_map>
#include <unordered_set>

#include "../cuda_driver_api.h"

using namespace cudahook;

namespace {

struct Op {
  long long us = 0;          // device time
  CUhostFn fn = nullptr;     // or a host function
  void* data = nullptr;
};

struct Capture {
  CUstreamCaptureMode mode;
  long long us = 0;
  bool invalidated = false;
};

struct Graph {
  long long us;
};

struct Fake {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Op> queue;
  long long submitted = 0, completed = 0;
  bool worker = false;

  std::unordered_map<CUstream, Capture> captures;
  int global_captures = 0;
  std::unordered_set<CUstream> streams;
  std::uintptr_t next_handle = 0x100000;
  std::deque<Graph*> freed_execs;  // destroyed, handed out again first

  long long total = 2000000, used = 0;
  std::unordered_map<CUdeviceptr, long long> allocs;
  std::unordered_map<CUmemGenericAllocationHandle, long long> vmm;
  std::map<std::string, long long> counts;  // calls by name
  long long unsafe = 0, host_fns = 0;
};

Fake& F() {
  static Fake* fake = new Fake;  // leaked: the worker runs until exit
  return *fake;
}

thread_local CUcontext t_ctx = nullptr;
const CUcontext kPrimary = reinterpret_cast<CUcontext>(0xc0);

void Count(Fake& f, const char* name) { f.counts[name]++; }

void Worker() {
  Fake& f = F();
  while (true) {
    Op op;
    {
      std::unique_lock<std::mutex> lock(f.mu);
      f.cv.wait(lock, [&f] { return !f.queue.empty(); });
      op = f.queue.front();
      f.queue.pop_front();
    }
    if (op.us > 0) std::this_thread::sleep_for(std::chrono::microseconds(op.us));
    if (op.fn != nullptr) op.fn(op.data);
    std::lock_guard<std::mutex> lock(f.mu);
    f.completed++;
    f.cv.notify_all();
  }
}

void SubmitLocked(Fake& f, Op op) {
  if (!f.worker) {
    f.worker = true;
    std::thread(Worker).detach();
  }
  f.queue.push_back(op);
  f.submitted++;
  f.cv.notify_all();
}

// A call the real driver prohibits while a global-mode capture is live.
bool UnsafeLocked(Fake& f, const char* name) {
  if (f.global_captures == 0) return false;
  f.unsafe++;
  Count(f, (std::string("unsafe:") + name).c_str());
  for (auto& kv : f.captures) {
    if (kv.second.mode == CU_STREAM_CAPTURE_MODE_GLOBAL) {
      kv.second.invalidated = true;
    }
  }
  return true;
}

bool Legacy(CUstream s) {
  return s == nullptr || s == StreamLegacy() || s == StreamPerThread();
}

CUresult Launch(const char* name, unsigned int grid_x, CUstream stream) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  auto it = f.captures.find(stream);
  if (it != f.captures.end()) {
    it->second.us += grid_x;  // recorded, not run
    return CUDA_SUCCESS;
  }
  Op op;
  op.us = grid_x;
  SubmitLocked(f, op);
  return CUDA_SUCCESS;
}

CUresult WaitAll(const char* name, bool query) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  Fake& f = F();
  std::unique_lock<std::mutex> lock(f.mu);
  Count(f, name);
  if (UnsafeLocked(f, name)) return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  long long target = f.submitted;
  if (query) return f.completed >= target ? CUDA_SUCCESS : CUDA_ERROR_NOT_READY;
  f.cv.wait(lock, [&f, target] { return f.completed >= target; });
  return CUDA_SUCCESS;
}

CUresult Alloc(const char* name, CUdeviceptr* dptr, long long bytes) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  const char* fail = std::getenv("FAKE_FAIL_ALLOC");
  if ((fail != nullptr && *fail == '1') || f.used + bytes > f.total) {
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  f.next_handle += 0x1000;
  *dptr = static_cast<CUdeviceptr>(f.next_handle);
  f.allocs[*dptr] = bytes;
  f.used += bytes;
  return CUDA_SUCCESS;
}

CUresult Free(const char* name, CUdeviceptr dptr) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  auto it = f.allocs.find(dptr);
  if (it == f.allocs.end()) return CUDA_ERROR_INVALID_VALUE;
  f.used -= it->second;
  f.allocs.erase(it);
  return CUDA_SUCCESS;
}

CUresult BeginCapture(const char* name, CUstream stream,
                      CUstreamCaptureMode mode) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  if (Legacy(stream)) return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  if (f.captures.count(stream) != 0) return CUDA_ERROR_INVALID_VALUE;
  f.captures[stream] = Capture{mode};
  if (mode == CU_STREAM_CAPTURE_MODE_GLOBAL) f.global_captures++;
  return CUDA_SUCCESS;
}

CUresult EndCapture(const char* name, CUstream stream, CUgraph* graph) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  auto it = f.captures.find(stream);
  if (it == f.captures.end()) return CUDA_ERROR_INVALID_VALUE;
  Capture capture = it->second;
  f.captures.erase(it);
  if (capture.mode == CU_STREAM_CAPTURE_MODE_GLOBAL) f.global_captures--;
  if (capture.invalidated) {
    *graph = nullptr;
    return CUDA_ERROR_STREAM_CAPTURE_INVALIDATED;
  }
  *graph = reinterpret_cast<CUgraph>(new Graph{capture.us});
  return CUDA_SUCCESS;
}

CUresult GraphLaunch(const char* name, CUgraphExec exec, CUstream stream) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  if (exec == nullptr) return CUDA_ERROR_INVALID_VALUE;
  return Launch(name,
                static_cast<unsigned int>(reinterpret_cast<Graph*>(exec)->us),
                stream);
}

CUresult HostFunc(const char* name, CUstream, CUhostFn fn, void* data) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, name);
  if (UnsafeLocked(f, name)) return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  f.host_fns++;
  Op op;
  op.fn = fn;
  op.data = data;
  SubmitLocked(f, op);
  return CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// ---- resolution ------------------------------------------------------------

CUresult cuInit(unsigned int) { return CUDA_SUCCESS; }

CUresult cuDriverGetVersion(int* version) {
  *version = 12080;
  return CUDA_SUCCESS;
}

CUresult cuDevicePrimaryCtxRetain(CUcontext* ctx, int) {
  *ctx = kPrimary;
  return CUDA_SUCCESS;
}

CUresult cuCtxSetCurrent(CUcontext ctx) {
  t_ctx = ctx;
  return CUDA_SUCCESS;
}

CUresult cuCtxGetCurrent(CUcontext* ctx) {
  *ctx = t_ctx;
  return CUDA_SUCCESS;
}

CUresult cuCtxSynchronize(void) { return WaitAll("cuCtxSynchronize", false); }

// ---- streams, events, capture, graphs ---------------------------------------

CUresult cuStreamCreate(CUstream* stream, unsigned int) {
  if (t_ctx == nullptr) return CUDA_ERROR_INVALID_CONTEXT;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  f.next_handle += 0x10;
  *stream = reinterpret_cast<CUstream>(f.next_handle);
  f.streams.insert(*stream);
  return CUDA_SUCCESS;
}

CUresult cuStreamDestroy_v2(CUstream stream) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, "cuStreamDestroy_v2");
  return f.streams.erase(stream) > 0 ? CUDA_SUCCESS : CUDA_ERROR_INVALID_HANDLE;
}

CUresult cuStreamDestroy(CUstream stream) { return cuStreamDestroy_v2(stream); }

CUresult cuStreamSynchronize(CUstream) {
  return WaitAll("cuStreamSynchronize", false);
}

CUresult cuStreamSynchronize_ptsz(CUstream) {
  return WaitAll("cuStreamSynchronize_ptsz", false);
}

CUresult cuStreamQuery(CUstream) { return WaitAll("cuStreamQuery", true); }

// an event completes when everything submitted before its record has
typedef long long FakeEvent;

CUresult cuEventCreate(void** event, unsigned int) {
  *event = new FakeEvent(0);
  return CUDA_SUCCESS;
}

CUresult cuEventRecord(void* event, CUstream) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  *static_cast<FakeEvent*>(event) = f.submitted;
  return CUDA_SUCCESS;
}

CUresult cuEventQuery(void* event) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  if (UnsafeLocked(f, "cuEventQuery")) {
    return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  }
  return f.completed >= *static_cast<FakeEvent*>(event) ? CUDA_SUCCESS
                                                        : CUDA_ERROR_NOT_READY;
}

CUresult cuEventSynchronize(CUevent event_handle) {
  void* event = event_handle;
  Fake& f = F();
  std::unique_lock<std::mutex> lock(f.mu);
  if (UnsafeLocked(f, "cuEventSynchronize")) {
    return CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED;
  }
  long long target = *static_cast<FakeEvent*>(event);
  f.cv.wait(lock, [&f, target] { return f.completed >= target; });
  return CUDA_SUCCESS;
}

CUresult cuEventDestroy_v2(void* event) {
  delete static_cast<FakeEvent*>(event);
  return CUDA_SUCCESS;
}

CUresult cuStreamBeginCapture(CUstream stream) {
  return BeginCapture("cuStreamBeginCapture", stream,
                      CU_STREAM_CAPTURE_MODE_GLOBAL);
}
CUresult cuStreamBeginCapture_ptsz(CUstream stream) {
  return BeginCapture("cuStreamBeginCapture_ptsz", stream,
                      CU_STREAM_CAPTURE_MODE_GLOBAL);
}
CUresult cuStreamBeginCapture_v2(CUstream stream, CUstreamCaptureMode mode) {
  return BeginCapture("cuStreamBeginCapture_v2", stream, mode);
}
CUresult cuStreamBeginCapture_v2_ptsz(CUstream stream,
                                      CUstreamCaptureMode mode) {
  return BeginCapture("cuStreamBeginCapture_v2_ptsz", stream, mode);
}
CUresult cuStreamEndCapture(CUstream stream, CUgraph* graph) {
  return EndCapture("cuStreamEndCapture", stream, graph);
}
CUresult cuStreamEndCapture_ptsz(CUstream stream, CUgraph* graph) {
  return EndCapture("cuStreamEndCapture_ptsz", stream, graph);
}

CUresult cuGraphInstantiateWithFlags(CUgraphExec* exec, CUgraph graph,
                                     unsigned long long) {
  if (graph == nullptr) return CUDA_ERROR_INVALID_VALUE;
  long long us = reinterpret_cast<Graph*>(graph)->us;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Graph* made;
  if (!f.freed_execs.empty()) {
    made = f.freed_execs.front();
    f.freed_execs.pop_front();
    made->us = us;
  } else {
    made = new Graph{us};
  }
  *exec = reinterpret_cast<CUgraphExec>(made);
  return CUDA_SUCCESS;
}

CUresult cuGraphExecDestroy(CUgraphExec exec) {
  if (exec == nullptr) return CUDA_ERROR_INVALID_VALUE;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  Count(f, "cuGraphExecDestroy");
  // a launch already submitted ran its own copy of the duration
  f.freed_execs.push_back(reinterpret_cast<Graph*>(exec));
  return CUDA_SUCCESS;
}

CUresult cuGraphLaunch(CUgraphExec exec, CUstream stream) {
  return GraphLaunch("cuGraphLaunch", exec, stream);
}
CUresult cuGraphLaunch_ptsz(CUgraphExec exec, CUstream stream) {
  return GraphLaunch("cuGraphLaunch_ptsz", exec, stream);
}

CUresult cuLaunchHostFunc(CUstream stream, CUhostFn fn, void* data) {
  return HostFunc("cuLaunchHostFunc", stream, fn, data);
}
CUresult cuLaunchHostFunc_ptsz(CUstream stream, CUhostFn fn, void* data) {
  return HostFunc("cuLaunchHostFunc_ptsz", stream, fn, data);
}

// ---- launches ----------------------------------------------------------------

CUresult cuLaunchKernel(CUfunction, unsigned int gx, unsigned int,
                        unsigned int, unsigned int, unsigned int, unsigned int,
                        unsigned int, CUstream stream, void**, void**) {
  return Launch("cuLaunchKernel", gx, stream);
}
CUresult cuLaunchKernel_ptsz(CUfunction, unsigned int gx, unsigned int,
                             unsigned int, unsigned int, unsigned int,
                             unsigned int, unsigned int, CUstream stream,
                             void**, void**) {
  return Launch("cuLaunchKernel_ptsz", gx, stream);
}
CUresult cuLaunchKernelEx(const CUlaunchConfig* config, CUfunction, void**,
                          void**) {
  auto* layout = reinterpret_cast<const LaunchConfigLayout*>(config);
  return Launch("cuLaunchKernelEx", layout->gridDimX, layout->hStream);
}
CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config, CUfunction,
                               void**, void**) {
  auto* layout = reinterpret_cast<const LaunchConfigLayout*>(config);
  return Launch("cuLaunchKernelEx_ptsz", layout->gridDimX, layout->hStream);
}
CUresult cuLaunchCooperativeKernel(CUfunction, unsigned int gx, unsigned int,
                                   unsigned int, unsigned int, unsigned int,
                                   unsigned int, unsigned int, CUstream stream,
                                   void**) {
  return Launch("cuLaunchCooperativeKernel", gx, stream);
}

CUresult cuFuncGetName(const char** name, CUfunction f) {
  static std::mutex mu;
  static auto* names = new std::unordered_map<CUfunction, std::string>;
  auto value = reinterpret_cast<std::uintptr_t>(f);
  if (value >= 0x10000) return CUDA_ERROR_INVALID_HANDLE;
  std::lock_guard<std::mutex> lock(mu);
  std::string& entry = (*names)[f];
  if (entry.empty()) entry = "kernel_" + std::to_string(value);
  *name = entry.c_str();
  return CUDA_SUCCESS;
}

CUresult cuKernelGetName(const char** name, CUkernel k) {
  static std::mutex mu;
  static auto* names = new std::unordered_map<CUkernel, std::string>;
  auto value = reinterpret_cast<std::uintptr_t>(k);
  if (value < 0x10000) return CUDA_ERROR_INVALID_HANDLE;
  std::lock_guard<std::mutex> lock(mu);
  std::string& entry = (*names)[k];
  if (entry.empty()) entry = "library_kernel_" + std::to_string(value);
  *name = entry.c_str();
  return CUDA_SUCCESS;
}

// ---- memory ------------------------------------------------------------------

// the 32-bit v1 entry points (what "cuMemAlloc" means below cudaVersion 3020)
CUresult cuMemAlloc(unsigned int* dptr, unsigned int bytes) {
  CUdeviceptr wide = 0;
  CUresult rc = Alloc("cuMemAlloc", &wide, bytes);
  if (rc == CUDA_SUCCESS) *dptr = static_cast<unsigned int>(wide);
  return rc;
}
CUresult cuMemFree(unsigned int dptr) { return Free("cuMemFree", dptr); }

CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  return Alloc("cuMemAlloc_v2", dptr, static_cast<long long>(bytes));
}
CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int) {
  *pitch = (width + 511) / 512 * 512;
  return Alloc("cuMemAllocPitch_v2", dptr,
               static_cast<long long>(*pitch * height));
}
CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes, unsigned int) {
  return Alloc("cuMemAllocManaged", dptr, static_cast<long long>(bytes));
}
CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream) {
  return Alloc("cuMemAllocAsync", dptr, static_cast<long long>(bytes));
}
CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes, CUstream) {
  return Alloc("cuMemAllocAsync_ptsz", dptr, static_cast<long long>(bytes));
}
CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes, CUmemoryPool,
                                 CUstream) {
  return Alloc("cuMemAllocFromPoolAsync", dptr, static_cast<long long>(bytes));
}
CUresult cuMemFree_v2(CUdeviceptr dptr) { return Free("cuMemFree_v2", dptr); }
CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream) {
  return Free("cuMemFreeAsync", dptr);
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t size,
                     const CUmemAllocationProp*, unsigned long long) {
  CUdeviceptr address = 0;
  CUresult rc = Alloc("cuMemCreate", &address, static_cast<long long>(size));
  if (rc != CUDA_SUCCESS) return rc;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  *handle = address;  // the handle names the backing allocation
  f.vmm[*handle] = static_cast<long long>(size);
  return CUDA_SUCCESS;
}
CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  {
    Fake& f = F();
    std::lock_guard<std::mutex> lock(f.mu);
    if (f.vmm.erase(handle) == 0) return CUDA_ERROR_INVALID_VALUE;
  }
  return Free("cuMemRelease", handle);
}

CUresult cuMemGetInfo_v2(size_t* free, size_t* total) {
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  *total = static_cast<size_t>(f.total);
  *free = static_cast<size_t>(f.total - f.used);
  return CUDA_SUCCESS;
}

// ---- cuGetProcAddress --------------------------------------------------------

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags);
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status);

struct ProcEntry {
  const char* base;
  int since;
  bool ptsz;
  const char* variant;
  void* fn;
};

#define PROC(base, since, ptsz, fn) \
  {#base, since, ptsz, #fn, reinterpret_cast<void*>(&fn)}
const ProcEntry kProcs[] = {
    PROC(cuInit, 2000, false, cuInit),
    PROC(cuDriverGetVersion, 2020, false, cuDriverGetVersion),
    PROC(cuDevicePrimaryCtxRetain, 7000, false, cuDevicePrimaryCtxRetain),
    PROC(cuCtxSetCurrent, 4000, false, cuCtxSetCurrent),
    PROC(cuCtxGetCurrent, 4000, false, cuCtxGetCurrent),
    PROC(cuCtxSynchronize, 2000, false, cuCtxSynchronize),
    PROC(cuStreamCreate, 2000, false, cuStreamCreate),
    PROC(cuStreamDestroy, 2000, false, cuStreamDestroy),
    PROC(cuStreamDestroy, 4000, false, cuStreamDestroy_v2),
    PROC(cuStreamSynchronize, 2000, false, cuStreamSynchronize),
    PROC(cuStreamSynchronize, 7000, true, cuStreamSynchronize_ptsz),
    PROC(cuStreamQuery, 2000, false, cuStreamQuery),
    PROC(cuEventCreate, 2000, false, cuEventCreate),
    PROC(cuEventRecord, 2000, false, cuEventRecord),
    PROC(cuEventQuery, 2000, false, cuEventQuery),
    PROC(cuEventSynchronize, 2000, false, cuEventSynchronize),
    PROC(cuEventDestroy, 4000, false, cuEventDestroy_v2),
    PROC(cuStreamBeginCapture, 10000, false, cuStreamBeginCapture),
    PROC(cuStreamBeginCapture, 10000, true, cuStreamBeginCapture_ptsz),
    PROC(cuStreamBeginCapture, 10010, false, cuStreamBeginCapture_v2),
    PROC(cuStreamBeginCapture, 10010, true, cuStreamBeginCapture_v2_ptsz),
    PROC(cuStreamEndCapture, 10000, false, cuStreamEndCapture),
    PROC(cuStreamEndCapture, 10000, true, cuStreamEndCapture_ptsz),
    PROC(cuGraphInstantiateWithFlags, 11040, false,
         cuGraphInstantiateWithFlags),
    PROC(cuGraphExecDestroy, 10000, false, cuGraphExecDestroy),
    PROC(cuGraphLaunch, 10000, false, cuGraphLaunch),
    PROC(cuGraphLaunch, 10000, true, cuGraphLaunch_ptsz),
    PROC(cuLaunchHostFunc, 10000, false, cuLaunchHostFunc),
    PROC(cuLaunchHostFunc, 10000, true, cuLaunchHostFunc_ptsz),
    PROC(cuLaunchKernel, 4000, false, cuLaunchKernel),
    PROC(cuLaunchKernel, 7000, true, cuLaunchKernel_ptsz),
    PROC(cuLaunchKernelEx, 11060, false, cuLaunchKernelEx),
    PROC(cuLaunchKernelEx, 11060, true, cuLaunchKernelEx_ptsz),
    PROC(cuLaunchCooperativeKernel, 9000, false, cuLaunchCooperativeKernel),
    PROC(cuFuncGetName, 12030, false, cuFuncGetName),
    PROC(cuKernelGetName, 12030, false, cuKernelGetName),
    PROC(cuMemAlloc, 2000, false, cuMemAlloc),
    PROC(cuMemAlloc, 3020, false, cuMemAlloc_v2),
    PROC(cuMemFree, 2000, false, cuMemFree),
    PROC(cuMemFree, 3020, false, cuMemFree_v2),
    PROC(cuMemAllocPitch, 3020, false, cuMemAllocPitch_v2),
    PROC(cuMemAllocManaged, 6000, false, cuMemAllocManaged),
    PROC(cuMemAllocAsync, 11020, false, cuMemAllocAsync),
    PROC(cuMemAllocAsync, 11020, true, cuMemAllocAsync_ptsz),
    PROC(cuMemAllocFromPoolAsync, 11020, false, cuMemAllocFromPoolAsync),
    PROC(cuMemFreeAsync, 11020, false, cuMemFreeAsync),
    PROC(cuMemCreate, 10020, false, cuMemCreate),
    PROC(cuMemRelease, 10020, false, cuMemRelease),
    PROC(cuMemGetInfo, 3020, false, cuMemGetInfo_v2),
    PROC(cuGetProcAddress, 11030, false, cuGetProcAddress),
    PROC(cuGetProcAddress, 12000, false, cuGetProcAddress_v2),
};
#undef PROC

// An internal alias of every launch and allocation entry, for
// FAKE_PROC_INTERNAL=1: a driver whose cuGetProcAddress returns pointers
// that are not its exported symbols.
CUresult InternalMemAlloc(CUdeviceptr* dptr, size_t bytes) {
  return Alloc("cuMemAlloc_v2", dptr, static_cast<long long>(bytes));
}
CUresult InternalLaunchKernel(CUfunction f, unsigned int gx, unsigned int gy,
                              unsigned int gz, unsigned int bx,
                              unsigned int by, unsigned int bz,
                              unsigned int shared, CUstream stream,
                              void** params, void** extra) {
  return cuLaunchKernel(f, gx, gy, gz, bx, by, bz, shared, stream, params,
                        extra);
}
CUresult InternalGraphLaunch(CUgraphExec exec, CUstream stream) {
  return GraphLaunch("cuGraphLaunch", exec, stream);
}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  {
    Fake& f = F();
    std::lock_guard<std::mutex> lock(f.mu);
    Count(f, "cuGetProcAddress");
  }
  bool ptsz = (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) != 0;
  const ProcEntry* best = nullptr;
  bool known = false;
  for (const ProcEntry& e : kProcs) {
    if (std::strcmp(e.base, symbol) != 0) continue;
    known = true;
    if (e.since > version) continue;
    // the per-thread form where there is one, else the plain one
    if (e.ptsz != ptsz && !(ptsz && !e.ptsz)) continue;
    if (best == nullptr || e.ptsz > best->ptsz ||
        (e.ptsz == best->ptsz && e.since > best->since)) {
      best = &e;
    }
  }
  *pfn = nullptr;
  if (best == nullptr) {
    if (status != nullptr) {
      *status = known ? CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT
                      : CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
    }
    return CUDA_ERROR_NOT_FOUND;
  }
  *pfn = best->fn;
  const char* internal = std::getenv("FAKE_PROC_INTERNAL");
  if (internal != nullptr && *internal == '1') {
    if (std::strcmp(best->variant, "cuMemAlloc_v2") == 0) {
      *pfn = reinterpret_cast<void*>(&InternalMemAlloc);
    } else if (std::strcmp(best->variant, "cuLaunchKernel") == 0) {
      *pfn = reinterpret_cast<void*>(&InternalLaunchKernel);
    } else if (std::strcmp(best->variant, "cuGraphLaunch") == 0) {
      *pfn = reinterpret_cast<void*>(&InternalGraphLaunch);
    }
  }
  if (status != nullptr) *status = CU_GET_PROC_ADDRESS_SUCCESS;
  return CUDA_SUCCESS;
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

// ---- test helpers --------------------------------------------------------------

// This library's own definition of `name` (no dlsym: an interposer cannot
// rewrite it), or null.
void* fake_symbol(const char* name) {
  for (const ProcEntry& e : kProcs) {
    if (std::strcmp(e.variant, name) == 0) return e.fn;
  }
  return nullptr;
}

// "key=value ..." of what the fake saw; valid until the next call.
const char* fake_stats(void) {
  static std::string out;
  Fake& f = F();
  std::lock_guard<std::mutex> lock(f.mu);
  out = "used=" + std::to_string(f.used) + " allocs=" +
        std::to_string(f.allocs.size()) + " unsafe=" + std::to_string(f.unsafe) +
        " host_fns=" + std::to_string(f.host_fns);
  for (const auto& kv : f.counts) {
    out += " " + kv.first + "=" + std::to_string(kv.second);
  }
  return out.c_str();
}

}  // extern "C"
