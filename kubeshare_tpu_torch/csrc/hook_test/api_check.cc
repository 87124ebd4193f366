// Holds the in-tree driver API (cuda_driver_api.h) against the CUDA
// toolkit's own cuda.h and cudaTypedefs.h: one static_assert per function
// type, per enum value, per handle type and per struct offset, so that a
// wrong declaration fails this build.  chip_smoke.py builds and runs it
// on the machine with the card:
//
//   g++ -std=c++17 -I/usr/local/cuda/include api_check.cc -o api_check
//
// The function types are compared after mapping the three enums of ours
// onto cuda.h's (every other type is the same C++ type by construction:
// the handles name cuda.h's struct tags).  The _ptsz forms share their
// base's type, so they are checked through it.  Not held here: CUDA
// 10.0's one-argument cuStreamBeginCapture, which neither cuda.h nor
// cudaTypedefs.h of CUDA 12 declares any more (the driver still exports
// it, and the runtime still resolves it).

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstddef>
#include <cstdio>
#include <type_traits>

#include "../cuda_driver_api.h"

namespace {

// the toolkit's type for each of ours
template <typename T>
struct Theirs {
  using type = T;
};
template <>
struct Theirs<cudahook::CUresult> {
  using type = ::CUresult;
};
template <>
struct Theirs<cudahook::CUdriverProcAddressQueryResult> {
  using type = ::CUdriverProcAddressQueryResult;
};
template <>
struct Theirs<cudahook::CUstreamCaptureMode> {
  using type = ::CUstreamCaptureMode;
};
template <typename T>
struct Theirs<T*> {
  using type = typename Theirs<T>::type*;
};
template <typename T>
struct Theirs<const T> {
  using type = const typename Theirs<T>::type;
};
template <typename R, typename... A>
struct Theirs<R(A...)> {
  using type = typename Theirs<R>::type(typename Theirs<A>::type...);
};

template <typename P>
using Fn = typename std::remove_pointer<P>::type;

}  // namespace

#define SAME_FN(ours, theirs)                                                 \
  static_assert(std::is_same<Theirs<cudahook::ours>::type, theirs>::value,    \
                "cuda_driver_api.h: " #ours " differs from cuda.h")

SAME_FN(cuGetProcAddress_t, Fn<PFN_cuGetProcAddress_v11030>);
SAME_FN(cuGetProcAddress_v2_t, Fn<PFN_cuGetProcAddress_v12000>);
SAME_FN(cuLaunchKernel_t, decltype(::cuLaunchKernel));
SAME_FN(cuLaunchKernelEx_t, decltype(::cuLaunchKernelEx));
SAME_FN(cuLaunchCooperativeKernel_t, decltype(::cuLaunchCooperativeKernel));
SAME_FN(cuGraphLaunch_t, decltype(::cuGraphLaunch));
SAME_FN(cuStreamBeginCapture_v2_t, Fn<PFN_cuStreamBeginCapture_v10010>);
SAME_FN(cuStreamBeginCaptureToGraph_t,
        decltype(::cuStreamBeginCaptureToGraph));
SAME_FN(cuStreamEndCapture_t, decltype(::cuStreamEndCapture));
SAME_FN(cuStreamDestroy_t, decltype(::cuStreamDestroy_v2));
SAME_FN(cuGraphExecDestroy_t, decltype(::cuGraphExecDestroy));
SAME_FN(cuCtxSynchronize_t, decltype(::cuCtxSynchronize));
SAME_FN(cuStreamSynchronize_t, decltype(::cuStreamSynchronize));
SAME_FN(cuEventSynchronize_t, decltype(::cuEventSynchronize));
SAME_FN(cuMemAlloc_v2_t, decltype(::cuMemAlloc_v2));
SAME_FN(cuMemAllocPitch_v2_t, decltype(::cuMemAllocPitch_v2));
SAME_FN(cuMemAllocManaged_t, decltype(::cuMemAllocManaged));
SAME_FN(cuMemAllocAsync_t, decltype(::cuMemAllocAsync));
SAME_FN(cuMemAllocFromPoolAsync_t, decltype(::cuMemAllocFromPoolAsync));
SAME_FN(cuMemCreate_t, decltype(::cuMemCreate));
SAME_FN(cuMemFree_v2_t, decltype(::cuMemFree_v2));
SAME_FN(cuMemFreeAsync_t, decltype(::cuMemFreeAsync));
SAME_FN(cuMemRelease_t, decltype(::cuMemRelease));
SAME_FN(cuMemGetInfo_v2_t, decltype(::cuMemGetInfo_v2));
SAME_FN(cuLaunchHostFunc_t, decltype(::cuLaunchHostFunc));
SAME_FN(cuCtxGetCurrent_t, decltype(::cuCtxGetCurrent));
SAME_FN(cuCtxSetCurrent_t, decltype(::cuCtxSetCurrent));
SAME_FN(cuFuncGetName_t, decltype(::cuFuncGetName));
SAME_FN(cuKernelGetName_t, decltype(::cuKernelGetName));

#define SAME_TYPE(name)                                                      \
  static_assert(std::is_same<cudahook::name, ::name>::value,                 \
                "cuda_driver_api.h: " #name " differs from cuda.h")

SAME_TYPE(CUdeviceptr);
SAME_TYPE(CUmemGenericAllocationHandle);
SAME_TYPE(cuuint64_t);
SAME_TYPE(CUcontext);
SAME_TYPE(CUstream);
SAME_TYPE(CUevent);
SAME_TYPE(CUfunction);
SAME_TYPE(CUkernel);
SAME_TYPE(CUgraph);
SAME_TYPE(CUgraphExec);
SAME_TYPE(CUgraphNode);
SAME_TYPE(CUmemoryPool);
SAME_TYPE(CUmemAllocationProp);
SAME_TYPE(CUgraphEdgeData);
SAME_TYPE(CUlaunchConfig);
SAME_TYPE(CUhostFn);

#define SAME_VALUE(name)                                                     \
  static_assert(static_cast<long long>(cudahook::name) ==                    \
                    static_cast<long long>(::name),                          \
                "cuda_driver_api.h: " #name " differs from cuda.h")

SAME_VALUE(CUDA_SUCCESS);
SAME_VALUE(CUDA_ERROR_INVALID_VALUE);
SAME_VALUE(CUDA_ERROR_OUT_OF_MEMORY);
SAME_VALUE(CUDA_ERROR_NOT_INITIALIZED);
SAME_VALUE(CUDA_ERROR_DEINITIALIZED);
SAME_VALUE(CUDA_ERROR_INVALID_CONTEXT);
SAME_VALUE(CUDA_ERROR_INVALID_HANDLE);
SAME_VALUE(CUDA_ERROR_NOT_FOUND);
SAME_VALUE(CUDA_ERROR_NOT_READY);
SAME_VALUE(CUDA_ERROR_NOT_SUPPORTED);
SAME_VALUE(CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED);
SAME_VALUE(CUDA_ERROR_STREAM_CAPTURE_INVALIDATED);
SAME_VALUE(CUDA_ERROR_UNKNOWN);
SAME_VALUE(CU_GET_PROC_ADDRESS_DEFAULT);
SAME_VALUE(CU_GET_PROC_ADDRESS_LEGACY_STREAM);
SAME_VALUE(CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
SAME_VALUE(CU_GET_PROC_ADDRESS_SUCCESS);
SAME_VALUE(CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND);
SAME_VALUE(CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT);
SAME_VALUE(CU_STREAM_CAPTURE_MODE_GLOBAL);
SAME_VALUE(CU_STREAM_CAPTURE_MODE_THREAD_LOCAL);
SAME_VALUE(CU_STREAM_CAPTURE_MODE_RELAXED);
static_assert(sizeof(cudahook::CUresult) == sizeof(::CUresult),
              "CUresult's size");

#define SAME_FIELD(field)                                                    \
  static_assert(offsetof(cudahook::LaunchConfigLayout, field) ==             \
                    offsetof(::CUlaunchConfig, field),                       \
                "cuda_driver_api.h: LaunchConfigLayout." #field)

SAME_FIELD(gridDimX);
SAME_FIELD(gridDimY);
SAME_FIELD(gridDimZ);
SAME_FIELD(blockDimX);
SAME_FIELD(blockDimY);
SAME_FIELD(blockDimZ);
SAME_FIELD(sharedMemBytes);
SAME_FIELD(hStream);
SAME_FIELD(attrs);
SAME_FIELD(numAttrs);
static_assert(sizeof(cudahook::LaunchConfigLayout) == sizeof(::CUlaunchConfig),
              "CUlaunchConfig's size");

int main() {
  // the two stream handles are pointer constants, which only a run holds
  bool ok = cudahook::StreamLegacy() == CU_STREAM_LEGACY &&
            cudahook::StreamPerThread() == CU_STREAM_PER_THREAD;
  std::printf("api_check: cuda_driver_api.h holds against cuda.h %d: %s\n",
              CUDA_VERSION, ok ? "ok" : "stream handles differ");
  return ok ? 0 : 1;
}
