// Holds the in-tree NVML API (nvml_api.h) against the CUDA toolkit's own
// nvml.h: one static_assert per function type, per enum value, per
// constant and per struct offset, so that a wrong declaration fails this
// build.  chip_smoke.py builds and runs it on the machine with the card:
//
//   g++ -std=c++17 -I/usr/local/cuda/include api_check.cc -o api_check
//
// The function types are compared after mapping the three enums and the
// PCI struct of ours onto nvml.h's; the device handle names nvml.h's own
// struct tag, so it is the same C++ type by construction.

#include <nvml.h>

#include <cstddef>
#include <cstdio>
#include <type_traits>

#include "../nvml_api.h"

namespace {

namespace ours = kubeshare_nvml;

// the toolkit's type for each of ours
template <typename T>
struct Theirs {
  using type = T;
};
template <>
struct Theirs<ours::nvmlReturn_t> {
  using type = ::nvmlReturn_t;
};
template <>
struct Theirs<ours::nvmlEnableState_t> {
  using type = ::nvmlEnableState_t;
};
template <>
struct Theirs<ours::nvmlIntNvLinkDeviceType_t> {
  using type = ::nvmlIntNvLinkDeviceType_t;
};
template <>
struct Theirs<ours::nvmlPciInfo_t> {
  using type = ::nvmlPciInfo_t;
};
template <typename T>
struct Theirs<T*> {
  using type = typename Theirs<T>::type*;
};
template <typename R, typename... A>
struct Theirs<R(A...)> {
  using type = typename Theirs<R>::type(typename Theirs<A>::type...);
};

}  // namespace

#define SAME_FN(name)                                                        \
  static_assert(std::is_same<Theirs<ours::name##_t>::type,                  \
                             decltype(::name)>::value,                      \
                "nvml_api.h: " #name " differs from nvml.h")

SAME_FN(nvmlInit_v2);
SAME_FN(nvmlShutdown);
SAME_FN(nvmlDeviceGetCount_v2);
SAME_FN(nvmlDeviceGetHandleByIndex_v2);
SAME_FN(nvmlDeviceGetUUID);
SAME_FN(nvmlDeviceGetPciInfo_v3);
SAME_FN(nvmlDeviceGetNvLinkState);
SAME_FN(nvmlDeviceGetNvLinkRemotePciInfo_v2);
SAME_FN(nvmlDeviceGetNvLinkRemoteDeviceType);

static_assert(std::is_same<ours::nvmlDevice_t, ::nvmlDevice_t>::value,
              "nvml_api.h: nvmlDevice_t differs from nvml.h");

#define SAME_VALUE(name)                                                     \
  static_assert(static_cast<long long>(ours::name) ==                        \
                    static_cast<long long>(::name),                          \
                "nvml_api.h: " #name " differs from nvml.h")

SAME_VALUE(NVML_SUCCESS);
SAME_VALUE(NVML_ERROR_UNINITIALIZED);
SAME_VALUE(NVML_ERROR_INVALID_ARGUMENT);
SAME_VALUE(NVML_ERROR_NOT_SUPPORTED);
SAME_VALUE(NVML_ERROR_NO_PERMISSION);
SAME_VALUE(NVML_ERROR_NOT_FOUND);
SAME_VALUE(NVML_ERROR_INSUFFICIENT_SIZE);
SAME_VALUE(NVML_ERROR_DRIVER_NOT_LOADED);
SAME_VALUE(NVML_ERROR_LIBRARY_NOT_FOUND);
SAME_VALUE(NVML_ERROR_FUNCTION_NOT_FOUND);
SAME_VALUE(NVML_ERROR_GPU_IS_LOST);
SAME_VALUE(NVML_ERROR_UNKNOWN);
SAME_VALUE(NVML_FEATURE_DISABLED);
SAME_VALUE(NVML_FEATURE_ENABLED);
SAME_VALUE(NVML_NVLINK_DEVICE_TYPE_GPU);
SAME_VALUE(NVML_NVLINK_DEVICE_TYPE_IBMNPU);
SAME_VALUE(NVML_NVLINK_DEVICE_TYPE_SWITCH);
SAME_VALUE(NVML_NVLINK_DEVICE_TYPE_UNKNOWN);
static_assert(sizeof(ours::nvmlReturn_t) == sizeof(::nvmlReturn_t),
              "nvmlReturn_t's size");
static_assert(sizeof(ours::nvmlEnableState_t) == sizeof(::nvmlEnableState_t),
              "nvmlEnableState_t's size");
static_assert(sizeof(ours::nvmlIntNvLinkDeviceType_t) ==
                  sizeof(::nvmlIntNvLinkDeviceType_t),
              "nvmlIntNvLinkDeviceType_t's size");

#define SAME_CONSTANT(ours_name, name)                                       \
  static_assert(ours::ours_name == name,                                     \
                "nvml_api.h: " #ours_name " differs from nvml.h's " #name)

SAME_CONSTANT(kNvLinkMaxLinks, NVML_NVLINK_MAX_LINKS);
SAME_CONSTANT(kPciBusIdSize, NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE);
SAME_CONSTANT(kPciBusIdLegacySize, NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE);
SAME_CONSTANT(kUuidSize, NVML_DEVICE_UUID_V2_BUFFER_SIZE);

#define SAME_FIELD(field)                                                    \
  static_assert(offsetof(ours::nvmlPciInfo_t, field) ==                      \
                        offsetof(::nvmlPciInfo_t, field) &&                  \
                    sizeof(ours::nvmlPciInfo_t::field) ==                    \
                        sizeof(::nvmlPciInfo_t::field),                      \
                "nvml_api.h: nvmlPciInfo_t." #field)

SAME_FIELD(busIdLegacy);
SAME_FIELD(domain);
SAME_FIELD(bus);
SAME_FIELD(device);
SAME_FIELD(pciDeviceId);
SAME_FIELD(pciSubSystemId);
SAME_FIELD(busId);
static_assert(sizeof(ours::nvmlPciInfo_t) == sizeof(::nvmlPciInfo_t),
              "nvmlPciInfo_t's size");

int main() {
  std::printf("nvml api_check: nvml_api.h holds against nvml.h "
              "(NVML_API_VERSION %d): ok\n", NVML_API_VERSION);
  return 0;
}
