// Prints nvml_api.h's sizes, offsets and constants as one JSON object,
// for the CPU test that holds cell/nvml.py's ctypes structures to them.
#include <cstddef>
#include <cstdio>

#include "../nvml_api.h"

int main() {
  using kubeshare_nvml::nvmlPciInfo_t;
  std::printf(
      "{\"sizeof\": %zu, \"busIdLegacy\": [%zu, %zu], \"domain\": [%zu, %zu], "
      "\"bus\": [%zu, %zu], \"device\": [%zu, %zu], "
      "\"pciDeviceId\": [%zu, %zu], \"pciSubSystemId\": [%zu, %zu], "
      "\"busId\": [%zu, %zu], \"enum\": %zu, \"max_links\": %u, "
      "\"uuid_size\": %u}\n",
      sizeof(nvmlPciInfo_t), offsetof(nvmlPciInfo_t, busIdLegacy),
      sizeof(nvmlPciInfo_t::busIdLegacy), offsetof(nvmlPciInfo_t, domain),
      sizeof(nvmlPciInfo_t::domain), offsetof(nvmlPciInfo_t, bus),
      sizeof(nvmlPciInfo_t::bus), offsetof(nvmlPciInfo_t, device),
      sizeof(nvmlPciInfo_t::device), offsetof(nvmlPciInfo_t, pciDeviceId),
      sizeof(nvmlPciInfo_t::pciDeviceId),
      offsetof(nvmlPciInfo_t, pciSubSystemId),
      sizeof(nvmlPciInfo_t::pciSubSystemId), offsetof(nvmlPciInfo_t, busId),
      sizeof(nvmlPciInfo_t::busId), sizeof(kubeshare_nvml::nvmlReturn_t),
      kubeshare_nvml::kNvLinkMaxLinks, kubeshare_nvml::kUuidSize);
  return 0;
}
