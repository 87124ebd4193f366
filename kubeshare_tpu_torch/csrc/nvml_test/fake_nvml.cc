// A stand-in libnvidia-ml.so.1 for the CPU tests of the port's device
// discovery (cell/nvml.py, cell/topology.py).  Built by
// tests/test_torch_topology.py as libnvidia-ml.so.1 (soname
// libnvidia-ml.so.1).
//
// nvmlInit_v2 reads the topology the file $FAKE_NVML_TOPOLOGY describes,
// one item a line ('#' starts a comment):
//
//   gpu <uuid> <bus id | - | error=<code>>
//   link <gpu index> <link> <on | off | unsupported> <gpu | switch> <bus id>
//
// A gpu's bus id in NVML's form (00000000:19:00.0), or '-' where
// nvmlDeviceGetPciInfo_v3 answers NVML_ERROR_NOT_SUPPORTED, or the code
// it answers instead (error=15 is NVML_ERROR_GPU_IS_LOST).
// A gpu without a link line has no NVLink: every link query answers
// NOT_SUPPORTED, as on a PCIe card without a bridge.  A gpu with link
// lines answers NVML_FEATURE_DISABLED for the links not listed below
// kNvLinkMaxLinks, NOT_SUPPORTED for a link listed as 'unsupported', and
// INVALID_ARGUMENT from kNvLinkMaxLinks on, as the driver does.
//
// $FAKE_NVML_INIT=<code> makes nvmlInit_v2 fail with that code (9 is
// NVML_ERROR_DRIVER_NOT_LOADED); a missing topology file fails it too.
// Every call but nvmlInit_v2 answers NVML_ERROR_UNINITIALIZED outside
// an init / shutdown pair.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "../nvml_api.h"

using namespace kubeshare_nvml;

namespace {

struct Link {
  nvmlReturn_t rc = NVML_SUCCESS;
  nvmlEnableState_t state = NVML_FEATURE_DISABLED;
  nvmlIntNvLinkDeviceType_t type = NVML_NVLINK_DEVICE_TYPE_UNKNOWN;
  std::string remote;
};

struct Gpu {
  std::string uuid, bus;
  nvmlReturn_t pci_rc = NVML_SUCCESS;  // what the PCI query answers
  std::map<unsigned int, Link> links;
};

std::vector<Gpu> g_gpus;
int g_inits = 0;

bool Parse(const char* path) {
  std::ifstream in(path);
  if (!in) return false;
  g_gpus.clear();
  std::string line;
  while (std::getline(in, line)) {
    line = line.substr(0, line.find('#'));
    std::istringstream words(line);
    std::string kind;
    if (!(words >> kind)) continue;
    if (kind == "gpu") {
      Gpu gpu;
      if (!(words >> gpu.uuid >> gpu.bus)) return false;
      if (gpu.bus == "-") {
        gpu.pci_rc = NVML_ERROR_NOT_SUPPORTED;
      } else if (gpu.bus.rfind("error=", 0) == 0) {
        gpu.pci_rc = static_cast<nvmlReturn_t>(std::atoi(gpu.bus.c_str() + 6));
      }
      g_gpus.push_back(gpu);
    } else if (kind == "link") {
      unsigned int index = 0, link = 0;
      std::string state, type;
      Link l;
      if (!(words >> index >> link >> state >> type >> l.remote) ||
          index >= g_gpus.size()) {
        return false;
      }
      if (state == "unsupported") l.rc = NVML_ERROR_NOT_SUPPORTED;
      l.state = state == "on" ? NVML_FEATURE_ENABLED : NVML_FEATURE_DISABLED;
      l.type = type == "switch" ? NVML_NVLINK_DEVICE_TYPE_SWITCH
                                : NVML_NVLINK_DEVICE_TYPE_GPU;
      g_gpus[index].links[link] = l;
    } else {
      return false;
    }
  }
  return true;
}

Gpu* Of(nvmlDevice_t device) {
  std::size_t index = reinterpret_cast<std::size_t>(device);
  if (index == 0 || index > g_gpus.size()) return nullptr;
  return &g_gpus[index - 1];
}

void FillPci(const std::string& bus_id, nvmlPciInfo_t* pci) {
  std::memset(pci, 0, sizeof(*pci));
  unsigned int domain = 0, bus = 0, device = 0, function = 0;
  std::sscanf(bus_id.c_str(), "%x:%x:%x.%x", &domain, &bus, &device,
              &function);
  pci->domain = domain;
  pci->bus = bus;
  pci->device = device;
  pci->pciDeviceId = 0x233010de;  // H100 SXM5 80GB, vendor 10de
  std::snprintf(pci->busId, sizeof(pci->busId), "%08X:%02X:%02X.%X", domain,
                bus, device, function);
  std::snprintf(pci->busIdLegacy, sizeof(pci->busIdLegacy),
                "%04X:%02X:%02X.%X", domain, bus, device, function);
}

// The link of a device, or the code its query answers.
nvmlReturn_t LinkOf(nvmlDevice_t device, unsigned int link, Link** out) {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  Gpu* gpu = Of(device);
  if (gpu == nullptr || link >= kNvLinkMaxLinks) {
    return NVML_ERROR_INVALID_ARGUMENT;
  }
  if (gpu->links.empty()) return NVML_ERROR_NOT_SUPPORTED;
  static Link disabled;
  auto it = gpu->links.find(link);
  *out = it == gpu->links.end() ? &disabled : &it->second;
  return (*out)->rc;
}

}  // namespace

extern "C" {

nvmlInit_v2_t nvmlInit_v2;
nvmlShutdown_t nvmlShutdown;
nvmlDeviceGetCount_v2_t nvmlDeviceGetCount_v2;
nvmlDeviceGetHandleByIndex_v2_t nvmlDeviceGetHandleByIndex_v2;
nvmlDeviceGetUUID_t nvmlDeviceGetUUID;
nvmlDeviceGetPciInfo_v3_t nvmlDeviceGetPciInfo_v3;
nvmlDeviceGetNvLinkState_t nvmlDeviceGetNvLinkState;
nvmlDeviceGetNvLinkRemotePciInfo_v2_t nvmlDeviceGetNvLinkRemotePciInfo_v2;
nvmlDeviceGetNvLinkRemoteDeviceType_t nvmlDeviceGetNvLinkRemoteDeviceType;

nvmlReturn_t nvmlInit_v2() {
  const char* fail = std::getenv("FAKE_NVML_INIT");
  if (fail != nullptr && *fail != '\0') {
    return static_cast<nvmlReturn_t>(std::atoi(fail));
  }
  const char* path = std::getenv("FAKE_NVML_TOPOLOGY");
  if (g_inits == 0 && (path == nullptr || !Parse(path))) {
    return NVML_ERROR_DRIVER_NOT_LOADED;
  }
  g_inits++;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlShutdown() {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  g_inits--;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetCount_v2(unsigned int* count) {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  *count = static_cast<unsigned int>(g_gpus.size());
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetHandleByIndex_v2(unsigned int index,
                                           nvmlDevice_t* device) {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  if (index >= g_gpus.size()) return NVML_ERROR_INVALID_ARGUMENT;
  *device = reinterpret_cast<nvmlDevice_t>(static_cast<std::size_t>(index + 1));
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetUUID(nvmlDevice_t device, char* uuid,
                               unsigned int length) {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  Gpu* gpu = Of(device);
  if (gpu == nullptr) return NVML_ERROR_INVALID_ARGUMENT;
  if (gpu->uuid.size() + 1 > length) return NVML_ERROR_INSUFFICIENT_SIZE;
  std::memcpy(uuid, gpu->uuid.c_str(), gpu->uuid.size() + 1);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetPciInfo_v3(nvmlDevice_t device, nvmlPciInfo_t* pci) {
  if (g_inits == 0) return NVML_ERROR_UNINITIALIZED;
  Gpu* gpu = Of(device);
  if (gpu == nullptr) return NVML_ERROR_INVALID_ARGUMENT;
  if (gpu->pci_rc != NVML_SUCCESS) return gpu->pci_rc;
  FillPci(gpu->bus, pci);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetNvLinkState(nvmlDevice_t device, unsigned int link,
                                      nvmlEnableState_t* active) {
  Link* l = nullptr;
  nvmlReturn_t rc = LinkOf(device, link, &l);
  if (rc == NVML_SUCCESS) *active = l->state;
  return rc;
}

nvmlReturn_t nvmlDeviceGetNvLinkRemotePciInfo_v2(nvmlDevice_t device,
                                                 unsigned int link,
                                                 nvmlPciInfo_t* pci) {
  Link* l = nullptr;
  nvmlReturn_t rc = LinkOf(device, link, &l);
  if (rc != NVML_SUCCESS) return rc;
  if (l->remote.empty()) return NVML_ERROR_NOT_SUPPORTED;
  FillPci(l->remote, pci);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetNvLinkRemoteDeviceType(
    nvmlDevice_t device, unsigned int link, nvmlIntNvLinkDeviceType_t* type) {
  Link* l = nullptr;
  nvmlReturn_t rc = LinkOf(device, link, &l);
  if (rc == NVML_SUCCESS) *type = l->type;
  return rc;
}

}  // extern "C"
