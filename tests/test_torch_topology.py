"""NVLink and PCIe locality of CUDA cards on the CPU: ``cell/nvml.py``
over a fake ``libnvidia-ml.so.1`` (``csrc/nvml_test/fake_nvml.cc``,
built with g++ once a session), ``cell.topology.discover_local_chips``
over it and a fake sysfs tree under ``tmp_path``, and ``link_distance``
held against ``nvidia-smi topo -m`` matrices written by hand.

The nodes follow public documents:

- ``hgx``: an HGX H100 8-GPU board:
  every GPU has 18 NVLinks to the four NVSwitches (5, 4, 4, 5 links),
  GPUs 0-3 on NUMA node 0 and 4-7 on node 1; every pair is NV18;
- ``nvl_pairs``: four H100 NVL cards joined by NVLink bridges in pairs
  0-2 and 1-3 (NV12), each pair on one NUMA node: NV inside a pair, SYS
  across;
- ``pcie``: four H100 PCIe cards without bridges on one NUMA node, two
  behind one switch (PIX), one behind a second switch cascaded below the
  first (PXB), one under a second host bridge (NODE);
- ``pcie_phb``: the same four with the last card under a second root
  port of the first host bridge (PHB).  Four cards cannot show PIX, PXB,
  PHB and NODE at once: PIX and PXB need three cards under one root
  port, and then only one card is left for the other two tiers.

Each card's NUMA node comes from sysfs, the only source discovery reads
it from."""

import ctypes
import json
import os
import shutil
import subprocess
from types import SimpleNamespace

import pytest
import torch

from kubeshare_tpu_torch import constants
from kubeshare_tpu_torch.cell import nvml
from kubeshare_tpu_torch.cell import topology
from kubeshare_tpu_torch.cell.allocator import CellAllocator, ChipInfo
from kubeshare_tpu_torch.cell.cell import build_cell_forest
from kubeshare_tpu_torch.cell.element import build_cell_chains
from kubeshare_tpu_torch.cell.spec import load_config
from kubeshare_tpu_torch.cell.topology import (LINK_TIERS, LinkRecord,
                                               link_distance, link_tier)
from kubeshare_tpu_torch.isolation import hook

NVML_CSRC = hook.CSRC / "nvml_test"
HEADER = (hook.CSRC / "nvml_api.h",)
GIB = 1 << 30


@pytest.fixture(scope="session")
def fake_nvml():
    """The fake libnvidia-ml.so.1's path."""
    return str(hook.build(
        "libnvidia-ml.so.1", (NVML_CSRC / "fake_nvml.cc",),
        (*hook.SHARED, "-Wl,-soname,libnvidia-ml.so.1"), headers=HEADER,
        label="fakenvml"))


# ---- the nodes ----------------------------------------------------------

def _gpu(n, bus, numa, bridges):
    """A card: ``bus`` in sysfs's form, ``bridges`` its upstream path from
    the root complex down (sysfs's form)."""
    return SimpleNamespace(uuid=f"GPU-{n:08x}-1111-4222-8333-{bus[5:7]}0000000000",
                           bus=bus, numa=numa, bridges=tuple(bridges))


def _switched(bus):
    """A card behind a PCIe switch on a root port of its own root
    complex: pciDDDD:RR / RR:01.0 / RR+1:00.0 / RR+2:00.0 / card."""
    b = int(bus[5:7], 16)
    return [f"pci0000:{b - 3:02x}", f"0000:{b - 3:02x}:01.0",
            f"0000:{b - 2:02x}:00.0", f"0000:{b - 1:02x}:00.0"]


HGX_BUSES = ["0000:1b:00.0", "0000:43:00.0", "0000:52:00.0", "0000:61:00.0",
             "0000:9d:00.0", "0000:c3:00.0", "0000:d1:00.0", "0000:df:00.0"]
NVSWITCHES = ["00000000:05:00.0", "00000000:06:00.0", "00000000:07:00.0",
              "00000000:08:00.0"]


def _hgx():
    gpus = [_gpu(i, bus, 0 if i < 4 else 1, _switched(bus))
            for i, bus in enumerate(HGX_BUSES)]
    # links 0-4 to switch 0, 5-8 to 1, 9-12 to 2, 13-17 to 3
    switch_of = [0] * 5 + [1] * 4 + [2] * 4 + [3] * 5
    links = [(i, link, "on", "switch", NVSWITCHES[switch_of[link]])
             for i in range(8) for link in range(18)]
    return gpus, links


def _nvl_pairs():
    root = lambda bus: [f"pci0000:{int(bus[5:7], 16) - 2:02x}",
                        f"0000:{int(bus[5:7], 16) - 2:02x}:01.0"]
    buses = ["0000:4f:00.0", "0000:ce:00.0", "0000:52:00.0", "0000:d1:00.0"]
    gpus = [_gpu(i, bus, numa, root(bus))
            for i, (bus, numa) in enumerate(zip(buses, (0, 1, 0, 1)))]
    links = []
    for a, b in ((0, 2), (1, 3)):
        for link in range(12):  # three bridges of four links
            links.append((a, link, "on", "gpu", nvml.nvml_bus_id(buses[b])))
            links.append((b, link, "on", "gpu", nvml.nvml_bus_id(buses[a])))
    return gpus, links


def _pcie(phb=False):
    s1 = ["pci0000:00", "0000:00:01.0", "0000:01:00.0"]
    last = (["pci0000:00", "0000:00:03.0"] if phb
            else ["pci0000:80", "0000:80:01.0"])
    gpus = [_gpu(0, "0000:03:00.0", 0, s1 + ["0000:02:00.0"]),
            _gpu(1, "0000:04:00.0", 0, s1 + ["0000:02:01.0"]),
            _gpu(2, "0000:07:00.0", 0, s1 + ["0000:02:02.0", "0000:05:00.0",
                                             "0000:06:00.0"]),
            _gpu(3, "0000:08:00.0" if phb else "0000:81:00.0", 0, last)]
    return gpus, []


NODES = {"hgx": _hgx(), "nvl_pairs": _nvl_pairs(), "pcie": _pcie(),
         "pcie_phb": _pcie(phb=True)}

# nvidia-smi topo -m as it prints each node (GPU columns)
MATRICES = {
    "hgx": "\n".join(
        f"GPU{i} " + " ".join("X" if i == j else "NV18" for j in range(8))
        for i in range(8)),
    "nvl_pairs": """
GPU0  X    SYS  NV12 SYS
GPU1  SYS  X    SYS  NV12
GPU2  NV12 SYS  X    SYS
GPU3  SYS  NV12 SYS  X
""",
    "pcie": """
GPU0  X    PIX  PXB  NODE
GPU1  PIX  X    PXB  NODE
GPU2  PXB  PXB  X    NODE
GPU3  NODE NODE NODE X
""",
    "pcie_phb": """
GPU0  X    PIX  PXB  PHB
GPU1  PIX  X    PXB  PHB
GPU2  PXB  PXB  X    PHB
GPU3  PHB  PHB  PHB  X
""",
}


def parse_matrix(text):
    """topo -m rows -> tiers, ``NV<n>`` read as NV."""
    rows = [line.split()[1:] for line in text.strip().splitlines()]
    return [["NV" if t.startswith("NV") else t for t in row] for row in rows]


def write_node(tmp_path, gpus, links, nvml_bus=True):
    """The fake NVML's topology file and a sysfs tree; returns the sysfs
    root.  ``nvml_bus=False`` hides the PCI function from NVML; a string
    is what NVML's PCI query answers for every card (``error=<code>``)."""
    sysfs = tmp_path / "sys"
    (sysfs / "bus" / "pci" / "devices").mkdir(parents=True)
    lines = []
    for g in gpus:
        device = sysfs.joinpath("devices", *g.bridges, g.bus)
        device.mkdir(parents=True)
        (device / "numa_node").write_text(f"{g.numa}\n")
        os.symlink(os.path.relpath(device, sysfs / "bus" / "pci" / "devices"),
                   sysfs / "bus" / "pci" / "devices" / g.bus)
        if isinstance(nvml_bus, str):
            bus = nvml_bus
        else:
            bus = nvml.nvml_bus_id(g.bus) if nvml_bus else "-"
        lines.append(f"gpu {g.uuid} {bus}")
    lines += [f"link {i} {link} {state} {kind} {remote}"
              for i, link, state, kind, remote in links]
    (tmp_path / "topology.txt").write_text("\n".join(lines) + "\n")
    return str(sysfs)


@pytest.fixture
def node(tmp_path, monkeypatch, fake_nvml):
    """``node(gpus, links, visible=None, nvml_bus=True)`` writes a node
    out, makes torch.cuda show the cards ``visible`` (NVML indices, in
    CUDA's order) and returns discover(), over the fake NVML and the
    node's sysfs."""

    def make(gpus, links, visible=None, nvml_bus=True):
        sysfs = write_node(tmp_path, gpus, links, nvml_bus)
        monkeypatch.setenv("FAKE_NVML_TOPOLOGY", str(tmp_path / "topology.txt"))
        order = list(range(len(gpus))) if visible is None else visible
        props = [SimpleNamespace(
            uuid=gpus[i].uuid[len("GPU-"):], total_memory=80 * GIB,
            name="NVIDIA H100 80GB HBM3", pci_domain_id=0,
            pci_bus_id=int(gpus[i].bus[5:7], 16), pci_device_id=0)
            for i in order]
        monkeypatch.setattr(torch.cuda, "device_count", lambda: len(props))
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: props[i])
        return lambda: topology.discover_local_chips(fake_nvml, sysfs)

    return make


def expected_record(gpus, links, i):
    g = gpus[i]
    kinds = {kind for j, _, state, kind, _ in links if j == i and state == "on"}
    if "switch" in kinds:
        domain = "nvswitch"
    elif "gpu" in kinds:
        peers = {remote for j, _, _, kind, remote in links if j == i}
        domain = min(peers | {nvml.nvml_bus_id(g.bus)})
    else:
        domain = ""
    return LinkRecord(nvml.nvml_bus_id(g.bus), g.numa, g.bridges, domain)


# ---- the layout chain: ctypes == nvml_api.h ------------------------------

def test_ctypes_layout_equals_nvml_api_h():
    probe = hook.build("layout_probe", (NVML_CSRC / "layout_probe.cc",), (),
                       headers=HEADER, label="nvml_layout")
    got = json.loads(subprocess.run([str(probe)], check=True, text=True,
                                    capture_output=True).stdout)
    assert got["sizeof"] == ctypes.sizeof(nvml.PciInfo)
    for name, _ in nvml.PciInfo._fields_:
        field = getattr(nvml.PciInfo, name)
        assert [field.offset, field.size] == got[name], name
    assert got["enum"] == 4  # ctypes reads each nvmlReturn_t as a c_int
    assert got["max_links"] == nvml.MAX_LINKS
    assert got["uuid_size"] == nvml.UUID_SIZE


# ---- the three nodes ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NODES))
def test_discovery_and_link_distance_follow_topo_m(node, name):
    gpus, links = NODES[name]
    chips = node(gpus, links)()
    assert [c.uuid for c in chips] == [g.uuid for g in gpus]
    for i, chip in enumerate(chips):
        assert chip.links == expected_record(gpus, links, i), i
    matrix = parse_matrix(MATRICES[name])
    tiers = [[link_tier(a.links, b.links) for b in chips] for a in chips]
    assert tiers == matrix
    assert [[link_distance(a.links, b.links) for b in chips]
            for a in chips] == [[LINK_TIERS[t] for t in row] for row in matrix]


def test_discovery_reads_the_sysfs_root_the_daemon_names(
        node, tmp_path, monkeypatch, fake_nvml):
    """Without an argument discovery reads $KUBESHARE_SYSFS, where the
    collector's DaemonSet mounts the host's /sys."""
    gpus, links = NODES["pcie"]
    node(gpus, links)
    monkeypatch.setenv(constants.ENV_SYSFS, str(tmp_path / "sys"))
    chips = topology.discover_local_chips(fake_nvml)
    assert [c.links for c in chips] == [
        expected_record(gpus, links, i) for i in range(4)]
    monkeypatch.setenv(constants.ENV_SYSFS, str(tmp_path / "elsewhere"))
    chips = topology.discover_local_chips(fake_nvml)
    assert [(c.links.upstream, c.links.numa_node) for c in chips] == \
        [((), -1)] * 4


def test_nvml_reads_every_device_of_a_node(fake_nvml, tmp_path, monkeypatch):
    gpus, links = NODES["nvl_pairs"]
    write_node(tmp_path, gpus, links)
    monkeypatch.setenv("FAKE_NVML_TOPOLOGY", str(tmp_path / "topology.txt"))
    devices = nvml.read_devices(fake_nvml)
    assert [d.uuid for d in devices] == [g.uuid for g in gpus]
    assert [d.bus_id for d in devices] == [
        "00000000:4F:00.0", "00000000:CE:00.0", "00000000:52:00.0",
        "00000000:D1:00.0"]
    assert [len(d.links) for d in devices] == [12] * 4
    assert {(l.remote_bus_id, l.remote_type) for l in devices[0].links} == {
        ("00000000:52:00.0", nvml.LINK_GPU)}
    # the library was shut down: a second read initialises it again
    assert nvml.read_devices(fake_nvml) == devices


@pytest.mark.parametrize("text,want", [
    ("0000:19:00.0", ("00000000:19:00.0", "0000:19:00.0")),
    ("00000000:1B:00.0", ("00000000:1B:00.0", "0000:1b:00.0")),
    ("0001:c3:1f.7", ("00000001:C3:1F.7", "0001:c3:1f.7")),
])
def test_bus_id_forms(text, want):
    assert (nvml.nvml_bus_id(text), nvml.sysfs_bus_id(text)) == want


# ---- what is absent or unavailable ------------------------------------

def test_missing_nvml_raises_and_leaves_chips_without_a_record(
        node, tmp_path, monkeypatch, fake_nvml):
    missing = str(tmp_path / "nowhere" / "libnvidia-ml.so.1")
    with pytest.raises(nvml.NvmlUnavailable) as info:
        nvml.read_devices(missing)
    assert info.value.code == nvml.ERROR_LIBRARY_NOT_FOUND
    gpus, links = NODES["pcie"]
    node(gpus, links)
    sysfs = str(tmp_path / "sys")
    chips = topology.discover_local_chips(missing, sysfs)
    assert len(chips) == 4 and all(c.links is None for c in chips)
    # a driver that is not loaded fails nvmlInit_v2: the same answers
    monkeypatch.setenv("FAKE_NVML_INIT", "9")
    with pytest.raises(nvml.NvmlUnavailable) as info:
        nvml.read_devices(fake_nvml)
    assert info.value.code == 9
    chips = topology.discover_local_chips(fake_nvml, sysfs)
    assert len(chips) == 4 and all(c.links is None for c in chips)


# NO_PERMISSION, GPU_IS_LOST, UNKNOWN
@pytest.mark.parametrize("code", [4, 15, 999])
def test_a_failing_nvml_query_leaves_chips_without_a_record(
        node, fake_nvml, code):
    """Any other code from a device query raises in ``cell/nvml.py``;
    discovery still exports every card, without a record."""
    gpus, links = NODES["nvl_pairs"]
    discover = node(gpus, links, nvml_bus=f"error={code}")
    with pytest.raises(nvml.NvmlError) as info:
        nvml.read_devices(fake_nvml)
    assert not isinstance(info.value, nvml.NvmlUnavailable)
    assert (info.value.call, info.value.code) == (
        "nvmlDeviceGetPciInfo_v3", code)
    chips = discover()
    assert [c.uuid for c in chips] == [g.uuid for g in gpus]
    assert all(c.links is None for c in chips)


def test_not_supported_links_are_absent(node, fake_nvml):
    """A PCIe card answers NOT_SUPPORTED for every link; a card whose
    link answers it beside enabled ones keeps only those."""
    gpus, _ = NODES["nvl_pairs"]
    links = [(0, 0, "on", "gpu", "00000000:52:00.0"),
             (0, 1, "unsupported", "gpu", "00000000:52:00.0"),
             (0, 2, "off", "gpu", "00000000:52:00.0"),
             (2, 0, "on", "gpu", "00000000:4F:00.0")]
    discover = node(gpus, links)
    devices = nvml.read_devices(fake_nvml)
    assert [[l.link for l in d.links] for d in devices] == [[0], [], [0], []]
    chips = discover()
    assert [c.links.nvlink for c in chips] == [
        "00000000:4F:00.0", "", "00000000:4F:00.0", ""]
    assert link_tier(chips[0].links, chips[2].links) == "NV"
    assert link_tier(chips[0].links, chips[1].links) == "SYS"
    # 1 and 3 lost their bridge: two host bridges of one NUMA node
    assert link_tier(chips[1].links, chips[3].links) == "NODE"


def test_records_follow_uuids_under_renumbered_visible_devices(node):
    """CUDA_VISIBLE_DEVICES=6,1 shows NVML's devices 6 and 1 as cuda:0
    and cuda:1: each chip's record is its own card's."""
    gpus, links = NODES["hgx"]
    chips = node(gpus, links, visible=[6, 1])()
    assert [c.index for c in chips] == [0, 1]
    assert [c.uuid for c in chips] == [gpus[6].uuid, gpus[1].uuid]
    assert [c.links.bus_id for c in chips] == [
        "00000000:D1:00.0", "00000000:43:00.0"]
    assert [c.links.numa_node for c in chips] == [1, 0]
    assert link_tier(chips[0].links, chips[1].links) == "NV"


def test_a_hidden_pci_function_takes_the_runtime_bus_id(node, tmp_path):
    """A sandboxed host (the H100 machine of chip_smoke.py): NVML answers
    NOT_SUPPORTED for the PCI function and the host has no sysfs PCI
    tree, but the NVLinks to the NVSwitches read.  The record takes the
    CUDA runtime's bus id, no path and no NUMA node."""
    gpus, links = _hgx()
    discover = node(gpus[:2], [l for l in links if l[0] < 2], nvml_bus=False)
    shutil.rmtree(tmp_path / "sys")
    chips = discover()
    assert [c.links for c in chips] == [
        LinkRecord("00000000:1B:00.0", -1, (), "nvswitch"),
        LinkRecord("00000000:43:00.0", -1, (), "nvswitch")]
    assert link_distance(chips[0].links, chips[0].links) == 0
    assert link_tier(chips[0].links, chips[1].links) == "NV"


def test_tiers_without_a_path_fall_back_to_numa():
    a = LinkRecord("00000000:03:00.0", 0)
    assert link_tier(a, LinkRecord("00000000:04:00.0", 0)) == "NODE"
    assert link_tier(a, LinkRecord("00000000:04:00.0", 1)) == "SYS"
    assert link_tier(LinkRecord("00000000:03:00.0"),
                     LinkRecord("00000000:04:00.0")) == "SYS"
    assert link_tier(a, LinkRecord("00000000:03:00.0", 0)) == "X"


# ---- the record on the wire and in the allocator ----------------------

RECORDS = [
    LinkRecord("00000000:1B:00.0", 0,
               ("pci0000:18", "0000:18:01.0", "0000:19:00.0", "0000:1a:00.0"),
               "nvswitch"),
    LinkRecord("00000000:4F:00.0", 1, ("pci0000:4d", "0000:4d:01.0"),
               "00000000:4F:00.0"),
    LinkRecord("00000000:BB:00.0", -1, (), ""),
    LinkRecord("", -1, (), ""),
]


@pytest.mark.parametrize("record", RECORDS)
def test_label_round_trip(record):
    assert LinkRecord.from_label(record.label()) == record


@pytest.mark.parametrize("text", [
    "", "00000000:1B:00.0;0;", "00000000:1B:00.0;zero;;",
    "0000:1b:00.0;0;;", "00000000:1B:00.0;-2;;",
    "00000000:1B:00.0;0;0000:18:01.0;", "00000000:1B:00.0;0;pci0000:18/0000:18:1.0;",
    "not-a-bus;0;;", "00000000:1B:00.0;0;;nvswitch;extra",
])
def test_a_malformed_label_gives_no_record(text):
    assert LinkRecord.from_label(text) is None


def test_chip_equality_ignores_the_record():
    a = ChipInfo("GPU-a", GIB, "NVIDIA-H100-80GB-HBM3", 0)
    b = ChipInfo("GPU-a", GIB, "NVIDIA-H100-80GB-HBM3", 0)
    a.links = RECORDS[0]
    assert a == b and a.links != b.links and b.links is None


def test_the_allocator_binds_each_record_to_its_chips_leaf():
    """Leaves bind chips in declaration order; the record goes with the
    chip's UUID, whatever order the collector reported them in."""
    config = load_config(text="""
cellTypes:
  4-H100-NODE:
    childCellType: NVIDIA-H100-80GB-HBM3
    childCellNumber: 4
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: 4-H100-NODE
  cellId: node-a
""")
    elements, priority, _ = build_cell_chains(config.cell_types)
    allocator = CellAllocator(build_cell_forest(elements, config.cells),
                              priority)
    chips = []
    for i in (3, 1, 0, 2):
        chip = ChipInfo(f"GPU-{i}", 80 * GIB, "NVIDIA-H100-80GB-HBM3", i)
        chip.links = LinkRecord(f"00000000:{0x10 + i:02X}:00.0", i % 2)
        chips.append(chip)
    allocator.set_node_inventory("node-a", chips)
    allocator.set_node_status("node-a", True)
    leaves = allocator.leaf_cells
    assert sorted(leaves) == [f"GPU-{i}" for i in range(4)]
    for uuid, leaf in leaves.items():
        i = int(uuid[-1])
        assert leaf.links == LinkRecord(f"00000000:{0x10 + i:02X}:00.0", i % 2)
