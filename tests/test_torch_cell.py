"""The port's cell model and utilities against the JAX package's
(tests/test_cell.py and the bitmap / atomic-file / net cases of
tests/test_utils.py): the same configs, inventories and operations go
through kubeshare_tpu.cell and kubeshare_tpu_torch.cell, and the parsed
configs, the type chains, the cell forests and the allocator's whole
state after every step must be equal.  Pure Python: no tensors."""

import dataclasses
import os
import random
import socket
import threading

import pytest

from kubeshare_tpu import cell as jax_cell
from kubeshare_tpu.cell import spec as jax_spec
from kubeshare_tpu.cell import topology as jax_topology
from kubeshare_tpu.utils import atomicfile as jax_atomicfile
from kubeshare_tpu.utils import bitmap as jax_bitmap
from kubeshare_tpu.utils import net as jax_net
from kubeshare_tpu_torch import cell as port_cell
from kubeshare_tpu_torch.cell import spec as port_spec
from kubeshare_tpu_torch.cell import topology as port_topology
from kubeshare_tpu_torch.utils import atomicfile as port_atomicfile
from kubeshare_tpu_torch.utils import bitmap as port_bitmap
from kubeshare_tpu_torch.utils import net as port_net

from native_helpers import free_port

# tests/test_cell.py's reference topology, TPU-ified
HETERO_CONFIG = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  3-V4-NODE:
    childCellType: V4-NODE
    childCellNumber: 3
  V5E-NODE:
    childCellType: "TPU-v5e"
    childCellNumber: 8
    childCellPriority: 80
    isNodeLevel: true
cells:
- cellType: 3-V4-NODE
  cellChildren:
  - cellId: juno
  - cellId: apple
  - cellId: lemon
- cellType: V5E-NODE
  cellId: cupid
"""

# the reference's own GPU form: CUDA cards of two models, a rack of two
# 8-card H100 hosts and a lone 4-card A100 host
GPU_CONFIG = """
cellTypes:
  8-H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 8
    childCellPriority: 100
    isNodeLevel: true
  2-H100-RACK:
    childCellType: 8-H100-NODE
    childCellNumber: 2
  4-A100-NODE:
    childCellType: "NVIDIA-A100-SXM4-40GB"
    childCellNumber: 4
    childCellPriority: 50
    isNodeLevel: true
cells:
- cellType: 2-H100-RACK
  cellChildren:
  - cellId: gpu-a
  - cellId: gpu-b
- cellType: 4-A100-NODE
  cellId: gpu-c
"""

# slices marked explicitly: two 2-host slices under one pod-level cell
SLICE_CONFIG = """
cellTypes:
  V5P-HOST:
    childCellType: "TPU-v5p"
    childCellNumber: 4
    childCellPriority: 90
    isNodeLevel: true
  V5P-SLICE:
    childCellType: V5P-HOST
    childCellNumber: 2
    isSliceLevel: true
  V5P-POD:
    childCellType: V5P-SLICE
    childCellNumber: 2
cells:
- cellType: V5P-POD
  cellChildren:
  - cellChildren:
    - cellId: s0h0
    - cellId: s0h1
  - cellChildren:
    - cellId: s1h0
    - cellId: s1h1
"""

# one card on one node, as chip_smoke.py's placement phase builds it
ONE_CARD_CONFIG = """
cellTypes:
  1-H100-NODE:
    childCellType: "NVIDIA-H100-80GB-HBM3"
    childCellNumber: 1
    childCellPriority: 100
    isNodeLevel: true
cells:
- cellType: 1-H100-NODE
  cellId: card-node
"""

CONFIGS = {"hetero": HETERO_CONFIG, "gpu": GPU_CONFIG, "slices": SLICE_CONFIG,
           "one_card": ONE_CARD_CONFIG}

BAD_CONFIGS = {
    "unknown_type": "cellTypes: {}\ncells:\n- cellType: NOPE\n",
    "priority_range": """
cellTypes:
  X-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 1
    childCellPriority: 101
    isNodeLevel: true
cells:
- cellType: X-NODE
  cellId: n1
""",
    "children_count": """
cellTypes:
  X-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 2
    isNodeLevel: true
cells:
- cellType: X-NODE
  cellId: n1
  cellChildren:
  - cellId: a
""",
}

# inventories by node for each config: (uuid prefix, count, memory, model,
# coords or None)
INVENTORY = {
    "hetero": {"juno": ("juno", 4, 32 << 30, "TPU-v4", True),
               "apple": ("apple", 4, 32 << 30, "TPU-v4", True),
               "lemon": ("lemon", 2, 32 << 30, "TPU-v4", True),
               "cupid": ("cupid", 8, 16 << 30, "TPU-v5e", False)},
    "gpu": {"gpu-a": ("GPU-a", 8, 80 << 30, "NVIDIA-H100-80GB-HBM3", False),
            "gpu-b": ("GPU-b", 8, 80 << 30, "NVIDIA-H100-80GB-HBM3", False),
            "gpu-c": ("GPU-c", 4, 40 << 30, "NVIDIA-A100-SXM4-40GB", False)},
    "slices": {f"s{s}h{h}": (f"s{s}h{h}", 4, 95 << 30, "TPU-v5p", True)
               for s in range(2) for h in range(2)},
    "one_card": {"card-node": ("GPU-card", 1, 80 << 30,
                               "NVIDIA-H100-80GB-HBM3", False)},
}


def chips(pkg, node_spec, row=0):
    prefix, n, memory, model, with_coords = node_spec
    return [pkg.ChipInfo(uuid=f"{prefix}-{i}", memory=memory, model=model,
                         index=i, coords=(i, row, 0) if with_coords else None)
            for i in range(n)]


def as_data(obj):
    """A dataclass tree (configs, elements) as plain data."""
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def cell_row(cell):
    return (cell.id, cell.cell_type, cell.level, cell.priority,
            cell.leaf_cell_type, cell.leaf_cell_number, cell.higher_than_node,
            cell.is_node, cell.node, cell.uuid, round(cell.available, 9),
            round(cell.available_whole_cell, 9), cell.free_memory,
            cell.full_memory, cell.healthy, cell.state.value, cell.coords,
            cell.parent.id if cell.parent is not None else None)


def forest_rows(forest):
    rows = []
    for model in sorted(forest):
        for level in sorted(forest[model]):
            for root in forest[model][level]:
                rows.extend(cell_row(c) for c in root.walk())
    return rows


def allocator_state(alloc):
    return {
        "forest": forest_rows(alloc.free_list),
        "leaves": sorted(alloc.leaf_cells),
        "chips": {node: {model: [dataclasses.astuple(c) for c in cs]
                         for model, cs in by_model.items()}
                  for node, by_model in alloc.chip_infos.items()},
        "health": dict(alloc.node_health),
    }


def build(pkg, text):
    config = pkg.load_config(text=text)
    elements, priority, sorted_models = pkg.build_cell_chains(config.cell_types)
    forest = pkg.build_cell_forest(elements, config.cells)
    return config, elements, priority, sorted_models, forest


# ---- spec, chains, forest ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_inference_matches(name):
    jax_config = jax_cell.load_config(text=CONFIGS[name])
    port_config = port_cell.load_config(text=CONFIGS[name])
    assert as_data(port_config) == as_data(jax_config)
    # from_dict + the check, as the card's phase builds a topology
    # without PyYAML
    import yaml

    raw = yaml.safe_load(CONFIGS[name])
    twin = port_spec.TopologyConfig.from_dict(raw)
    port_spec.check_physical_cells(twin)
    assert as_data(twin) == as_data(jax_config)


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_config_errors_match(name):
    with pytest.raises(jax_spec.ConfigError) as jax_error:
        jax_cell.load_config(text=BAD_CONFIGS[name])
    with pytest.raises(port_spec.ConfigError) as port_error:
        port_cell.load_config(text=BAD_CONFIGS[name])
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chains_and_forest_match(name):
    _, jax_elements, jax_priority, jax_sorted, jax_forest = build(
        jax_cell, CONFIGS[name])
    _, port_elements, port_priority, port_sorted, port_forest = build(
        port_cell, CONFIGS[name])
    assert {k: as_data(v) for k, v in port_elements.items()} == \
        {k: as_data(v) for k, v in jax_elements.items()}
    assert port_priority == jax_priority and port_sorted == jax_sorted
    assert forest_rows(port_forest) == forest_rows(jax_forest)


def test_cycle_and_top_cell_errors_match():
    cyclic = {"A": {"childCellType": "B", "childCellNumber": 1},
              "B": {"childCellType": "A", "childCellNumber": 1}}
    messages = []
    for pkg, spec in ((jax_cell, jax_spec), (port_cell, port_spec)):
        types = {k: spec.CellTypeSpec.from_dict(v) for k, v in cyclic.items()}
        with pytest.raises(spec.ConfigError) as error:
            pkg.build_cell_chains(types)
        messages.append(str(error.value))
        config = pkg.load_config(text=HETERO_CONFIG)
        elements, _, _ = pkg.build_cell_chains(config.cell_types)
        with pytest.raises(ValueError) as error:
            pkg.build_cell_forest(elements, [spec.CellSpec("TPU-v4", "x")])
        messages.append(str(error.value))
    assert messages[:2] == messages[2:]


# ---- the allocator ----------------------------------------------------------

def _step(alloc, pkg, name, op):
    """One operation on ``alloc``; returns what it returned (as data)."""
    kind = op[0]
    if kind == "inventory":
        node = op[1]
        alloc.set_node_inventory(node, chips(pkg, INVENTORY[name][node],
                                             row=op[2] if len(op) > 2 else 0))
        return None
    if kind == "health":
        alloc.set_node_status(op[1], op[2])
        return None
    if kind in ("reserve", "reclaim"):
        leaf = alloc.leaf_cells[op[1]]
        getattr(alloc, kind)(leaf, op[2], op[3])
        return None
    if kind == "filter":
        fit, avail, mem = alloc.filter_node(op[1], op[2], op[3], op[4])
        return (fit, round(avail, 9), mem)
    if kind == "leaves":
        return [c.uuid for c in alloc.leaf_cells_by_node(op[1], op[2])]
    if kind == "has_model":
        return alloc.nodes_with_model(op[1])
    if kind == "generation":
        return alloc.fit_generation(op[1])
    raise ValueError(kind)


def run_twin(name, ops):
    """The ops through both allocators; each step's result and the whole
    state after it must be equal."""
    allocs = {}
    for key, pkg in (("jax", jax_cell), ("port", port_cell)):
        *_, priority, _, forest = build(pkg, CONFIGS[name])
        allocs[key] = (pkg, pkg.CellAllocator(forest, priority))
    for i, op in enumerate(ops):
        got = {key: _step(alloc, pkg, name, op)
               for key, (pkg, alloc) in allocs.items()}
        assert got["port"] == got["jax"], (i, op)
        assert allocator_state(allocs["port"][1]) == \
            allocator_state(allocs["jax"][1]), (i, op)
    return allocs["port"][1]


GIB = 1 << 30
SEQUENCES = {
    # tests/test_cell.py's TestAllocator cases
    "binding": ("hetero", [("inventory", "juno"), ("health", "juno", True),
                           ("leaves", "juno", ""), ("leaves", "apple", "")]),
    "reserve_reclaim": ("hetero", [
        ("inventory", "juno"), ("health", "juno", True),
        ("reserve", "juno-0", 0.5, 16 * GIB),
        ("filter", "juno", "TPU-v4", 4.0, 0),
        ("reclaim", "juno-0", 0.5, 16 * GIB),
        ("filter", "juno", "TPU-v4", 4.0, 0)]),
    "fractional_fit": ("hetero", [
        ("inventory", "juno"), ("health", "juno", True),
        ("filter", "juno", "TPU-v4", 0.5, GIB),
        ("filter", "juno", "TPU-v4", 0.5, 64 * GIB),
        *[("reserve", f"juno-{i}", 0.6, GIB) for i in range(4)],
        ("filter", "juno", "TPU-v4", 0.5, GIB),
        ("filter", "juno", "TPU-v4", 0.4, GIB),
        ("filter", "juno", "TPU-v4", 0.5, 0)]),
    "multichip_fit": ("hetero", [
        ("inventory", "juno"), ("health", "juno", True),
        ("filter", "juno", "TPU-v4", 2.0, 0),
        ("filter", "juno", "TPU-v4", 5.0, 0),
        ("reserve", "juno-0", 0.1, GIB),
        ("filter", "juno", "TPU-v4", 4.0, 0),
        ("filter", "juno", "TPU-v4", 3.0, 0),
        ("filter", "juno", "TPU-v9", 0.5, 0)]),
    "health_bounce": ("hetero", [
        ("inventory", "juno"), ("health", "juno", True),
        ("reserve", "juno-0", 0.5, 1), ("health", "juno", False),
        ("filter", "juno", "TPU-v4", 0.5, 0), ("leaves", "juno", ""),
        ("health", "juno", True), ("filter", "juno", "TPU-v4", 0.5, 0),
        ("generation", "juno")]),
    "inventory_after_health": ("hetero", [
        ("health", "apple", True), ("filter", "apple", "TPU-v4", 0.5, 0),
        ("inventory", "apple"), ("filter", "apple", "TPU-v4", 0.5, GIB),
        ("health", "lemon", True), ("filter", "lemon", "TPU-v4", 2.0, 0),
        ("inventory", "lemon"), ("filter", "lemon", "TPU-v4", 2.0, 0),
        ("filter", "lemon", "TPU-v4", 3.0, 0), ("has_model", "TPU-v4")]),
    "gpu_rack": ("gpu", [
        ("inventory", "gpu-a"), ("health", "gpu-a", True),
        ("inventory", "gpu-c"), ("health", "gpu-c", True),
        ("reserve", "GPU-a-3", 0.25, 10 * GIB),
        ("reserve", "GPU-a-3", 0.5, 30 * GIB),
        ("filter", "gpu-a", "NVIDIA-H100-80GB-HBM3", 8.0, 0),
        ("filter", "gpu-a", "NVIDIA-H100-80GB-HBM3", 7.0, 0),
        ("filter", "gpu-c", "", 0.5, 50 * GIB),
        ("leaves", "gpu-c", "NVIDIA-A100-SXM4-40GB"),
        ("reclaim", "GPU-a-3", 0.25, 10 * GIB),
        ("has_model", "NVIDIA-A100-SXM4-40GB")]),
    "one_card": ("one_card", [
        ("inventory", "card-node"), ("health", "card-node", True),
        ("reserve", "GPU-card-0", 0.5, 32 * GIB),
        ("reserve", "GPU-card-0", 0.5, 32 * GIB),
        ("filter", "card-node", "NVIDIA-H100-80GB-HBM3", 0.5, 0),
        ("reclaim", "GPU-card-0", 0.5, 32 * GIB),
        ("filter", "card-node", "NVIDIA-H100-80GB-HBM3", 0.5, 0)]),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_allocator_steps_match(case):
    name, ops = SEQUENCES[case]
    run_twin(name, ops)


@pytest.mark.parametrize("name,seed", [("hetero", 0), ("gpu", 1),
                                       ("slices", 2)])
def test_allocator_random_walk_matches(name, seed):
    """A seeded walk of 300 operations: bindings, health flips, reserves
    and reclaims of fractions and whole chips, fit queries."""
    rng = random.Random(seed)
    nodes = sorted(INVENTORY[name])
    models = sorted({spec[3] for spec in INVENTORY[name].values()}) + [""]
    ops, held = [], []
    for node in nodes:
        ops += [("inventory", node), ("health", node, True)]
    uuids = [f"{INVENTORY[name][n][0]}-{i}" for n in nodes
             for i in range(INVENTORY[name][n][1])]
    for _ in range(300):
        roll = rng.random()
        if roll < 0.3:
            uuid = rng.choice(uuids)
            request = rng.choice([0.1, 0.25, 0.3, 0.5, 1.0])
            memory = rng.choice([0, GIB, 4 * GIB])
            ops.append(("reserve", uuid, request, memory))
            held.append((uuid, request, memory))
        elif roll < 0.5 and held:
            ops.append(("reclaim", *held.pop(rng.randrange(len(held)))))
        elif roll < 0.55:
            ops.append(("health", rng.choice(nodes), rng.random() < 0.7))
        elif roll < 0.9:
            ops.append(("filter", rng.choice(nodes), rng.choice(models),
                        rng.choice([0.2, 0.5, 1.0, 2.0, 4.0]),
                        rng.choice([0, GIB, 20 * GIB])))
        else:
            ops.append(("leaves", rng.choice(nodes), rng.choice(models)))
    run_twin(name, ops)


# ---- topology functions ------------------------------------------------------

def test_distances_match_on_random_inputs():
    rng = random.Random(3)
    segments = ["1", "2", "7", "juno", "apple", "12"]
    for _ in range(500):
        a = [rng.choice(segments) for _ in range(rng.randint(1, 4))]
        b = "/".join(rng.choice(segments) for _ in range(rng.randint(1, 4)))
        assert port_topology.cell_id_distance(a, b) == \
            jax_topology.cell_id_distance(a, b)
        x = tuple(rng.randint(0, 7) for _ in range(rng.randint(1, 3)))
        y = tuple(rng.randint(0, 7) for _ in range(rng.randint(1, 3)))
        torus = rng.choice([None, (8, 8, 8), (4, 0)])
        assert port_topology.ici_distance(x, y, torus) == \
            jax_topology.ici_distance(x, y, torus)
    # tests/test_cell.py's reference cases, on the port
    assert port_topology.cell_id_distance(["ubuntu", "1", "3"], "ubuntu/1/2") == 1
    assert port_topology.cell_id_distance(["juno", "1"], "apple/1") == 100
    assert port_topology.cell_id_distance(["a", "2", "1"], "2/1") == 100
    assert port_topology.ici_distance((0, 0), (3, 0), torus_dims=(4, 4)) == 1


CHIP_BOXES = [
    ([(0, 0, 0), (1, 0, 0), (2, 0, 0)], 3), ([(0, 0), (1, 0), (0, 1), (1, 1)], 4),
    ([(2, 3, 0), (3, 3, 0)], 2), ([(0, 0), (2, 0)], 2),
    ([None, (1, 0, 0)], 2), ([], 0), ([None, None], 2),
    ([(0, 0, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), (1, 0, 0, 1)], 4),
    ([(0, 0), (0, 0)], 2),
]


@pytest.mark.parametrize("coords,n", CHIP_BOXES)
def test_chip_box_matches(coords, n):
    assert port_topology.chip_box(coords, n) == jax_topology.chip_box(coords, n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_slice_keys_match(name):
    _, _, _, _, jax_forest = build(jax_cell, CONFIGS[name])
    _, _, _, _, port_forest = build(port_cell, CONFIGS[name])
    jax_types = frozenset(n for n, t in jax_cell.load_config(
        text=CONFIGS[name]).cell_types.items() if t.is_slice_level)
    port_types = frozenset(n for n, t in port_cell.load_config(
        text=CONFIGS[name]).cell_types.items() if t.is_slice_level)
    assert port_types == jax_types
    jax_keys = [jax_topology.slice_key(c, jax_types)
                for roots in jax_forest.values() for level in roots.values()
                for root in level for c in root.walk()]
    port_keys = [port_topology.slice_key(c, port_types)
                 for roots in port_forest.values() for level in roots.values()
                 for root in level for c in root.walk()]
    assert port_keys == jax_keys


@pytest.mark.parametrize("nodes,kwargs", [
    ([("host-a", "TPU-v4", 4), ("host-b", "TPU-v4", 4),
      ("host-c", "TPU-v5e", 8)], {}),
    ([("gpu-a", "NVIDIA-H100-80GB-HBM3", 8),
      ("gpu-b", "NVIDIA-H100-80GB-HBM3", 8)],
     {"model_priority": {"NVIDIA-H100-80GB-HBM3": 100}}),
    ([("gpu-a", "NVIDIA-H100-80GB-HBM3", 8),
      ("gpu-b", "NVIDIA-H100-80GB-HBM3", 8)], {"cluster_cells": False}),
])
def test_generated_topology_matches(nodes, kwargs):
    assert port_topology.generate_tpu_topology(nodes, **kwargs) == \
        jax_topology.generate_tpu_topology(nodes, **kwargs)
    jax_config = jax_topology.generate_tpu_topology_config(nodes, **kwargs)
    port_config = port_topology.generate_tpu_topology_config(nodes, **kwargs)
    assert as_data(port_config) == as_data(jax_config)


# ---- utils: bitmap, atomic file, net ----------------------------------------

def test_bitmap_random_ops_match():
    rng = random.Random(4)
    twins = (jax_bitmap.Bitmap(), port_bitmap.Bitmap())
    for _ in range(400):
        pos = rng.randint(0, 70)
        op = rng.choice(["mask", "unmask", "find", "is", "count", "clear"])
        if op == "clear" and rng.random() >= 0.1:
            continue
        results = []
        for bm in twins:
            if op == "mask":
                results.append(bm.mask(pos))
            elif op == "unmask":
                results.append(bm.unmask(pos))
            elif op == "find":
                results.append(bm.find_next_and_set())
            elif op == "is":
                results.append(bm.is_masked(pos))
            elif op == "count":
                results.append(bm.count_masked_below(pos))
            else:
                results.append(bm.clear())
        assert results[0] == results[1], op


@pytest.mark.parametrize("length", [1, 4, 8, 512])
def test_rr_bitmap_random_ops_match(length):
    rng = random.Random(length)
    twins = (jax_bitmap.RRBitmap(length), port_bitmap.RRBitmap(length))
    for twin in twins:
        twin.mask(0)  # the port pool's creator masks index 0
    for _ in range(3 * length + 50):
        op = rng.choice(["take", "take", "peek", "free", "has", "is"])
        pos = rng.randrange(length)
        results = []
        for rr in twins:
            if op == "take":
                results.append(rr.find_next_from_current_and_set())
            elif op == "peek":
                results.append(rr.find_next_from_current())
            elif op == "free":
                results.append(rr.unmask(pos))
            elif op == "has":
                results.append(rr.has_free())
            else:
                results.append(rr.is_masked(pos))
        assert results[0] == results[1], op
        assert twins[1].capacity == length


def test_atomic_write_matches(tmp_path):
    for name, module in (("jax", jax_atomicfile), ("port", port_atomicfile)):
        path = tmp_path / name / "cfg"
        module.write_atomic(str(path), "1\nns/pod 1.0 0.5 1024\n")
        assert path.read_text() == "1\nns/pod 1.0 0.5 1024\n"
        assert os.stat(path).st_mode & 0o777 == 0o644
        assert [p.name for p in path.parent.iterdir()] == ["cfg"]
    # a reader never sees a torn file (tests/test_utils.py's hammer)
    path = str(tmp_path / "port" / "cfg")
    stop, torn = threading.Event(), []

    def writer():
        i = 0
        while not stop.is_set():
            port_atomicfile.write_atomic(path, f"{i}\n" + "x" * (i % 512) + "\n")
            i += 1

    thread = threading.Thread(target=writer)
    thread.start()
    try:
        for _ in range(200):
            data = open(path).read()
            if not data.endswith("\n"):
                torn.append(data)
    finally:
        stop.set()
        thread.join()
    assert not torn


def test_wait_listening_matches():
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(4)
    port = server.getsockname()[1]
    try:
        for module in (jax_net, port_net):
            assert module.wait_listening(port, deadline_s=2.0) is None
    finally:
        server.close()
    closed = free_port()
    for module in (jax_net, port_net):
        with pytest.raises(TimeoutError, match=f"nothing listening on "
                           f"127.0.0.1:{closed}"):
            module.wait_listening(closed, deadline_s=0.2)


def test_chip_info_matches():
    fields = [(f.name, f.default) for f in dataclasses.fields(jax_cell.ChipInfo)]
    assert [(f.name, f.default) for f in
            dataclasses.fields(port_cell.ChipInfo)] == fields
