"""Port parity: sequence parallelism over a mesh of ranks (``make_mesh``
over a gang, ``mesh.RankMesh``), one unit a rank, against the port's
one-controller mesh over ``[cpu] * 4`` and the JAX package's sharded step
over four CPU devices, on the CPU at f32 (the shared half:
``tests/torch_rank_mesh_cases.py``).

Four gloo ranks, started once for the file, take three AdamW steps of
the dense model through the ring (contiguous einsum, contiguous hybrid,
zigzag hybrid, windowed einsum), Ulysses, and ``transformer_apply`` on a
batch placed along sp, each at dp=2 x sp=2 and at tp=2 x sp=2.

Every case: losses, step 1's gradients (gathered across the ranks) and
the parameters after three steps equal the one-controller mesh's to the
bit, and every copy of a slice is equal to the bit; one case of each
ring layout, Ulysses and the sequence split also lie within 1e-5 of
JAX's step (JAX's einsum ring stands for the port's hybrid ring, as in
``tests/test_torch_ring.py``).  A control in the same processes, a ring
backward whose dK/dV accumulators do not travel home, is refused by the
gradient check.  Ulysses and the ring at sp=2 over the ranks differ from
attention over a rank's own shard alone (the group's size comes from the
rank line, never from a list's length) and equal attention over the
whole sequence."""

import textwrap

import numpy as np
import pytest

from torch_rank_mesh_cases import (DP_SP, TOL, TP_SP, WINDOW, bits_equal,
                                   case, check_copies, check_jax, run_cases,
                                   worst)

CASES = {
    "ring_dp_sp": case(DP_SP, "ring", jax_ref=True, use_flash=False),
    "ring_tp_sp": case(TP_SP, "ring", use_flash=False),
    "hybrid_dp_sp": case(DP_SP, "ring", use_flash=True),
    "hybrid_tp_sp": case(TP_SP, "ring", use_flash=True),
    "zigzag_dp_sp": case(DP_SP, "ring", jax_ref=True, use_flash=True,
                         layout="zigzag"),
    "zigzag_tp_sp": case(TP_SP, "ring", use_flash=True, layout="zigzag"),
    "windowed_dp_sp": case(DP_SP, "ring", dict(attention_window=WINDOW),
                           True, use_flash=False),
    "windowed_tp_sp": case(TP_SP, "ring", dict(attention_window=WINDOW),
                           use_flash=False),
    "ulysses_dp_sp": case(DP_SP, "ulysses", jax_ref=True),
    "ulysses_tp_sp": case(TP_SP, "ulysses"),
    "seq_split_dp_sp": case(DP_SP, "seq_split", jax_ref=True),
    "seq_split_tp_sp": case(TP_SP, "seq_split"),
}

UNIT_INPUTS = """
    def unit_inputs(position):
        \"\"\"Position ``position``'s input and the weights its outputs
        are summed with.\"\"\"
        x = torch.arange(8.0).reshape(2, 4) + 100 * position
        w = torch.arange(8.0).reshape(2, 4) * (1 + position)
        v = torch.arange(8.0).reshape(4, 2) - 3 * position
        return x, w, v
"""

CONTROL = UNIT_INPUTS + """
    from kubeshare_tpu_torch.ops import ring_attention as ring
    from kubeshare_tpu_torch.ops.attention import attention_reference
    from kubeshare_tpu_torch.ops.ulysses import ulysses_attention_sharded

    # the control: the ring backward's accumulators stay where the loop
    # left them (no shift home)
    shipped = spmd.RankGroup.shift

    def no_home(group, lists, offset=1):
        return lists if offset != 1 else shipped(group, lists, offset)

    spmd.RankGroup.shift = no_home
    record["no_home_grads"] = run("hybrid_dp_sp", 1)[1][2]
    spmd.RankGroup.shift = shipped

    # over sp=2 the ring and Ulysses attend the whole sequence, not a
    # rank's own shard alone
    mesh = make_mesh(MeshSpec(dp=2, tp=1, sp=2), device="cpu")
    q, k, v = (torch.from_numpy(x) for x in inputs["qkv"])
    mine = _shard_slices(q.shape, P("dp", None, "sp", None),
                         mesh)[mesh.position]
    local = attention_reference(q[mine], k[mine], v[mine], causal=True)
    whole = attention_reference(q, k, v, causal=True)[mine]
    attended = {}
    for label, fn in (
            ("ring", lambda: ring.ring_attention_sharded(
                q, k, v, mesh, head_axis=None, use_flash=False)),
            ("hybrid", lambda: ring.ring_attention_sharded(
                q, k, v, mesh, head_axis=None, use_flash=True)),
            ("zigzag", lambda: ring.ring_attention_sharded(
                q, k, v, mesh, head_axis=None, use_flash=True,
                layout="zigzag")),
            ("ulysses", lambda: ulysses_attention_sharded(
                q, k, v, mesh, head_axis=None))):
        [out] = fn().shards
        attended[label] = (float((out - local).abs().max()),
                           float((out - whole).abs().max()))
    record["attended"] = dict(sp=mesh.coords()[2], errors=attended)

    # Units' shift and all-to-all over the sp line, values and gradients
    x, w, v = unit_inputs(mesh.position)
    x.requires_grad_(True)
    units = spmd.Units(mesh, ("dp", "sp"))
    [y] = units.ring_shift([x], ("sp",))
    [z] = units.all_to_all([x], 1, 0, ("sp",))
    ((y * w).sum() + (z * v).sum()).backward()
    record["units"] = [t.detach().numpy() for t in (y, z, x.grad)]
"""




@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(11)
    qkv = [rng.standard_normal((2, 2, 16, 8)).astype(np.float32)
           for _ in range(3)]
    return run_cases(tmp_path_factory.mktemp("rank_mesh_sp"), CASES,
                     CONTROL, qkv)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_equal_the_one_controller_mesh(runs, name):
    ranks, _, single = runs
    for rank in ranks:
        assert rank[name]["losses"] == single[name][0]


@pytest.mark.parametrize("name", list(CASES))
def test_step_one_gradients_equal_the_one_controller_mesh(runs, name):
    ranks, _, single = runs
    assert bits_equal(ranks[0][name]["grads"], single[name][1])


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_after_three_steps_equal_the_one_controller_mesh(runs,
                                                                     name):
    ranks, _, single = runs
    for rank in ranks:
        assert bits_equal(rank[name]["params"], single[name][2])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["jax"]])
def test_one_case_of_each_family_equals_jax(runs, name):
    check_jax(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_every_copy_of_a_slice_is_equal_to_the_bit(runs, name):
    check_copies(runs, name)


def test_a_ring_backward_without_the_shift_home_is_refused(runs):
    ranks, _, single = runs
    assert bits_equal(ranks[0]["hybrid_dp_sp"]["grads"],
                      single["hybrid_dp_sp"][1])
    assert worst(ranks[0]["no_home_grads"], single["hybrid_dp_sp"][1]) \
        > 100 * TOL


def test_units_shift_and_all_to_all_over_ranks_equal_one_controller(runs):
    """``Units.ring_shift`` and ``Units.all_to_all`` over each rank's sp
    line: outputs and the input's gradient (the backward shifts back,
    and mirrors the all-to-all) equal the one-controller collectives' to
    the bit."""
    import torch

    from kubeshare_tpu_torch.parallel import spmd
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    space = {"torch": torch}
    exec(textwrap.dedent(UNIT_INPUTS), space)
    mesh = make_mesh(MeshSpec(dp=2, tp=1, sp=2),
                     devices=[torch.device("cpu")] * 4)
    inputs = [space["unit_inputs"](p) for p in range(4)]
    xs = [x.requires_grad_(True) for x, _, _ in inputs]
    units = spmd.Units(mesh, ("dp", "sp"))
    ys = units.ring_shift(xs, ("sp",))
    zs = units.all_to_all(xs, 1, 0, ("sp",))
    sum((y * w).sum() + (z * v).sum()
        for y, z, (_, w, v) in zip(ys, zs, inputs)).backward()
    ranks, _, _ = runs
    for p, rank in enumerate(ranks):
        want = [t.detach().numpy() for t in (ys[p], zs[p], xs[p].grad)]
        assert bits_equal(rank["units"], want), p


@pytest.mark.parametrize("label", ["ring", "hybrid", "zigzag", "ulysses"])
def test_sp_over_ranks_attends_the_whole_sequence(runs, label):
    ranks, _, _ = runs
    for rank in ranks:
        sp, errors = rank["attended"]["sp"], rank["attended"]["errors"]
        off_local, off_whole = errors[label]
        assert off_whole <= TOL, (label, sp)
        if sp == 1:
            # the later shard's rows see the earlier shard's keys
            assert off_local > 1e-2, (label, off_local)
