"""Port parity: MoE layers over a mesh of ranks (``make_mesh`` over a
gang, ``mesh.RankMesh``), one unit a rank, against the port's
one-controller mesh over ``[cpu] * 4`` and the JAX package's sharded step
over four CPU devices, on the CPU at f32 (the shared half:
``tests/torch_rank_mesh_cases.py``).

Four gloo ranks, started once for the file, take three AdamW steps of
MoE transformers (every 2nd MLP 4 experts, top-2, loss cross entropy +
0.01 aux): at dp=2 x tp=2 (experts over tp) and dp=2 x ep=2 (experts
over ep, ``moe_sharding_rules("ep")``'s placement), tokens-choose by
scatter and by einsum, and experts-choose; and the local-MoE ring entry
(each sequence shard routes its own tokens, the aux averaged over sp,
then dp) at dp=2 x sp=2 and tp=2 x sp=2.

Every case: losses, step 1's gradients (gathered across the ranks) and
the parameters after three steps equal the one-controller mesh's to the
bit (every rank routes the whole batch, each router copy takes its own
gates' gradient and the aux is differentiated on the lead rank alone),
and every copy of a slice is equal to the bit; tokens-choose,
experts-choose and the local-MoE entry also lie within 1e-5 of JAX's
step.  A control in the same processes, the aux differentiated on every
rank, is refused by the gradient check."""

import pytest

from torch_rank_mesh_cases import (DP_EP, DP_SP, DP_TP, MOE, TOL, TP_SP,
                                   bits_equal, case, check_copies, check_jax,
                                   run_cases, worst)

CASES = {
    "moe_tp_scatter": case(DP_TP, "with_aux", MOE, True),
    "moe_tp_einsum": case(DP_TP, "with_aux", dict(MOE,
                                                  moe_dispatch="einsum")),
    "moe_tp_experts": case(DP_TP, "with_aux", dict(
        MOE, moe_routing="experts_choose"), True),
    "moe_ep_scatter": case(DP_EP, "with_aux", MOE, rules="ep"),
    "moe_ep_einsum": case(DP_EP, "with_aux", dict(MOE,
                                                  moe_dispatch="einsum"),
                          rules="ep"),
    "moe_ep_experts": case(DP_EP, "with_aux", dict(
        MOE, moe_routing="experts_choose"), rules="ep"),
    "local_moe_dp_sp": case(DP_SP, "ring_aux", MOE, True, use_flash=False),
    "local_moe_tp_sp": case(TP_SP, "ring_aux", MOE, use_flash=False),
}

CONTROL = """
    # the control: every rank differentiates the routed batch's aux
    lead = spmd.Units.lead
    spmd.Units.lead = property(lambda self: True)
    record["aux_everywhere_grads"] = run("moe_tp_scatter", 1)[1][2]
    spmd.Units.lead = lead
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("rank_mesh_moe"), CASES,
                     CONTROL)


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


def test_an_aux_differentiated_on_every_rank_is_refused(runs):
    ranks, _, single = runs
    assert bits_equal(ranks[0]["moe_tp_scatter"]["grads"],
                      single["moe_tp_scatter"][1])
    assert worst(ranks[0]["aux_everywhere_grads"],
                 single["moe_tp_scatter"][1]) > 100 * TOL
