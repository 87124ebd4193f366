"""Port parity: kubeshare_tpu_torch.models.resnet against the JAX
package's ResNet on the CPU at f32, on the same weights (converted 1:1
from the JAX tree) and seeded images — the forward at an even size (JAX's
"SAME" pads the stride-2 3 x 3 convolutions by (0, 1) there) and at an
odd one (by (1, 1)), three AdamW steps against JAX's make_train_step; and
MNIST and ResNet under a dp mesh, and a dp x tp mesh (replicated over
tp), against JAX's make_train_step over the same mesh (its 8 host
devices; the port's mesh names the CPU n times)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeshare_tpu.models.mnist import MnistConfig as JaxMnistConfig
from kubeshare_tpu.models.mnist import mnist_apply as jax_mnist_apply
from kubeshare_tpu.models.mnist import mnist_init as jax_mnist_init
from kubeshare_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from kubeshare_tpu.models.resnet import resnet_apply as jax_apply
from kubeshare_tpu.models.resnet import resnet_init as jax_init
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import resnet
from kubeshare_tpu_torch.models.mnist import mnist_apply
from kubeshare_tpu_torch.models.resnet import (ResNetConfig, resnet_apply,
                                               resnet_init)
from kubeshare_tpu_torch.parallel import train as port_train
from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, P, ShardedTensor,
                                               make_mesh)

torch.set_num_threads(1)

# f32 on both sides; the convolutions, group norms and products sum in
# another order: ~5e-7 of the largest logit
LOGITS_RTOL_OF_MAX = 1e-5
# the losses: step 1 within 1e-6 (the forward's round-off); steps 2-3
# also carry the parameters' (below) through the forward: ~2e-6 relative
FIRST_LOSS_RTOL = 1e-6
LOSS_RTOL = 1e-5
# parameters after three AdamW steps (lr 1e-3).  The ResNet steps run
# AdamW with eps 1e-5 in both packages, for tests/test_torch_moe.py's
# reason: Adam's first step lr * g / (|g| + eps) moves a weight whose
# gradient cancels to ~0 by up to lr * dg / eps for a round-off dg.  Group
# norm after every convolution makes such weights common: at optax's
# default eps 1e-8 one conv1 weight of the small model differed by
# 1.56e-5 after three steps
PARAM_ATOL = 1e-5
ADAM_EPS = 1e-5

# two stride-2 transitions (8 -> 16 -> 32 channels)
SMALL = dict(widths=(8, 16, 32), blocks_per_stage=(1, 1, 1), groups=4)
# under a mesh: one transition, to keep JAX's sharded compiles short
MESH_SMALL = dict(widths=(4, 8), blocks_per_stage=(1, 1), groups=2)
MNIST_SMALL = dict(channels1=4, channels2=8, hidden=16)
CPU = torch.device("cpu")


def _configs(**kw):
    return JaxResNetConfig(**kw), ResNetConfig(**kw)


def _images(seed, batch, size=32, channels=3, classes=10):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, channels)).astype(
        np.float32)
    labels = rng.integers(0, classes, (batch,)).astype(np.int32)
    return images, labels


def _flat(tree):
    return dict(port_train.tree_leaves_with_paths(tree))


def _random_params(init, jax_cfg, seed=0):
    """A numpy tree of the JAX init's shapes (traced, not drawn: JAX's
    eager init of even the small model takes seconds on the CPU):
    weights He-normal, and scales and biases off their init's 1 and 0, so
    that a per-channel affine in the wrong channel order shows."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jax_cfg))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            value = 1 + 0.1 * rng.standard_normal(leaf.shape)
        elif name in ("bias", "b"):
            value = 0.1 * rng.standard_normal(leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[:-1]))
            value = rng.standard_normal(leaf.shape) * (2.0 / fan_in) ** 0.5
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def small_params():
    return _random_params(jax_init, JaxResNetConfig(**SMALL))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# 32: both transitions over an even size, where SAME pads (0, 1); 13:
# 13 -> 7 -> 4, both over an odd size, where SAME pads (1, 1)
@pytest.mark.parametrize("size", [32, 13])
def test_logits_match_jax(small_params, size):
    jax_cfg, cfg = _configs(**SMALL)
    images, _ = _images(1, 3, size)
    want = np.asarray(jax.jit(lambda p, x: jax_apply(p, x, jax_cfg))(
        small_params, jnp.asarray(images)))
    got = resnet_apply(params_from_jax(small_params, "cpu"),
                       torch.from_numpy(images), cfg)
    assert got.shape == (3, 10) and got.dtype == torch.float32
    assert _max_rel(got.numpy(), want) <= LOGITS_RTOL_OF_MAX

    # PyTorch's symmetric padding=1 agrees over an odd size only
    def symmetric(n, kernel, stride):
        return kernel // 2, kernel // 2

    original = resnet._same_padding
    resnet._same_padding = symmetric
    try:
        shifted = resnet_apply(params_from_jax(small_params, "cpu"),
                               torch.from_numpy(images), cfg).numpy()
    finally:
        resnet._same_padding = original
    if size % 2:
        assert _max_rel(shifted, want) <= LOGITS_RTOL_OF_MAX
    else:
        assert _max_rel(shifted, want) > 100 * LOGITS_RTOL_OF_MAX


@pytest.mark.parametrize("size,kernel,stride,split", [
    (32, 3, 1, (1, 1)),
    (32, 3, 2, (0, 1)),  # (16 - 1) * 2 + 3 - 32 = 1, all of it high
    (32, 1, 2, (0, 0)),  # the projection: -1 -> 0
    (15, 3, 2, (1, 1)),
    (8, 3, 2, (0, 1)),
    (7, 1, 2, (0, 0)),
])
def test_same_padding_is_jax_split(size, kernel, stride, split):
    assert resnet._same_padding(size, kernel, stride) == split
    x = jnp.ones((1, size, size, 1))
    w = jnp.ones((kernel, kernel, 1, 1))
    out = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    low, high = split
    explicit = jax.lax.conv_general_dilated(
        x, w, (stride, stride), [(low, high), (low, high)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(explicit))


def test_init_mirrors_the_jax_tree():
    port = _flat(resnet_init(torch.Generator().manual_seed(0),
                             ResNetConfig(), device="cpu"))
    # the JAX tree's shapes, traced without drawing its 11 M weights
    ref = _flat(jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                                JaxResNetConfig())))
    assert port.keys() == ref.keys()
    for path, leaf in ref.items():
        assert tuple(port[path].shape) == leaf.shape, path
        assert port[path].dtype == torch.float32
        if path[-1] in ("bias", "b"):
            assert not port[path].any(), path
        elif path[-1] == "scale":
            assert bool((port[path] == 1).all()), path
        else:  # He normal convolutions, the head at sqrt(1 / width)
            fan_in = int(np.prod(leaf.shape[:-1]))
            want = (1.0 if path[0] == "head" else 2.0) / fan_in
            std = float(port[path].std())
            assert abs(std / want ** 0.5 - 1) < 0.2, (path, std)
    # a block holds a projection exactly when it downsamples
    stages = resnet_init(torch.Generator().manual_seed(0), ResNetConfig(),
                         device="cpu")["stages"]
    assert [["proj" in b for b in stage] for stage in stages] == \
        [[False, False], [True, False], [True, False], [True, False]]


def test_train_steps_match_jax(small_params):
    jax_cfg, cfg = _configs(**SMALL)
    images, labels = _images(4, 8)
    init_state, step = jax_make_train_step(
        lambda p, x: jax_apply(p, x, jax_cfg),
        optimizer=optax.adamw(1e-3, eps=ADAM_EPS), donate_state=False)
    state = init_state(small_params)
    jax_losses = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        jax_losses.append(float(loss))

    port_init, port_step = port_train.make_train_step(
        lambda p, x: resnet_apply(p, x, cfg),
        optimizer=port_train.adamw(1e-3, eps=ADAM_EPS))
    port_state = port_init(params_from_jax(small_params, "cpu"))
    losses = []
    for _ in range(3):
        port_state, loss = port_step(port_state, torch.from_numpy(images),
                                     torch.from_numpy(labels.astype(np.int64)))
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    got = _flat(port_state.params)
    for path, leaf in _flat(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[path].detach().numpy(), leaf, rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


# ---------------------------------------------------------------------------
# under a mesh
# ---------------------------------------------------------------------------

def _models():
    """name: (JAX apply, port apply, JAX init, image shape, Adam eps)."""
    jax_r, r = _configs(**MESH_SMALL)
    jax_m = JaxMnistConfig(**MNIST_SMALL)
    return {
        "mnist": (jax_mnist_apply, mnist_apply,
                  lambda: _random_params(jax_mnist_init, jax_m, seed=2),
                  dict(size=28, channels=1), 1e-8),
        "resnet": (lambda p, x: jax_apply(p, x, jax_r),
                   lambda p, x: resnet_apply(p, x, r),
                   lambda: _random_params(jax_init, jax_r),
                   dict(size=16, channels=3), ADAM_EPS),
    }


def _meshes(**axes):
    spec = {"sp": 1, **axes}
    n = int(np.prod(list(spec.values())))
    return (jax_mesh.make_mesh(jax_mesh.MeshSpec(**spec),
                               devices=jax.devices()[:n]),
            make_mesh(MeshSpec(**spec), devices=[CPU] * n))


@pytest.mark.parametrize("name", ["mnist", "resnet"])
@pytest.mark.parametrize("axes", [dict(dp=2), dict(dp=2, tp=2)],
                         ids=["dp2", "dp2_tp2"])
def test_mesh_training_equals_jax(name, axes):
    jax_fn, port_fn, init, shape, eps = _models()[name]
    jmesh, mesh = _meshes(**axes)
    params = init()
    images, labels = _images(6, 8, **shape)

    init_state, step = jax_make_train_step(
        jax_fn, mesh=jmesh, param_rules={},
        optimizer=optax.adamw(1e-3, eps=eps), donate_state=False)
    state = init_state(params)
    place = jax_mesh.batch_sharding(jmesh, ndim=1)
    x = jax.device_put(jnp.asarray(images),
                       jax_mesh.batch_sharding(jmesh, ndim=4))
    y = jax.device_put(jnp.asarray(labels), place)
    jax_losses = []
    for _ in range(3):
        state, loss = step(state, x, y)
        jax_losses.append(float(loss))

    port_init, port_step = port_train.make_train_step(
        port_fn, mesh=mesh, param_rules={},
        optimizer=port_train.adamw(1e-3, eps=eps))
    port_state = port_init(params_from_jax(params, "cpu"))
    losses = []
    for _ in range(3):
        port_state, loss = port_step(port_state, torch.from_numpy(images),
                                     torch.from_numpy(labels.astype(np.int64)))
        losses.append(float(loss))
        for path, leaf in port_train.tree_leaves_with_paths(port_state.params):
            for shard in leaf.shards[1:]:  # replicated: every copy equal
                assert torch.equal(shard, leaf.shards[0]), path
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    got = {path: leaf.gather().detach().numpy() for path, leaf in
           port_train.tree_leaves_with_paths(port_state.params)}
    for path, leaf in _flat(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["mnist", "resnet"])
def test_mesh_forward_splits_the_logits_by_batch(name):
    _, port_fn, init, shape, _ = _models()[name]
    _, mesh = _meshes(dp=2, tp=2)
    params = params_from_jax(init(), "cpu")
    images, _ = _images(7, 4, **shape)
    whole = port_fn(params, torch.from_numpy(images))
    init_state, _ = port_train.make_train_step(port_fn, mesh=mesh,
                                               param_rules={})
    placed = init_state(params).params
    with torch.no_grad():
        logits = port_fn(placed, torch.from_numpy(images))
    assert isinstance(logits, ShardedTensor)
    assert logits.spec == P("dp") and tuple(logits.shape) == (4, 10)
    # the dp units compute their rows; tp replicates them
    assert logits.copies == [[0, 1], [2, 3]]
    np.testing.assert_allclose(logits.gather().numpy(),
                               whole.detach().numpy(), rtol=0, atol=1e-6)
