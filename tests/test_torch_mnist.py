"""Port parity: kubeshare_tpu_torch.models.mnist against the JAX package's
MNIST on the CPU at f32, on the same weights (converted 1:1 from the JAX
tree) and seeded images; and three eager train steps of the port against
JAX's make_train_step with optax.adamw(1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.mnist import MnistConfig as JaxMnistConfig
from kubeshare_tpu.models.mnist import mnist_apply as jax_apply
from kubeshare_tpu.models.mnist import mnist_init as jax_init
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.mnist import MnistConfig, mnist_apply, mnist_init
from kubeshare_tpu_torch.parallel import train as port_train

torch.set_num_threads(1)

# f32 on both sides: the convolutions and products sum in another order,
# ~1e-7 of logits of a few units
LOGITS_ATOL = 1e-5
LOSS_RTOL = 1e-5
# the bound tests/test_torch_train.py justifies for three AdamW steps
PARAM_ATOL = 5e-6

SMALL = dict(channels1=4, channels2=8, hidden=16)


def _images(seed, batch, size=28):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (batch,)).astype(np.int32)
    return images, labels


def _flat(tree):
    return dict(port_train.tree_leaves_with_paths(tree))


@pytest.mark.parametrize("config,batch", [
    ({}, 3),
    (SMALL, 5),
    (dict(SMALL, image_size=12, num_classes=7), 2),
], ids=["default", "narrow", "image12"])
def test_logits_match_jax(config, batch):
    jax_cfg = JaxMnistConfig(**config)
    params = jax.device_get(jax_init(jax.random.PRNGKey(3), jax_cfg))
    images, _ = _images(1, batch, jax_cfg.image_size)
    want = np.asarray(jax_apply(params, jnp.asarray(images)))
    got = mnist_apply(params_from_jax(params, device="cpu"),
                      torch.from_numpy(images))
    assert got.shape == (batch, jax_cfg.num_classes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_ATOL)


def test_flatten_is_nhwc():
    # a dense1 that reads a single (row, column, channel) position tells
    # an NHWC flatten from an NCHW one
    jax_cfg = JaxMnistConfig(**SMALL)
    params = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
    w = np.zeros_like(params["dense1"]["w"])
    w[(2 * 7 + 5) * SMALL["channels2"] + 3, 0] = 1.0  # row 2, column 5, channel 3
    params["dense1"]["w"] = w
    images, _ = _images(2, 2)
    want = np.asarray(jax_apply(params, jnp.asarray(images)))
    got = mnist_apply(params_from_jax(params, device="cpu"),
                      torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)


def test_init_mirrors_the_jax_tree():
    config = MnistConfig()
    port = _flat(mnist_init(torch.Generator().manual_seed(0), config,
                            device="cpu"))
    ref = _flat(jax.device_get(jax_init(jax.random.PRNGKey(0),
                                        JaxMnistConfig())))
    assert port.keys() == ref.keys()
    for path, leaf in ref.items():
        assert tuple(port[path].shape) == leaf.shape, path
        assert port[path].dtype == torch.float32
        if path[-1] == "b":
            assert not port[path].any()
        else:  # He normal: std sqrt(2 / fan_in)
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = float(port[path].std())
            assert abs(std / (2.0 / fan_in) ** 0.5 - 1) < 0.2, (path, std)


def test_train_steps_match_jax():
    jax_cfg = JaxMnistConfig(**SMALL)
    params = jax_init(jax.random.PRNGKey(5), jax_cfg)
    images, labels = _images(4, 8)
    init_state, step = jax_make_train_step(jax_apply, donate_state=False)
    state = init_state(params)
    jax_losses = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(labels))
        jax_losses.append(float(loss))

    port_init, port_step = port_train.make_train_step(mnist_apply)
    port_state = port_init(params_from_jax(jax.device_get(params),
                                           device="cpu"))
    losses = []
    for _ in range(3):
        port_state, loss = port_step(port_state, torch.from_numpy(images),
                                     torch.from_numpy(labels))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    got = _flat(port_state.params)
    for path, leaf in _flat(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[path].detach().numpy(), leaf, rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))


def test_captured_step_refuses_the_cpu():
    init_state, _ = port_train.make_train_step(mnist_apply, capture=True)
    params = mnist_init(torch.Generator().manual_seed(0), MnistConfig(**SMALL),
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(params)
