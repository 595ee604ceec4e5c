"""gmf_tpu_torch.nn (fusion, image encoder) vs gmf_tpu.nn with bridged
weights (CPU, f32).

Tolerance 1e-4 relative to the output's scale: LayerNorm variance and
conv/matmul summation orders differ between XLA:CPU and ATen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmf_tpu.nn.fusion import FusionLayer as JaxFusionLayer
from gmf_tpu.nn.resnet import ImageEncoder as JaxImageEncoder
from gmf_tpu_torch.nn.fusion import FusionLayer
from gmf_tpu_torch.nn.resnet import ImageEncoder
from gmf_tpu_torch.utils.bridge import (fusion_layer_to_state_dict,
                                        image_encoder_to_state_dict)

torch.set_num_threads(1)
RTOL = 1e-4


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=RTOL * np.abs(ref).max())


def _perturb(tree, rng, scale=0.5):
    """Non-trivial values for every leaf (BN stats, LN scales, biases)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.rand(*np.shape(a)).astype(
            np.float32), tree)


@pytest.mark.parametrize("pe", [False, True])
def test_fusion_layer(rng, pe):
    C, Nq, Nk = 32, 37, 20
    x = rng.randn(2, Nq, C).astype(np.float32)
    data = rng.randn(2, Nk, C).astype(np.float32)
    jm = JaxFusionLayer(dim=C, latent_dim=C, depth=0, cross_heads=1,
                        cross_dim_head=C // 2, pe=pe)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(data),
                              queries_encoder=jnp.asarray(x))["params"], rng)
    ref = jm.apply({"params": params}, jnp.asarray(data),
                   queries_encoder=jnp.asarray(x))

    tm = FusionLayer(dim=C, latent_dim=C, cross_heads=1,
                     cross_dim_head=C // 2, pe=pe)
    tm.load_state_dict(fusion_layer_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(data), queries_encoder=torch.tensor(x))
    _close(got.numpy(), ref)


def test_image_encoder_tokens(rng):
    img = rng.rand(2, 24, 32, 3).astype(np.float32)
    jm = JaxImageEncoder(base_width=8)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(img),
                method=JaxImageEncoder.tokens)
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), stats)
    # running variances stay positive
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: np.abs(a) + 0.5 if p[-1].key == "var" else a, stats)
    params = _perturb(v["params"], rng, scale=0.05)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(img), method=JaxImageEncoder.tokens)
    assert ref.shape == (2, 3 * 4, 16)

    tm = ImageEncoder(base_width=8).eval()
    tm.load_state_dict(image_encoder_to_state_dict(params, stats),
                       strict=True)
    with torch.no_grad():
        got = tm.tokens(torch.tensor(img))
    _close(got.numpy(), ref)
