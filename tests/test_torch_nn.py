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
from gmf_tpu_torch.utils import bridge
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


@pytest.mark.parametrize("pe,masked", [(False, False), (True, True)])
def test_fusion_layer_depth(rng, pe, masked):
    """FusionLayer(depth=2) with multi-head self-attention, and a key
    mask on the cross-attention, through the bridge (1e-4 of the largest
    output, as above)."""
    C, L, Nq, Nk = 16, 24, 29, 12
    x = rng.randn(2, Nq, L).astype(np.float32)
    data = rng.randn(2, Nk, C).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, Nk), np.float32)
        mask[1, 7:] = 0.0
    kw = dict(dim=C, latent_dim=L, depth=2, cross_heads=2, latent_heads=4,
              cross_dim_head=8, latent_dim_head=6, pe=pe,
              out_to_context_dim=False)
    jm = JaxFusionLayer(**kw)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(data),
                              queries_encoder=jnp.asarray(x))["params"], rng)
    assert "self_attn_1" in params and "self_ff_norm_1" in params
    ref = jm.apply({"params": params}, jnp.asarray(data),
                   queries_encoder=jnp.asarray(x),
                   mask=None if mask is None else jnp.asarray(mask))
    tm = FusionLayer(**kw)
    tm.load_state_dict(fusion_layer_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(data), queries_encoder=torch.tensor(x),
                 mask=None if mask is None else torch.tensor(mask))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("part", ["gelu_exact", "feed_forward_mult",
                                  "conv_pos_enc_k"])
def test_fusion_parts(rng, part):
    """gelu_exact, FeedForward(mult=) and ConvPosEnc(k=) against
    gmf_tpu's (1e-4 of the largest output; gelu to 1e-6)."""
    from gmf_tpu.nn import fusion as jfusion
    from gmf_tpu_torch.nn import fusion

    x = rng.randn(2, 11, 8).astype(np.float32)
    if part == "gelu_exact":
        np.testing.assert_allclose(fusion.gelu_exact(torch.tensor(x)),
                                   np.asarray(jfusion.gelu_exact(x)),
                                   atol=1e-6)
        return
    if part == "feed_forward_mult":
        jm = jfusion.FeedForward(dim=8, mult=2)
        p = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))[
            "params"], rng)
        ref = jm.apply({"params": p}, jnp.asarray(x))
        tm = fusion.FeedForward(8, mult=2)
        sd = {}
        bridge._dense(sd, "net.0", p["proj_in"])
        bridge._dense(sd, "net.2", p["proj_out"])
        tm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tm(torch.tensor(x))
        _close(got.numpy(), ref)
        return
    c = rng.randn(2, 9, 5).astype(np.float32)
    for k in (3, 4, 5):
        jm = jfusion.ConvPosEnc(dim_q=8, dim_content=5, k=k)
        p = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                             jnp.asarray(c))["params"], rng)
        ref = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(c))
        tm = fusion.ConvPosEnc(8, 5, k=k)
        sd = {}
        bridge._depthwise_conv1d(sd, "proj_q", p["proj_q"])
        bridge._depthwise_conv1d(sd, "proj_content", p["proj_content"])
        tm.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = tm(torch.tensor(x), torch.tensor(c))
        for a, b in zip(got, ref):
            _close(a.numpy(), b)


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


def test_token_batch_norm_train_stats_match_flax(rng):
    """One train-mode call of TokenBatchNorm leaves the running statistics
    flax's nn.BatchNorm(momentum=0.9) leaves: the biased batch variance,
    0.9 old + 0.1 new (PyTorch's own update keeps the unbiased variance,
    n / (n - 1) larger: 1.008 at these 128 rows). Same outputs too."""
    import flax.linen as fnn

    from gmf_tpu_torch.models.pointdsc import TokenBatchNorm

    x = (2.0 + 3.0 * rng.randn(2, 64, 16)).astype(np.float32)
    mean0 = rng.randn(16).astype(np.float32)
    var0 = (0.5 + rng.rand(16)).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": v["params"],
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    ref, new = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])

    tm = TokenBatchNorm(16, eps=1e-5)
    with torch.no_grad():
        tm.running_mean.copy_(torch.tensor(mean0))
        tm.running_var.copy_(torch.tensor(var0))
    tm.train()
    got = tm(torch.tensor(x))
    np.testing.assert_allclose(tm.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               atol=1e-6)
    _close(got.detach().numpy(), ref)


def test_image_encoder_train_stats_match_flax(rng):
    """Two train-mode calls of the image encoder (the p and q images, as
    the model makes them) update every batch norm of the trunk as flax
    does. PyTorch's unbiased update would be 1/(n - 1) too large: 1e-2 at
    layer1's 96 rows, 4e-2 at layer2's 3 x 4 map. Limit 5e-5 of the
    statistic's scale: the convolutions sum in another order (1e-6
    relative), and flax takes the variance as E[x^2] - E[x]^2, which
    cancels where a channel's mean is large against its spread (measured
    1.3e-5)."""
    imgs = [rng.rand(2, 24, 32, 3).astype(np.float32) for _ in range(2)]
    jm = JaxImageEncoder(base_width=8)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(imgs[0]))
    v = {"params": _perturb(v["params"], rng),
         "batch_stats": _perturb(v["batch_stats"], rng)}
    tm = ImageEncoder(base_width=8)
    tm.load_state_dict(image_encoder_to_state_dict(v["params"],
                                                   v["batch_stats"]),
                       strict=True)
    tm.train()
    for img in imgs:
        ref, new = jm.apply(v, jnp.asarray(img), train=True,
                            mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": new["batch_stats"]}
        got = tm(torch.tensor(img))
        _close(got.detach().numpy(), ref)
    want = image_encoder_to_state_dict(v["params"], v["batch_stats"])
    have = tm.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 16
    for key in keys:
        ref = want[key].numpy()
        np.testing.assert_allclose(have[key].numpy(), ref,
                                   atol=5e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=key)
