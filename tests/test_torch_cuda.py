"""The port's CUDA kernels vs their plain versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and
skips without one. The file imports neither JAX nor gmf_tpu, so on a
machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gmf_tpu_torch.data.synthetic import make_correspondence_problem
from gmf_tpu_torch.eval.registration import PointDSCRegistrar
from gmf_tpu_torch.models import PointDSC
from gmf_tpu_torch.ops import _build
from gmf_tpu_torch.ops.fused_attention import (compat_attention_plain,
                                               compat_flash_attention)
from gmf_tpu_torch.ops.fused_nms import nms_local_max, nms_local_max_plain
from gmf_tpu_torch.ops.fused_scoring import (seed_hypothesis_counts,
                                             seed_hypothesis_counts_plain)
from gmf_tpu_torch.ops.fused_topk import seed_knn_topk, seed_knn_topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.RandomState(5)


def _t(x, dev):
    return torch.tensor(np.asarray(x)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128])
def test_attention_kernel(gen, cuda, dtype, D):
    """N=333 is no multiple of the 64-row blocks. f32: summation order
    only. bf16: both round q*scale and p to bf16 as the TPU kernel does,
    and round the output to bf16, which may land on the neighbouring bf16
    value: 2 ulps at the largest output."""
    B, N = 2, 333
    q, k, v = (_t(gen.randn(B, N, D).astype(np.float32), cuda).to(dtype)
               for _ in range(3))
    src = gen.rand(B, N, 3).astype(np.float32) * 2.5
    tgt = src + 0.02 * gen.randn(B, N, 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 250:] = 0.0
    src, tgt, m = _t(src, cuda), _t(tgt, cuda), _t(mask, cuda)
    before = _build.launches["compat_flash_attention"]
    got = compat_flash_attention(q, k, v, src, tgt, mask=m)
    assert _build.launches["compat_flash_attention"] == before + 1
    ref = compat_attention_plain(q, k, v, src, tgt, mask=m)
    atol = 1e-5
    if dtype == torch.bfloat16:
        ref_max = ref.float().abs().max().item()
        atol = 2 * 2.0 ** (np.floor(np.log2(ref_max)) - 7)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


def test_nms_kernel(gen, cuda):
    pts = _t((gen.rand(2, 1000, 3) * 2).astype(np.float32), cuda)
    sc = _t(gen.rand(2, 1000).astype(np.float32), cuda)
    sc[0, :50] = sc[0, 50:100]  # equal scores never suppress
    torch.testing.assert_close(nms_local_max(pts, sc, 0.1),
                               nms_local_max_plain(pts, sc, 0.1),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case", ["plain", "ties", "exhausted"])
def test_knn_kernel(gen, cuda, case):
    """Indices exact; scores to f32 summation-order error."""
    B, S, N, C, k = 2, 50, 1000, 128, 41
    f = gen.randn(B, N, C).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mask = np.ones((B, N), np.float32)
    if case == "ties":
        f[:, 500:600] = f[:, :100]
    if case == "exhausted":
        mask[0, 30:] = 0.0
    f, m = _t(f, cuda), _t(mask, cuda)
    s = f[:, :S].contiguous()
    got_i, got_v = seed_knn_topk(s, f, k, mask=m)
    ref_i, ref_v = seed_knn_topk_plain(s, f, k, mask=m)
    torch.testing.assert_close(got_i, ref_i, atol=0, rtol=0)
    torch.testing.assert_close(got_v, ref_v, atol=1e-5, rtol=0)


def test_scoring_kernel(gen, cuda):
    B, S, N = 2, 60, 2000
    src = gen.rand(B, N, 3).astype(np.float32) * 3
    T = np.tile(np.eye(4, dtype=np.float32), (B, S, 1, 1))
    T[:, :, :3, 3] = 0.05 * gen.randn(B, S, 3)
    tgt = src + 0.08 * gen.randn(B, N, 3).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[1, 1500:] = 0.0
    args = [_t(x, cuda) for x in (T, src, tgt)]
    m = _t(mask, cuda)
    got = seed_hypothesis_counts(*args, 0.10, mask=m)
    ref = seed_hypothesis_counts_plain(*args, 0.10, mask=m)
    # the two residual forms round differently only at the knife edge
    assert (got - ref).abs().max().item() <= 2


def test_small_slice_kernels_vs_plain_on_cpu(cuda):
    """A 2-layer f32 model served on the card (kernels) and on the CPU
    (plain versions), same weights and inputs."""
    kw = dict(num_layers=2, num_channels=32, k=10)
    gpu = PointDSC(device="cuda", **kw)
    cpu = PointDSC(device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prob = make_correspondence_problem(np.random.RandomState(0),
                                       num_corr=400, inlier_ratio=0.5,
                                       image_hw=(32, 32), batch=2)
    samples = [{k: v[b] for k, v in prob.items()} for b in range(2)]
    _build.reset_launches()
    got = PointDSCRegistrar(gpu, buckets=(512,)).register_batch(samples)
    assert min(_build.launches[n] for n in (
        "compat_flash_attention", "nms_local_max", "seed_knn_topk",
        "seed_hypothesis_counts")) >= 1
    ref = PointDSCRegistrar(cpu, buckets=(512,)).register_batch(samples)
    for (tg, lg), (tr, lr) in zip(got, ref):
        np.testing.assert_allclose(tg, tr, atol=1e-3)
        assert (lg == lr).mean() >= 0.99
