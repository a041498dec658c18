"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one. The
file imports no jax, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances: f32 inputs 1e-5 absolute on unit-scale outputs (summation order
only); bf16 inputs go through the same f32 arithmetic in both versions, so
they get the same bound (kernel A) or one bf16 rounding of the output
(kernel B, 1e-2 relative).
"""

import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_torch.ops.fused_attention import (
    selsa_fused_attention_2slab_hm as attention,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
    roi_align,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, n, nb, m1, m2, dtype, seed=0, masked=0.3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: (torch.randn(*s, generator=g) * 0.5).to(dev)  # noqa: E731
    q = r(n, nb, 64).to(dtype)
    k1, v1 = r(nb, m1, 64).to(dtype), r(nb, m1, 64).to(dtype)
    k2, v2 = r(nb, m2, 64).to(dtype), r(nb, m2, 64).to(dtype)
    b1 = torch.where(torch.rand(m1, generator=g) < masked, -1e30, 0.0).to(dev)
    b2 = torch.where(torch.rand(m2, generator=g) < masked, -1e30, 0.0).to(dev)
    return q, k1, v1, k2, v2, b1, b2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nb,m1,m2", [(300, 16, 4200, 300), (7, 2, 5, 3),
                                        (33, 4, 0, 17), (40, 3, 61, 0)])
def test_attention_kernel_matches_plain(dev, dtype, n, nb, m1, m2):
    args = _attn_inputs(dev, n, nb, m1, m2, dtype)
    before = attention.launches
    got = attention(*args)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention(*args, impl="plain")
    assert got.dtype == torch.float32 and got.shape == (n, nb, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_attention_all_masked_is_mean_of_v(dev):
    args = list(_attn_inputs(dev, 20, 2, 50, 10, torch.float32, masked=1.0))
    got = attention(*args)
    mean_v = torch.cat([args[2], args[4]], 1).mean(1)  # [nb, 64]
    torch.testing.assert_close(got, mean_v[None].expand_as(got), rtol=0,
                               atol=1e-5)


def test_attention_rejects_bad_input(dev):
    q, k1, v1, k2, v2, b1, b2 = _attn_inputs(dev, 8, 2, 16, 4, torch.float32)
    with pytest.raises(ValueError):
        attention(q[..., :32].contiguous(), k1[..., :32].contiguous(),
                  v1[..., :32].contiguous(), k2[..., :32].contiguous(),
                  v2[..., :32].contiguous(), b1, b2)
    with pytest.raises(ValueError):
        attention(q.transpose(0, 1).contiguous().transpose(0, 1), k1, v1, k2,
                  v2, b1, b2)
    with pytest.raises(TypeError):
        attention(q, k1, v1, k2.bfloat16(), v2.bfloat16(), b1, b2)


def _rois(dev, n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-60, w * 16, n)
    y1 = rng.uniform(-60, h * 16, n)
    r = np.stack([x1, y1, x1 + rng.uniform(0, 300, n),
                  y1 + rng.uniform(0, 300, n)], 1)
    r[0] = [-200, -200, -100, -120]   # fully outside
    r[1] = [-30, -20, 60, 70]         # partly outside
    r[2] = [50, 40, 50, 40]           # zero area
    r[3] = [0, 0, w * 16, h * 16]     # whole map
    return torch.as_tensor(r, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_roi_align_kernel_matches_plain(dev, dtype, tol):
    g = torch.Generator(device="cpu").manual_seed(1)
    feat = torch.randn(38, 64, 512, generator=g).to(dev, dtype)
    rois = _rois(dev, 300, 38, 64)
    before = roi_align.launches
    got = roi_align(feat, rois, 1 / 16)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    want = roi_align(feat, rois, 1 / 16, impl="plain")
    assert got.dtype == dtype and got.shape == (300, 7, 7, 512)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert got[0].abs().max().item() == 0.0


def test_roi_align_batched_kernel_matches_plain(dev):
    g = torch.Generator(device="cpu").manual_seed(2)
    feats = torch.randn(5, 20, 30, 40, generator=g).to(dev)
    rois = _rois(dev, 200, 20, 30, seed=3)
    binds = torch.randint(0, 5, (200,), generator=g).to(dev)
    got = roi_align(feats, rois, 1 / 16, batch_inds=binds)
    want = roi_align(feats, rois, 1 / 16, batch_inds=binds, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_small_stream_kernel_path_matches_plain(dev):
    """A small f32 SELSA stream: the kernel path and the plain path give the
    same head outputs on the same memo and frame."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S,
    )

    cfg = S.SelsaConfig(pad_h=128, pad_w=128, neck_channels=32, num_classes=4,
                        num_ref_frames=2, test_nms_pre=200, test_nms_post=16,
                        det_nms_pre=64, compute_dtype=torch.float32)
    model = S.SelsaDetector(cfg)
    S.init_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    anchors = S.make_anchors(cfg, dev)
    g = torch.Generator(device="cpu").manual_seed(4)
    frames = torch.randn(3, 128, 128, 3, generator=g).to(dev)
    shape = torch.tensor([128.0, 128.0], device=dev)
    state = S.init_video_state(model, frames[:2], shape, anchors)
    got = S.stream_head(model, state, frames[2], shape, anchors)
    want = S.stream_head(model, state, frames[2], shape, anchors, impl="plain")
    torch.testing.assert_close(got.proposals.boxes, want.proposals.boxes)
    torch.testing.assert_close(got.cls_score, want.cls_score, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.bbox_pred, want.bbox_pred, rtol=1e-4,
                               atol=1e-4)
