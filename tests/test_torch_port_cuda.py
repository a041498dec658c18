"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one. The
file imports no jax, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

Tolerances: f32 inputs 1e-5 absolute on unit-scale outputs (summation order
only); bf16 inputs go through the same f32 arithmetic in both versions, so
they get the same bound (kernel A) or one bf16 rounding of the output
(kernel B, 1e-2 relative and absolute). Kernels A and C in bf16 take the
tensor-core (``mma``) body: exact bf16 products summed in f32, and P split
into two bf16 parts (about 16 bits), so they keep the 1e-5 bound. Kernel
B's cases count the launches of its gather bodies (``gather7x2``,
``gather14x2``, and ``gather28x2``, the mask targets' scalar body on
1-channel f32 masks: 1e-5). Kernel D (RoIAlign's backward, bodies ``scatter7x2`` and
``scatter14x2``) is held against torch autograd through the plain version
in f32, cast to the feature dtype, and against its explicit plain version
``roi_align_backward_plain`` (the same separable sums in f32, cast): f32 to
1e-5 of the largest |grad| (the order of the atomic adds changes from run
to run), bf16 within one bf16 rounding (rtol 2^-7) plus that atol.
DCNv2's kernels E (the im2col, ``deform_columns``), F (the input's gradient,
``deform_col2im``) and G (the offsets' and the mask's, ``deform_col2im_coord``)
are held against ``deform_columns_plain`` (the same roundings: exact but for
the sign of a zero), the whole forward against
``modulated_deform_conv_plain`` and F and G against
``modulated_deform_conv_backward_plain`` and torch autograd through the
plain version: f32 to 1e-5 of the largest |value| (F's atomic order varies),
x's bf16 gradient within one bf16 rounding plus that atol.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.ops import (
    deform_conv as dcn,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.fused_attention import (
    selsa_fused_attention_2slab_hm as attention,
    selsa_fused_attention_hm as attention1,
)
from lowlightenvironmentvideoobjectdetection_torch.ops.roi_align import (
    roi_align,
    roi_align_backward,
    roi_align_backward_plain,
)

pytestmark = pytest.mark.cuda


_pinned_threads = thread_count(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, n, nb, m1, m2, dtype, seed=0, masked=0.3, lead=()):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: (torch.randn(*lead, *s, generator=g) * 0.5).to(dev)  # noqa
    q = r(n, nb, 64).to(dtype)
    k1, v1 = r(nb, m1, 64).to(dtype), r(nb, m1, 64).to(dtype)
    k2, v2 = r(nb, m2, 64).to(dtype), r(nb, m2, 64).to(dtype)
    b1 = torch.where(torch.rand(*lead, m1, generator=g) < masked, -1e30,
                     0.0).to(dev)
    b2 = torch.where(torch.rand(*lead, m2, generator=g) < masked, -1e30,
                     0.0).to(dev)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,n,nb,m1,m2", [(1, 300, 16, 4200, 300),
                                          (4, 300, 16, 4200, 300),
                                          (3, 7, 2, 5, 3), (3, 33, 4, 0, 17),
                                          (2, 40, 3, 61, 0)])
def test_stream_batched_attention_matches_plain(dev, dtype, s, n, nb, m1, m2):
    args = _attn_inputs(dev, n, nb, m1, m2, dtype, lead=(s,))
    before = attention.launches
    got = attention(*args)
    torch.cuda.synchronize()
    assert attention.launches == before + 1  # one launch for all streams
    want = attention(*args, impl="plain")
    assert got.shape == (s, n, nb, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    one = attention(*(a[s - 1] for a in args))  # the last stream alone
    torch.testing.assert_close(got[s - 1], one, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,n,nb,m1,m2", [((), 300, 16, 4200, 300),
                                             ((), 7, 2, 5, 3),
                                             ((3,), 33, 4, 20, 17)])
def test_one_slab_kernel_matches_plain_and_two_slab(dev, dtype, lead, n, nb,
                                                    m1, m2):
    q, k1, v1, k2, v2, b1, b2 = _attn_inputs(dev, n, nb, m1, m2, dtype,
                                             lead=lead)
    k, v = torch.cat([k1, k2], -2), torch.cat([v1, v2], -2)
    b = torch.cat([b1, b2], -1)
    before = attention1.launches
    got = attention1(q, k, v, b)
    torch.cuda.synchronize()
    assert attention1.launches == before + 1
    torch.testing.assert_close(got, attention1(q, k, v, b, impl="plain"),
                               rtol=0, atol=1e-5)
    # the same keys split in two slabs walk the same tiles in kernel A
    torch.testing.assert_close(got, attention(q, k1, v1, k2, v2, b1, b2),
                               rtol=0, atol=1e-5)


def test_one_slab_all_masked_is_mean_of_v(dev):
    q, k, v, _, _, b, _ = _attn_inputs(dev, 20, 2, 50, 0, torch.float32,
                                       masked=1.0)
    got = attention1(q, k, v, b)
    torch.testing.assert_close(got, v.mean(1)[None].expand_as(got), rtol=0,
                               atol=1e-5)


_MMA_CASES = (
    [("random", n, m1, m2, s) for s in (1, 4)
     for m1, m2 in ((0, 17), (63, 1), (64, 0), (65, 300), (4200, 300))
     for n in (1, 15, 17, 64, 65, 300)]
    + [("masked_tiles", 300, 4200, 300, 1), ("masked_tiles", 65, 700, 20, 4),
       ("all_masked", 300, 4200, 300, 1), ("all_masked", 17, 63, 1, 4),
       ("one_hot", 64, 64, 0, 1), ("one_hot", 130, 100, 28, 2)])


def _mma_inputs(dev, kind, n, m1, m2, s):
    """Kernel A's bf16 operands for one case of ``_MMA_CASES``: random
    (30% of keys masked), whole 64-key tiles masked before live keys, every
    key masked, or a one-hot q against identity-like K (query i picks key
    i % 64 with weight 1 - 1e-7), whose answer is known: V's rows."""
    nb = 16 if m1 + m2 == 4500 else 3
    q, k1, v1, k2, v2, b1, b2 = _attn_inputs(
        dev, n, nb, m1, m2, torch.bfloat16, seed=n + m1 + m2 + s,
        masked=1.0 if kind == "all_masked" else 0.3, lead=(s,))
    if kind == "masked_tiles":  # keys [0, 192) and [640, M - 64) masked
        j = torch.arange(m1 + m2, device=dev)
        b = torch.where((j < 192) | ((j >= 640) & (j < m1 + m2 - 64)),
                        -1e30, 0.0).expand(s, -1)
        b1, b2 = b[:, :m1].contiguous(), b[:, m1:].contiguous()
    if kind == "one_hot":  # score 20 on key i % 64 (q = 160 e_i), else 0
        eye = torch.eye(64, device=dev)
        q = (160 * eye[torch.arange(n, device=dev) % 64])[None, :, None]
        q = q.expand(s, n, nb, 64).to(torch.bfloat16).contiguous()
        keys = eye[torch.arange(m1 + m2, device=dev) % 64]
        k = keys[None, None].expand(s, nb, -1, -1).to(torch.bfloat16)
        k1, k2 = k[:, :, :m1].contiguous(), k[:, :, m1:].contiguous()
        b1, b2 = torch.zeros_like(b1), torch.zeros_like(b2)
    return q, k1, v1, k2, v2, b1, b2


@pytest.mark.parametrize("kind,n,m1,m2,s", _MMA_CASES)
def test_mma_body_matches_plain(dev, kind, n, m1, m2, s):
    """Kernel A's tensor-core body in bf16 against the f32 plain version,
    atol 1e-5, with ragged query tiles, slab boundaries inside and at the
    edge of a 64-key tile, masked tiles before live keys and all-masked
    rows; every launch takes the mma body."""
    args = _mma_inputs(dev, kind, n, m1, m2, s)
    before = dict(attention.body_launches)
    got = attention(*args)
    torch.cuda.synchronize()
    assert attention.body_launches["mma"] == before["mma"] + 1
    assert attention.body_launches["fma"] == before["fma"]
    torch.testing.assert_close(got, attention(*args, impl="plain"), rtol=0,
                               atol=1e-5)
    v = torch.cat([args[2], args[4]], -2).float()  # [s, nb, M, 64]
    if kind == "all_masked":
        torch.testing.assert_close(
            got, v.mean(-2)[:, None].expand_as(got), rtol=0, atol=1e-5)
    if kind == "one_hot":
        # query i attends to key i % 64 and its repeats i % 64 + 64r: their
        # mean over V (weight 1 - 63 e^-20 in all)
        m = m1 + m2
        want = torch.stack([v[..., torch.arange(i % 64, m, 64, device=dev),
                              :].mean(-2) for i in range(n)], 1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if s > 1:  # a stream of the batch equals the stream alone
        one = attention(*(a[s - 1] for a in args))
        torch.testing.assert_close(got[s - 1], one, rtol=0, atol=0)


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


def _edge_rois(dev, h, w):
    """Rois whose sample positions fall exactly on the range's edges: in
    map coordinates (stride 16, half-pixel offset) zero-width and zero-height
    rois at -1, 0, size - 1 and size on each axis, and just outside at
    -1.0625 and size + 0.0625 (their samples contribute 0); rois with
    corners at those values; then fully outside, zero area, whole map."""
    img = lambda v: (v + 0.5) * 16  # noqa: E731  map coordinate -> image
    rows = []
    for axis, size in ((0, w), (1, h)):
        for v in (-1.0, 0.0, size - 1.0, float(size), -1.0625, size + 0.0625):
            r = [img(2.0), img(3.0), img(5.5), img(7.25)]
            r[axis] = r[axis + 2] = img(v)
            rows.append(r)
    rows += [[img(-1.0), img(-1.0), img(w), img(h)],
             [img(0.0), img(0.0), img(w - 1.0), img(h - 1.0)],
             [img(-1.0), img(0.0), img(w - 1.0), img(h)],
             [-200.0, -200.0, -100.0, -120.0],   # fully outside
             [50.0, 40.0, 50.0, 40.0],           # zero area
             [0.0, 0.0, w * 16.0, h * 16.0]]     # whole map
    return torch.tensor(rows, dtype=torch.float32, device=dev)


_ROI_TOL = {torch.float32: (0.0, 1e-5),     # summation order only
            torch.bfloat16: (1e-2, 1e-2)}   # one rounding of the output


def _roi_check(feats, rois, binds=None, out_size=7):
    """One kernel-B launch on the body for (out_size, 2), counted once in
    ``launches`` and in that body's ``body_launches``, against the plain
    version at the dtype's tolerance. Returns the kernel's output."""
    body = f"gather{out_size}x2"
    before, bodies = roi_align.launches, dict(roi_align.body_launches)
    got = roi_align(feats, rois, 1 / 16, batch_inds=binds, out_size=out_size)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    assert roi_align.body_launches == {
        k: v + (k == body) for k, v in bodies.items()}
    want = roi_align(feats, rois, 1 / 16, batch_inds=binds, out_size=out_size,
                     impl="plain")
    assert got.dtype == feats.dtype
    assert got.shape == (rois.shape[0], out_size, out_size, feats.shape[-1])
    rtol, atol = _ROI_TOL[feats.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain(dev, dtype):
    """One 38 x 64 x 512 map and 300 rois, the single-stream shape."""
    g = torch.Generator(device="cpu").manual_seed(1)
    feat = torch.randn(38, 64, 512, generator=g).to(dev, dtype)
    got = _roi_check(feat, _rois(dev, 300, 38, 64))
    assert got[0].abs().max().item() == 0.0


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 256, 512])
def test_roi_align_batched_kernel_matches_plain(dev, c, dtype, out_size):
    """A batch of maps with per-roi int64 indices, some out of range
    (clamped to [0, B - 1]); int32 indices give the same output."""
    g = torch.Generator(device="cpu").manual_seed(2)
    feats = torch.randn(5, 20, 30, c, generator=g).to(dev, dtype)
    rois = _rois(dev, 200, 20, 30, seed=3)
    binds = torch.randint(0, 5, (200,), generator=g)
    binds[:8] = torch.tensor([-3, -1, 5, 6, 1000, 0, 4, -(2 ** 40)])
    binds = binds.to(dev)
    got = _roi_check(feats, rois, binds, out_size)
    clamped = roi_align(feats, rois, 1 / 16, batch_inds=binds.clamp(0, 4),
                        out_size=out_size)
    torch.testing.assert_close(got, clamped, rtol=0, atol=0)
    small = binds.clamp(-(2 ** 31), 2 ** 31 - 1).to(torch.int32)
    torch.testing.assert_close(
        roi_align(feats, rois, 1 / 16, batch_inds=small, out_size=out_size),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_edge_rois(dev, dtype, out_size):
    """Samples exactly at -1, 0, size - 1 and size, and just beyond; fully
    outside rois give 0, zero-area and whole-map rois match."""
    g = torch.Generator(device="cpu").manual_seed(6)
    feat = torch.randn(20, 30, 64, generator=g).to(dev, dtype)
    rois = _edge_rois(dev, 20, 30)
    got = _roi_check(feat, rois, out_size=out_size)
    for i in (4, 5, 10, 11, 15):  # beyond -1 or size on an axis; outside
        assert got[i].abs().max().item() == 0.0
    for i in (0, 1, 2, 3, 6, 7, 8, 9):  # on the edges: in range
        assert got[i].abs().max().item() > 0.0


def test_roi_align_no_rois_no_launch(dev):
    feats = torch.randn(2, 20, 30, 64, device=dev)
    before, bodies = roi_align.launches, dict(roi_align.body_launches)
    out = roi_align(feats, torch.zeros(0, 4, device=dev), 1 / 16,
                    batch_inds=torch.zeros(0, dtype=torch.int64, device=dev))
    assert out.shape == (0, 7, 7, 64)
    assert roi_align.launches == before
    assert roi_align.body_launches == bodies


def _mask_target_case(dev, kind, g=20, n=256, hw=(96, 160), seed=8):
    """The mask targets' operands: ``g`` box-filled (or random 0/1) masks
    [g, H, W, 1] f32, ``n`` rois about the gts (each corner moved by up to
    20% of its gt's side; the first ones past the map) and their matched
    gt as the map index."""
    rng = np.random.RandomState(seed)
    h, w = hw
    x1 = rng.uniform(-10, w - 20, g)
    y1 = rng.uniform(-10, h - 20, g)
    gts = np.stack([x1, y1, x1 + rng.uniform(4, w / 2, g),
                    y1 + rng.uniform(4, h / 2, g)], 1)
    if kind == "box":
        yy, xx = np.mgrid[:h, :w]
        masks = ((yy >= gts[:, 1, None, None]) & (yy < gts[:, 3, None, None])
                 & (xx >= gts[:, 0, None, None])
                 & (xx < gts[:, 2, None, None]))
    else:
        masks = rng.rand(g, h, w) > 0.5
    matched = rng.randint(0, g, n)
    c = gts[matched]
    side = np.concatenate([c[:, 2:] - c[:, :2]] * 2, 1)
    rois = c + rng.uniform(-0.2, 0.2, (n, 4)) * side
    rois[:4] = [[-40, -30, -5, -2], [w - 8, h - 8, w + 30, h + 20],
                [10, 10, 10, 10], [0, 0, w, h]]
    return (torch.as_tensor(masks[..., None], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(rois, dtype=torch.float32, device=dev),
            torch.as_tensor(matched, device=dev))


@pytest.mark.parametrize("kind", ["box", "random"])
def test_roi_align_mask_target_body(dev, kind):
    """Kernel B's ``gather28x2`` body (scalar loads) on 1-channel f32 masks
    with each roi's matched gt as its map index, scale 1: one launch on
    that body, equal to the plain version to 1e-5; a roi outside the map
    gives 0. The body takes no bf16 maps and has no backward."""
    masks, rois, matched = _mask_target_case(dev, kind)
    before, bodies = roi_align.launches, dict(roi_align.body_launches)
    got = roi_align(masks, rois, 1.0, batch_inds=matched, out_size=28)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    assert roi_align.body_launches == {
        k: v + (k == "gather28x2") for k, v in bodies.items()}
    want = roi_align(masks, rois, 1.0, batch_inds=matched, out_size=28,
                     impl="plain")
    assert got.shape == (rois.shape[0], 28, 28, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert got[0].abs().max().item() == 0.0
    assert got[3].abs().max().item() > 0.0
    with pytest.raises(TypeError):
        roi_align(masks.bfloat16(), rois, 1.0, batch_inds=matched,
                  out_size=28)
    with pytest.raises(ValueError):
        roi_align(masks.requires_grad_(), rois, 1.0, batch_inds=matched,
                  out_size=28)


def test_roi_align_rejects_what_no_body_takes(dev):
    feat = torch.randn(20, 30, 64, device=dev)
    rois = _rois(dev, 10, 20, 30)
    before = roi_align.launches
    with pytest.raises(ValueError):  # no (5, 3) body
        roi_align(feat, rois, 1 / 16, out_size=5, sampling_ratio=3)
    with pytest.raises(ValueError):  # 36 bf16 channels: not 16-byte vectors
        roi_align(feat[..., :36].bfloat16().contiguous(), rois, 1 / 16)
    with pytest.raises(ValueError):  # a map that starts off a 16-byte line
        roi_align(feat.reshape(-1)[1:1 + 20 * 30 * 60].view(20, 30, 60),
                  rois, 1 / 16)
    with pytest.raises(ValueError):  # a batch of maps needs batch_inds
        roi_align(feat.expand(2, -1, -1, -1).contiguous(), rois, 1 / 16)
    with pytest.raises(TypeError):
        roi_align(feat.half(), rois, 1 / 16)
    assert roi_align.launches == before


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


def test_small_batched_serve_step_kernel_path_matches_plain(dev):
    """A small f32 two-stream step: the batched kernel path against the
    batched plain path (one launch of each kernel per stage), then a step
    through ``make_serve_step`` that rolls both memos."""
    from lowlightenvironmentvideoobjectdetection_torch.models.vid import (
        selsa as S,
    )
    from lowlightenvironmentvideoobjectdetection_torch.parallel.serve import (
        make_serve_step,
    )

    cfg = S.SelsaConfig(pad_h=128, pad_w=128, neck_channels=32, num_classes=4,
                        num_ref_frames=2, test_nms_pre=200, test_nms_post=16,
                        det_nms_pre=64, compute_dtype=torch.float32)
    model = S.SelsaDetector(cfg)
    S.init_params(model, torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    anchors = S.make_anchors(cfg, dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    refs = torch.randn(2, 2, 128, 128, 3, generator=g).to(dev)
    frames = torch.randn(2, 128, 128, 3, generator=g).to(dev)
    shapes = torch.tensor([[128.0, 128.0], [100.0, 120.0]], device=dev)
    states = S.stack_video_states([
        S.init_video_state(model, refs[s], shapes[s], anchors)
        for s in range(2)])
    a0, r0 = attention.launches, roi_align.launches
    got = S.stream_head_batch(model, states, frames, shapes, anchors)
    torch.cuda.synchronize()
    assert (attention.launches - a0, roi_align.launches - r0) == (2, 1)
    want = S.stream_head_batch(model, states, frames, shapes, anchors,
                               impl="plain")
    torch.testing.assert_close(got.proposals.boxes, want.proposals.boxes)
    torch.testing.assert_close(got.cls_score, want.cls_score, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.bbox_pred, want.bbox_pred, rtol=1e-4,
                               atol=1e-4)
    step, shard_args = make_serve_step(model, clip=False, update_memo=True)
    states, dets = step(*shard_args(anchors, states, frames, shapes,
                                    torch.ones(2, 4)))
    assert dets.boxes.shape == (2, 100, 4)
    assert states.next_slot.tolist() == [1, 1]
    torch.testing.assert_close(states.ref_kv[1][0][:, :, 0],
                               got.cur_kvs[1][0], rtol=0, atol=1e-6)


def _plain_backward(feats, rois, binds, grad_out, out_size):
    """Torch autograd through the plain version, in f32, cast to the
    feature dtype (autograd in bf16 would sum in bf16)."""
    f = feats.detach().float().clone().requires_grad_()
    out = roi_align(f, rois, 1 / 16, batch_inds=binds, out_size=out_size,
                    impl="plain")
    out.backward(grad_out.float())
    return f.grad.to(feats.dtype)


def _grad_check(feats, rois, binds=None, out_size=7, seed=0):
    """One kernel-D launch on the body for (out_size, 2), counted once,
    against the plain backward (autograd) and the explicit plain version
    ``roi_align_backward_plain`` at the same tolerances; then the same
    gradient through autograd (kernel B forward, kernel D backward, one
    launch each). Returns the kernel's gradient."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n, c = rois.shape[0], feats.shape[-1]
    grad_out = torch.randn(n, out_size, out_size, c, generator=g).to(
        feats.device, feats.dtype)
    body = f"scatter{out_size}x2"
    before = dict(roi_align_backward.body_launches)
    got = roi_align_backward(grad_out, rois, binds, feats.shape, 1 / 16,
                             out_size)
    torch.cuda.synchronize()
    assert roi_align_backward.body_launches == {
        k: v + (k == body and n > 0) for k, v in before.items()}
    want = _plain_backward(feats, rois, binds, grad_out, out_size)
    assert got.dtype == feats.dtype and got.shape == feats.shape
    atol = 1e-5 * max(float(want.float().abs().max()), 1.0)
    rtol = 0.0 if feats.dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    plain = roi_align_backward_plain(grad_out, rois, binds, feats.shape,
                                     1 / 16, out_size)
    assert plain.dtype == feats.dtype and plain.shape == feats.shape
    torch.testing.assert_close(got.float(), plain.float(), rtol=rtol,
                               atol=atol)

    f = feats.detach().clone().requires_grad_()
    b0, d0 = roi_align.launches, roi_align_backward.launches
    roi_align(f, rois, 1 / 16, batch_inds=binds, out_size=out_size
              ).backward(grad_out)
    torch.cuda.synchronize()
    assert (roi_align.launches - b0, roi_align_backward.launches - d0) == (
        (1, 1) if n else (0, 0))
    torch.testing.assert_close(f.grad.float(), want.float(), rtol=rtol,
                               atol=atol)
    return got


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_edge_rois(dev, dtype, out_size):
    """Samples at -1, 0, size - 1 and size, just beyond, fully outside,
    zero-area and whole-map rois; rois outside the map add nothing."""
    g = torch.Generator(device="cpu").manual_seed(7)
    feat = torch.randn(20, 30, 64, generator=g).to(dev, dtype)
    rois = _edge_rois(dev, 20, 30)
    _grad_check(feat, rois, out_size=out_size)
    outside = roi_align_backward(
        torch.ones(1, out_size, out_size, 64, device=dev, dtype=dtype),
        rois[-3:-2], None, feat.shape, 1 / 16, out_size)
    assert outside.abs().max().item() == 0.0


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [40, 256, 512])
def test_roi_align_backward_batched_matches_plain(dev, c, dtype, out_size):
    """A batch of maps with int64 map indices, some out of range (clamped
    to [0, B - 1]); int32 indices give the same gradient."""
    g = torch.Generator(device="cpu").manual_seed(8)
    feats = torch.randn(5, 20, 30, c, generator=g).to(dev, dtype)
    rois = _rois(dev, 200, 20, 30, seed=9)
    binds = torch.randint(0, 5, (200,), generator=g)
    binds[:8] = torch.tensor([-3, -1, 5, 6, 1000, 0, 4, -(2 ** 40)])
    binds = binds.to(dev)
    got = _grad_check(feats, rois, binds, out_size)
    small = binds.clamp(-(2 ** 31), 2 ** 31 - 1).to(torch.int32)
    g32 = roi_align_backward(
        torch.randn(200, out_size, out_size, c, generator=torch.Generator(
        ).manual_seed(0)).to(dev, dtype), rois, small, feats.shape, 1 / 16,
        out_size)
    g64 = roi_align_backward(
        torch.randn(200, out_size, out_size, c, generator=torch.Generator(
        ).manual_seed(0)).to(dev, dtype), rois, binds, feats.shape, 1 / 16,
        out_size)
    atol = 1e-5 * float(got.float().abs().max())
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(g32.float(), g64.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_training_shapes(dev, dtype):
    """The training step's shapes at C = 512: the key map with 256 rois and
    2 reference maps with 600 rois."""
    g = torch.Generator(device="cpu").manual_seed(10)
    _grad_check(torch.randn(38, 64, 512, generator=g).to(dev, dtype),
                _rois(dev, 256, 38, 64, seed=11))
    _grad_check(torch.randn(2, 38, 64, 512, generator=g).to(dev, dtype),
                _rois(dev, 600, 38, 64, seed=12),
                torch.arange(2, device=dev).repeat_interleave(300))


@pytest.mark.parametrize("kind", ["zero_area", "stacked", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_footprints(dev, dtype, kind):
    """Kernel D's footprint reduction on 2 maps of 38 x 64 x 512: 300
    zero-area rois (1-4 pixels each, at random spots), 300 rois of 128 px
    stacked on one spot (every roi on the same 90 pixels), and 300 rois of
    400-600 px (up to 28 x 28 distinct pixels, samples a pixel or more
    apart)."""
    rng = np.random.RandomState(13)
    size = {"zero_area": 0.0, "stacked": 128.0, "wide": 0.0}[kind]
    x1 = rng.uniform(0, 1024 - 600 if kind == "wide" else 1024 - size, 300)
    y1 = rng.uniform(0, 8 if kind == "wide" else 608 - size, 300)
    if kind == "stacked":
        x1[:], y1[:] = x1[0], y1[0]
    sw = rng.uniform(400, 600, 300) if kind == "wide" else size
    r = np.stack([x1, y1, x1 + sw, y1 + (600 if kind == "wide" else size)],
                 1)
    rois = torch.as_tensor(r, dtype=torch.float32, device=dev)
    g = torch.Generator(device="cpu").manual_seed(14)
    feats = torch.randn(2, 38, 64, 512, generator=g).to(dev, dtype)
    _grad_check(feats, rois, torch.arange(2, device=dev).repeat_interleave(
        150))


def test_roi_align_backward_no_rois_no_launch(dev):
    feats = torch.randn(2, 20, 30, 64, device=dev)
    got = _grad_check(feats, torch.zeros(0, 4, device=dev),
                      torch.zeros(0, dtype=torch.int64, device=dev))
    assert not got.any()


def test_roi_align_backward_rejects(dev):
    """No body for (5, 3), bad grad_out shapes, rois that require grad: all
    raise, with no launch."""
    feat = torch.randn(20, 30, 64, device=dev)
    rois = _rois(dev, 10, 20, 30)
    before = roi_align_backward.launches
    grad_out = torch.randn(10, 7, 7, 64, device=dev)
    with pytest.raises(ValueError):
        roi_align_backward(torch.randn(10, 5, 5, 64, device=dev), rois, None,
                           feat.shape, 1 / 16, 5, 3)
    with pytest.raises(ValueError):
        roi_align_backward(grad_out[:, :6], rois, None, feat.shape, 1 / 16)
    with pytest.raises(ValueError):
        roi_align_backward(grad_out.transpose(1, 2), rois, None, feat.shape,
                           1 / 16)
    with pytest.raises(TypeError):
        roi_align_backward(grad_out.half(), rois, None, feat.shape, 1 / 16)
    with pytest.raises(ValueError):  # off a 16-byte boundary
        roi_align_backward(
            torch.randn(10 * 7 * 7 * 64 + 1, device=dev)[1:].view(10, 7, 7,
                                                                  64),
            rois, None, feat.shape, 1 / 16)
    with pytest.raises(ValueError):
        roi_align(feat.requires_grad_(), rois.requires_grad_(), 1 / 16)
    assert roi_align_backward.launches == before


def _dcn_inputs(dev, n, c, h, w, g, dtype, offsets="random", seed=0):
    """x, offset [N, G*18, h, w], mask in (0, 1): random offsets of a few
    px (some samples beyond the edge and beyond 2 px), "zero", "integer"
    (whole px up to 3), "outside" (every sample beyond the map), "far"
    (N(0, 8^2) px: most corners beyond kernel F's window margin, so its
    global adds run) or "one_spot" (every sample at one point near the
    map's middle, inside one tile's window: F's shared adds contend)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    if offsets == "zero":
        off = torch.zeros(n, g * 18, h, w)
    elif offsets == "integer":
        off = torch.randint(-3, 4, (n, g * 18, h, w), generator=gen).float()
    elif offsets == "outside":
        off = torch.full((n, g * 18, h, w), float(max(h, w) + 2))
    elif offsets == "far":
        off = torch.randn(n, g * 18, h, w, generator=gen) * 8.0
    elif offsets == "one_spot":
        k = torch.arange(9)
        py = torch.arange(h).float()[None, :, None] + (k // 3 - 1)[:, None,
                                                                  None]
        px = torch.arange(w).float()[None, None, :] + (k % 3 - 1)[:, None,
                                                                 None]
        dy = (h // 2 + 0.3) - py.expand(9, h, w)
        dx = (w // 2 + 0.6) - px.expand(9, h, w)
        off = torch.stack([dy, dx]).reshape(1, 1, 18, h, w).expand(
            n, g, 18, h, w).reshape(n, g * 18, h, w)
    else:
        off = torch.randn(n, g * 18, h, w, generator=gen) * 2.5
    mask = torch.rand(n, g * 9, h, w, generator=gen)
    return x.to(dev, dtype), off.to(dev), mask.to(dev)


def _dcn_check(x, off, mask, cout=24, seed=1):
    """E against its plain version and the forward against the plain
    forward; F and G against the plain backward and autograd through the
    plain version; the autograd Function launches E once and F and G once
    each. Returns the kernels' (grad_x, grad_offset, grad_mask)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    c = x.shape[1]
    wt = (torch.randn(cout, c, 3, 3, generator=gen) / (3 * c ** 0.5)).to(
        x.device)
    bias = torch.randn(cout, generator=gen).to(x.device)
    e0 = dcn.deform_columns.launches
    cols = dcn.deform_columns(x, off, mask)
    torch.cuda.synchronize()
    assert dcn.deform_columns.launches == e0 + 1
    want = dcn.deform_columns_plain(x, off, mask)
    assert cols.dtype == torch.float32 and cols.shape == want.shape
    torch.testing.assert_close(cols, want, rtol=0, atol=0)

    grad_cols = torch.randn(cols.shape, generator=gen).to(x.device)
    f0, g0 = dcn.deform_col2im.launches, dcn.deform_col2im_coord.launches
    got = dcn.modulated_deform_conv_backward(grad_cols, x, off, mask)
    torch.cuda.synchronize()
    assert (dcn.deform_col2im.launches - f0,
            dcn.deform_col2im_coord.launches - g0) == (1, 1)
    plain = dcn.modulated_deform_conv_backward_plain(grad_cols, x, off, mask)
    xf = x.detach().float().requires_grad_()
    o, m = off.clone().requires_grad_(), mask.clone().requires_grad_()
    auto = torch.autograd.grad(dcn.deform_columns_plain(xf, o, m), (xf, o, m),
                               grad_cols)
    for i, (k, p, a) in enumerate(zip(got, plain, auto)):
        rtol = 2.0 ** -7 if i == 0 and x.dtype == torch.bfloat16 else 0.0
        atol = 1e-5 * max(float(a.abs().max()), 1e-6)
        assert k.dtype == p.dtype and k.shape == p.shape
        torch.testing.assert_close(k.float(), p.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(k.float(), a.to(k.dtype).float(),
                                   rtol=rtol, atol=atol)

    xr = x.detach().clone().requires_grad_()
    orq, mrq = off.clone().requires_grad_(), mask.clone().requires_grad_()
    wr, br = wt.clone().requires_grad_(), bias.clone().requires_grad_()
    e0 = dcn.deform_columns.launches
    out = dcn.modulated_deform_conv(xr, orq, mrq, wr, br)
    ref = dcn.modulated_deform_conv_plain(x, off, mask, wt, bias)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    grad_out = torch.randn(out.shape, generator=gen).to(x.device)
    out.backward(grad_out)
    torch.cuda.synchronize()
    assert dcn.deform_columns.launches == e0 + 1
    gcols = torch.matmul(wt.reshape(cout, -1).t(),
                         grad_out.reshape(x.shape[0], cout, -1))
    want = dcn.modulated_deform_conv_backward_plain(gcols, x, off, mask)
    for k, w_ in zip((xr.grad, orq.grad, mrq.grad), want):
        rtol = 2.0 ** -7 if k.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(k.float(), w_.float(), rtol=rtol,
                                   atol=1e-5 * float(w_.abs().max()))
    wp, bp = wt.clone().requires_grad_(), bias.clone().requires_grad_()
    dcn.modulated_deform_conv_plain(x, off, mask, wp, bp).backward(grad_out)
    for k, w_ in ((wr.grad, wp.grad), (br.grad, bp.grad)):
        torch.testing.assert_close(k, w_, rtol=0,
                                   atol=1e-5 * float(w_.abs().max()))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,g", [(2, 16, 9, 13, 8), (1, 8, 7, 5, 1),
                                       (3, 64, 38, 64, 8),
                                       (2, 32, 20, 17, 4),
                                       (2, 12, 19, 45, 4),
                                       (1, 12, 19, 45, 1),
                                       (2, 20, 7, 10, 4),
                                       (1, 64, 6, 5, 1)])
def test_dcn_kernels_match_plain(dev, dtype, n, c, h, w, g):
    """Random offsets; the last shapes have h and w that no tile divides, W
    not a multiple of 4 (E's and F's scalar stores and adds, G's scalar
    loads and stores) and deform groups of 3, 5 and 12 channels (F's short
    chunks, G's channels past its last whole chunk); the last puts 64
    channels a group on a map narrower than a row of lanes."""
    _dcn_check(*_dcn_inputs(dev, n, c, h, w, g, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_offset_grads_deterministic(dev, dtype):
    """G sums over the channels in a fixed order with no atomics: two
    launches on the same inputs give the same bits, at a stage shape and
    at a ragged one."""
    for n, c, h, w, g in ((3, 64, 38, 64, 8), (2, 20, 7, 10, 4)):
        x, off, mask = _dcn_inputs(dev, n, c, h, w, g, dtype)
        grad_cols = torch.randn(n, c * 9, h * w, device=dev)
        first = dcn.deform_col2im_coord(grad_cols, x, off, mask)
        second = dcn.deform_col2im_coord(grad_cols, x, off, mask)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", ["zero", "integer", "outside", "far",
                                     "one_spot"])
@pytest.mark.parametrize("c,h,w,g", [(16, 11, 14, 8), (24, 21, 36, 2)])
def test_dcn_kernels_edge_offsets(dev, dtype, offsets, c, h, w, g):
    """Zero offsets (a plain conv times the mask), whole-pixel offsets
    (every sample on a pixel: the one-sided offset gradient), every sample
    outside the map (zero columns, zero input gradient), offsets far beyond
    F's window margin, and one image whose samples all land on one point;
    in groups of 2 channels and of 12 (F's full chunk of 8 and a short one
    of 4; W = 36 flushes 16-byte vectors)."""
    n = 1 if offsets == "one_spot" else 2
    x, off, mask = _dcn_inputs(dev, n, c, h, w, g, dtype, offsets)
    gx, _, _ = _dcn_check(x, off, mask)
    if offsets == "outside":
        assert not dcn.deform_columns(x, off, mask).any()
        assert not gx.any()


def test_dcn_kernels_stage_shapes(dev):
    """The aggregator's four stage shapes at T = 3 (stage 0 at 152 x 256):
    one launch each of E, F and G against the plain versions, bf16 x."""
    for c, h, w in ((64, 152, 256), (128, 76, 128), (256, 38, 64),
                    (512, 38, 64)):
        x, off, mask = _dcn_inputs(dev, 3, c, h, w, 8, torch.bfloat16)
        cols = dcn.deform_columns(x, off, mask)
        torch.testing.assert_close(cols, dcn.deform_columns_plain(x, off,
                                                                  mask),
                                   rtol=0, atol=0)
        grad_cols = torch.randn_like(cols)
        got = dcn.modulated_deform_conv_backward(grad_cols, x, off, mask)
        want = dcn.modulated_deform_conv_backward_plain(grad_cols, x, off,
                                                        mask)
        for i, (k, p) in enumerate(zip(got, want)):
            torch.testing.assert_close(
                k.float(), p.float(), rtol=2.0 ** -7 if i == 0 else 0.0,
                atol=1e-5 * float(p.float().abs().max()))
        del cols, grad_cols, got, want


def test_dcn_rejects(dev):
    """f16 x, bf16 offsets, mismatched shapes, a bad grad_cols and more
    images x groups than E's, F's and G's grids take raise with no
    launch."""
    x, off, mask = _dcn_inputs(dev, 1, 16, 6, 7, 8, torch.float32)
    before = (dcn.deform_columns.launches, dcn.deform_col2im.launches,
              dcn.deform_col2im_coord.launches)
    with pytest.raises(TypeError):
        dcn.deform_columns(x.half(), off, mask)
    with pytest.raises(TypeError):
        dcn.deform_columns(x, off.bfloat16(), mask)
    with pytest.raises(ValueError):
        dcn.deform_columns(x[:, :12], off, mask)
    with pytest.raises(ValueError):
        dcn.deform_col2im(torch.zeros(1, 16 * 9, 41, device=dev), x, off,
                          mask)
    with pytest.raises(TypeError):
        dcn.modulated_deform_conv(x.half(), off, mask,
                                  torch.randn(4, 16, 3, 3, device=dev))
    xb, ob, mb = _dcn_inputs(dev, 65536, 1, 1, 1, 1, torch.float32, "zero")
    with pytest.raises(ValueError):
        dcn.deform_columns(xb, ob, mb)
    with pytest.raises(ValueError):
        dcn.deform_col2im(torch.zeros(65536, 9, 1, device=dev), xb, ob, mb)
    with pytest.raises(ValueError):
        dcn.deform_col2im_coord(torch.zeros(65536, 9, 1, device=dev), xb, ob,
                                mb)
    assert (dcn.deform_columns.launches, dcn.deform_col2im.launches,
            dcn.deform_col2im_coord.launches) == before
