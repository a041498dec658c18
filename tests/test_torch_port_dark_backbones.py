"""Port parity for the dark backbones (``models/backbones/dark_resnet.py``:
``ConvLSTMBottleneck``, ``CBAM``, ``LayerDenoisingPlugin``, ``DarkResNet``,
``DARK_VARIANTS``, ``make_dark_backbone``) against the JAX package's, on
the CPU in f32.

Each of the 13 variants runs at reduced width (``base_channels`` 16, the
detector's DC5 strides and dilations, every stage returned) on one clip of
3 frames of 32x32; ``InsertResNet`` with the insert-plugins configs'
overrides (a ``DenoisingAggregator`` after every stage: 1 RDB of 8 layers,
3 embedding convs). The JAX variables are drawn in the shapes of
``jax.eval_shape(init)``: kernels N(0, 1 / fan_in), ``conv_offset``'s
times OFFSET_STD so that the offsets are fractional and reach a few pixels
(a fresh pack's zero offsets would put every sample on a pixel), biases
N(0, 0.05^2), BN scales, means and variances around 1, 0 and 1; bridged
by path (``from_jax_variables``). Tolerance: each stage output to an atol
of REL of its largest |value|.

The JAX packs default to the windowed DCN (radius 3), which clamps the
offsets; the port is unbounded, the JAX ``dcn_impl="scan"`` form (ROADMAP
fault F1). ``pin_scan`` pins the scan form through ``monkeypatch``, with no
edit to the JAX package: a ``ModulatedDCNPack`` subclass set on
``dark_resnet`` and a ``DenoisingAggregator`` subclass set on
``denoising_aggregator`` (which ``DarkResNet`` imports when it builds an
aggregator plugin); it also jits the JAX package's ``modulated_deform_conv``
so that each DCN shape compiles once for all the packs that share it. The
JAX variants then run op by op, which is quicker here than compiling each
whole, except ``InsertResNet``, whose aggregator plugins compile quicker as
a whole. ``test_f1_windowed_default_differs_beyond_the_radius`` shows what
the pin changes.

The port-only tests hold the clip axis (trap: the port batches streams on
the frame axis): a later frame moves an earlier frame's output only where
the backbone mixes frames, and clips batched on the frame axis equal each
clip alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlightenvironmentvideoobjectdetection_tpu.models.aggregators import (
    denoising_aggregator as JA,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.backbones import (
    dark_resnet as JD,
)
from lowlightenvironmentvideoobjectdetection_torch.models.aggregators import (
    denoising_aggregator as TA,
)
from lowlightenvironmentvideoobjectdetection_torch.models.backbones import (
    dark_resnet as TD,
)
from lowlightenvironmentvideoobjectdetection_torch.utils.jax_bridge import (
    from_jax_variables,
)
from torch_port_threads import thread_count


REL = 1e-4
OFFSET_STD = 4.0  # of conv_offset's kernels, in units of 1 / sqrt(fan_in)
KW = dict(base_channels=16, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
          out_indices=(0, 1, 2, 3))
# the insert-plugins configs' backbone_overrides
INSERT = dict(plugin_stages=(0, 1, 2, 3), plugin_type="aggregator",
              plugin_rdb_blocks=1, plugin_rdb_layers=8, plugin_emb_nums=3)
VARIANTS = sorted(JD.DARK_VARIANTS)
COMPILED_WHOLE = ("InsertResNet",)
JIT_DCN = jax.jit(JA.modulated_deform_conv,
                  static_argnames=("kernel_size", "deform_groups"))


_pinned_threads = thread_count(1)


class ScanPack(JA.ModulatedDCNPack):
    dcn_impl: str = "scan"


class ScanAggregator(JA.DenoisingAggregator):
    dcn_impl: str = "scan"


def pin_scan(mp):
    """The JAX dark backbones with the 'scan' DCN (see the docstring)."""
    mp.setattr(JD, "ModulatedDCNPack", ScanPack)
    mp.setattr(JA, "DenoisingAggregator", ScanAggregator)
    mp.setattr(JA, "modulated_deform_conv", JIT_DCN)


def overrides(variant):
    return dict(KW, **(INSERT if variant == "InsertResNet" else {}))


def in_channels(variant):
    return JD.DARK_VARIANTS[variant].get("in_channels", 3)


def draw(shapes, rs, offset_std=OFFSET_STD):
    """Variables in ``shapes`` (see the module docstring)."""
    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        names = [str(getattr(p, "key", p)) for p in path]
        if name == "bias":
            return (rs.randn(*a.shape) * 0.05).astype(np.float32)
        if name == "scale":  # FrozenBN's, or a dense head's 0-d Scale
            return np.asarray(1 + rs.randn(*a.shape) * 0.1, np.float32)
        if name == "mean":
            return (rs.randn(*a.shape) * 0.1).astype(np.float32)
        if name == "var":
            return (1 + rs.rand(*a.shape) * 0.2).astype(np.float32)
        scale = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
        if "conv_offset" in names:
            scale *= offset_std
        return (rs.randn(*a.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def bridged(jmodule, tmodule, x, seed=0, offset_std=OFFSET_STD):
    """Draw the JAX module's variables for input x (NHWC), load them into
    the port module; returns the variables."""
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    var = draw(shapes, np.random.RandomState(seed), offset_std)
    var = jax.tree_util.tree_map(np.asarray, var)
    tmodule.load_state_dict(from_jax_variables(var), strict=True)
    return var


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


class OffsetRange:
    """Forward hooks on every port pack's ``conv_offset``: the largest
    |offset| (the first 2/3 of its channels, per group) seen."""

    def __init__(self, model):
        self.max = 0.0
        self.handles = [m.conv_offset.register_forward_hook(self.hook)
                        for m in model.modules()
                        if isinstance(m, TA.ModulatedDCNPack)]

    def hook(self, mod, args, out):
        om = out.reshape(out.shape[0], -1, 27, *out.shape[2:])
        self.max = max(self.max, float(om[:, :, :18].abs().max()))


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_forward_matches_jax(variant, monkeypatch):
    pin_scan(monkeypatch)
    kw = overrides(variant)
    x = np.random.RandomState(1).randn(3, 32, 32, in_channels(variant)
                                       ).astype(np.float32)
    jm = JD.make_dark_backbone(variant, **kw)
    tm = TD.make_dark_backbone(variant, **kw)
    var = bridged(jm, tm, x)
    apply = jax.jit(jm.apply) if variant in COMPILED_WHOLE else jm.apply
    want = apply(var, jnp.asarray(x))
    probe = OffsetRange(tm)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * np.abs(w).max(),
                                   err_msg=f"stage {i}")
    n_packs = len(probe.handles)
    if n_packs:  # fractional offsets of more than a pixel
        assert 1.0 < probe.max < 50.0, probe.max
    assert (n_packs > 0) == (variant not in ("DarkResNet", "DarkRAWResNet",
                                             "ResNetH"))


# variant: whether a later frame of the clip moves an earlier frame's output
MIXING = {"DarkResNet": False, "ResNetH": False, "ResNet_A": True,
          "ResNet_B": True, "ResNetC": True, "ResNetD": True,
          "InsertResNet": True}


def port_draw(model, seed=0):
    """Port variables as ``draw`` gives them, straight into the module."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
            elif p.dim() == 1:  # a FrozenBN scale
                p.copy_(1 + torch.randn(p.shape, generator=g) * 0.1)
            else:
                std = p[0].numel() ** -0.5
                if "conv_offset" in name:
                    std *= OFFSET_STD
                p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


@pytest.mark.parametrize("variant", sorted(MIXING))
def test_a_later_frame_moves_an_earlier_one_only_where_frames_mix(variant):
    """The forward ConvLSTM (DarkResNet) is causal and the plain ResNet
    (ResNetH) frame-wise: changing frame 2 leaves frames 0 and 1 alone; the
    bidirectional ConvLSTMs and the plugins' fusion over the frames pass it
    back to frame 0. Frame 2 itself always changes."""
    tm = port_draw(TD.make_dark_backbone(variant, **overrides(variant)))
    x = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    y = x.clone()
    y[2] += 0.5
    with torch.no_grad():
        a, b = tm(x)[-1], tm(y)[-1]
    assert not torch.allclose(a[2], b[2])
    assert torch.equal(a[:2], b[:2]) != MIXING[variant]


@pytest.mark.parametrize("variant", ["ResNet_A", "ResNetD", "InsertResNet"])
def test_clips_batched_equal_each_clip_alone(variant):
    """4 frames as 4 clips of one frame (streaming S = 4) and as 2 clips of
    2 frames: each clip equals that clip alone, so no clip sees another."""
    tm = port_draw(TD.make_dark_backbone(variant, **overrides(variant)))
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for t in (1, 2):
            got = tm(x, clip_len=t)
            for k in range(0, 4, t):
                alone = tm(x[k:k + t])
                for g, w in zip(got, alone):
                    np.testing.assert_allclose(
                        g[k:k + t].numpy(), w.numpy(), rtol=0,
                        atol=1e-5 * float(w.abs().max()))
        with pytest.raises(ValueError, match="clips of 3"):
            tm(x, clip_len=3)


def test_f1_windowed_default_differs_beyond_the_radius(monkeypatch):
    """F1 in the dark backbones: a ``LayerDenoisingPlugin`` with the JAX
    default (windowed DCN, radius 3) equals the scan form and the port
    while the offsets stay well within 3 px, and differs from both once
    they reach beyond it, where the port follows the scan form."""
    x = jnp.asarray(np.random.RandomState(4).randn(3, 12, 12, 32
                                                    ).astype(np.float32))
    jm, tm = JD.LayerDenoisingPlugin(), TD.LayerDenoisingPlugin(32)
    windowed = jax.jit(jm.apply)
    with monkeypatch.context() as mp:
        pin_scan(mp)
        scan = jax.jit(JD.LayerDenoisingPlugin().apply)
        cases = [(within, bridged(jm, tm, x, seed=5, offset_std=std))
                 for std, within in ((0.3, True), (12.0, False))]
        cases = [(within, var, np.asarray(scan(var, x)))
                 for within, var in cases]
    for within, var, want in cases:
        tm.load_state_dict(from_jax_variables(var), strict=True)
        probe = OffsetRange(tm)
        with torch.no_grad():
            port = tm(nchw(x)).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(port, want, rtol=0,
                                   atol=REL * np.abs(want).max())
        diff = (np.abs(np.asarray(windowed(var, x)) - want).max()
                / np.abs(want).max())
        assert (probe.max < 2.5) == within, probe.max
        assert (diff < 1e-5) if within else (diff > 1e-2), diff


def test_make_dark_backbone_and_registry():
    """13 variants, each registered in the port's BACKBONES registry as
    the JAX zoo registers them; an unknown name raises KeyError; a fresh
    pack's offsets are 0 (``conv_offset`` zero after ``init_flax``)."""
    from lowlightenvironmentvideoobjectdetection_torch.registry import (
        BACKBONES,
    )

    assert sorted(TD.DARK_VARIANTS) == VARIANTS and len(VARIANTS) == 13
    assert {v: sorted(TD.DARK_VARIANTS[v].items()) for v in VARIANTS} == {
        v: sorted(JD.DARK_VARIANTS[v].items()) for v in VARIANTS}
    assert sorted(BACKBONES.keys()) == VARIANTS
    m = BACKBONES.get("ResNetC")(**KW)
    assert isinstance(m.plugin4, TD.LayerDenoisingPlugin)
    assert not m.plugin4.dcn_pack.conv_offset.weight.any()
    with pytest.raises(KeyError, match="ResNetZ"):
        TD.make_dark_backbone("ResNetZ")
    with pytest.raises(ValueError, match="plugin_type"):
        TD.make_dark_backbone("InsertResNet", plugin_stages=(3,),
                              plugin_type="x")
