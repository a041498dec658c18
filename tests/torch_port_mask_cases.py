"""Shared cases of the mask family tests
(``test_torch_port_mask_families*.py``): the DC5 mask families built on
both sides by ``torch_port_rcnn_cases.built`` at each family's weight
seed, the JAX module detect paths jitted with an extra function in the
same compile, and the comparisons: detections as sets, each matched
detection's mask equal (pasted masks) or to 1e-5 of its largest value
(probabilities), the family's detect equal to the module's detections.

Weight seeds (SEEDS): a seed whose every gradient leaf agrees at one
torch thread; other seeds lose a leaf to a ReLU sitting within float
noise of its kink in a mask head (0.8M activations a head and step at
these sizes), which moves that leaf's gradient by up to 5e-4 of its
largest value on one side only (``tests/relu_kinks.py``'s flip finds
them). HTC's three heads lose a leaf on most seeds: 32 and 48 are the
two of the 31 seeds tried at one thread (19, 21-51) whose every leaf
agrees. In float64 on both sides (``tests/htc_f64_grads.py --f64``) the
seeds that fail here agree on every leaf, so the float32 failures are
rounding at kinks, not a fault of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_port_rcnn_cases as C
from test_torch_port_selsa import _same_dets

from lowlightenvironmentvideoobjectdetection_torch.models.detectors import (
    htc as TH,
    mask_rcnn as TMK,
    more_rcnn as TMR,
)
from lowlightenvironmentvideoobjectdetection_tpu.models.detectors import (
    htc as JH,
    mask_rcnn as JMK,
    more_rcnn as JMR,
)

KEY = jax.random.PRNGKey(3)
SEEDS = {"MaskRCNN": 2, "MaskScoringRCNN": 2, "PointRend": 2, "HTC": 32,
         "HybridTaskCascade": 32, "SCNet": 1}
DETECT = {"MaskRCNN": (JMK.mask_rcnn_detect, TMK.mask_rcnn_detect),
          "MaskScoringRCNN": (JMR.mask_scoring_detect,
                              TMR.mask_scoring_detect),
          "PointRend": (JMR.point_rend_detect, TMR.point_rend_detect),
          "HTC": (JH.htc_detect, TH.htc_detect),
          "SCNet": (JH.htc_detect, TH.htc_detect)}
SF = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
_CASES = {}


def case(fam):
    """The DC5 family built on both sides, once a module."""
    if fam not in _CASES:
        jfam, jm, jaux, var, tfam, tm, taux = C.built(fam, SEEDS[fam])
        jb, tb = C.batches()
        _CASES[fam] = dict(jfam=jfam, jm=jm, jaux=jaux, var=var, tfam=tfam,
                           tm=tm, taux=taux, jb=jb, tb=tb)
    return _CASES[fam]


def matched_rows(got, want):
    """Pairs (port row, JAX row) of equal detections (as ``_same_dets``)."""
    _same_dets(got, want)
    jv = np.flatnonzero(np.asarray(want.valid))
    left = list(np.flatnonzero(got.valid.numpy()))
    pairs = []
    for j in jv:
        for i in left:
            if (int(got.labels[i]) == int(want.labels[j])
                    and np.abs(got.boxes[i].numpy()
                               - np.asarray(want.boxes[j])).max() < 5e-3
                    and abs(float(got.scores[i])
                            - float(want.scores[j])) < 1e-5):
                pairs.append((i, j))
                left.remove(i)
                break
    assert len(pairs) == len(jv)
    return pairs


def loss_and_grads_match_jax(fam, term):
    c = case(fam)
    met, grads = C.jax_loss_and_grads(c["jfam"], c["jm"], c["jaux"],
                                      c["var"], KEY, c["jb"], c["tm"])
    got = C.same_loss_and_grads(met, grads, c["tfam"], c["tm"], c["taux"],
                                c["tb"], C.uniforms(fam, KEY,
                                                    c["taux"].shape[0]))
    assert got[term] > 0 and got["loss_mask" if "loss_mask" in got
                                   else "s0.loss_mask"] > 0


def jax_detect(fam, extra=None):
    """The JAX module detect path's (detections, masks) at scale factor
    SF, and ``extra(model, variables, dets)`` in the same compile."""
    c = case(fam)
    jfn = DETECT[fam][0]
    jb = c["jb"]

    def run(v):
        dets, masks = jfn(c["jm"], v, jb.img, jb.img_shape, c["jaux"],
                          scale_factor=jnp.asarray(SF))
        return dets, masks, None if extra is None else extra(c["jm"], v,
                                                              dets)
    return jax.jit(run)(c["var"])


def detections_and_masks_match(fam, want, exact=True):
    """The port module's detect against JAX's (dets, masks): detections as
    sets, each matched mask equal (pasted) or to 1e-5 (probabilities); the
    family's detect gives the same detections."""
    c = case(fam)
    tb = c["tb"]
    jd, jmasks = want[:2]
    td, tmasks = DETECT[fam][1](c["tm"], tb.img, tb.img_shape, c["taux"],
                                scale_factor=torch.from_numpy(SF))
    pairs = matched_rows(td, jd)
    jmasks = np.asarray(jmasks)
    assert tmasks.shape == jmasks.shape
    for i, j in pairs:
        if exact:
            np.testing.assert_array_equal(tmasks[i].numpy(), jmasks[j])
        else:
            C.close(tmasks[i], jmasks[j], tol=1e-5)
    assert sum(float(jmasks[j].sum()) for _, j in pairs) > 0
    api = c["tfam"].detect(c["tm"], c["taux"], tb.img, tb.img_shape,
                           torch.from_numpy(SF))
    for a, b in zip(api, td):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    return td, tmasks
