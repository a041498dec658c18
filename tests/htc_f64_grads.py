"""HTC's gradient parity (``test_torch_port_mask_families_c.py``) at other
weight seeds, in float32 as the test runs it or with both packages in
float64.

In float32 a ReLU whose pre-activation lies within the two frameworks'
rounding of 0 passes its gradient on one side and blocks it on the other,
which moves a leaf by more than the test's GRAD_REL. In float64 the
rounding is some 1e-16 of the values and no such kink is near, so the
seeds that fail in float32 for that reason agree there; a fault of the
port (in the mask-information flow, the semantic fusion or a loss) fails
in both. ``--f64`` turns on JAX's x64 and makes ``jnp.float32``,
``torch.float32``, ``Tensor.float`` and torch's default dtype mean float64
before either package is imported, so every cast on both sides keeps
float64 (the weights, image and uniforms are drawn as in the test and
widened). For each seed the script prints the leaves outside the test's
tolerance and the worst leaf's |difference| over its tolerance.

Run on the CPU from the repo root, one torch thread as the test::

    JAX_PLATFORMS=cpu python tests/htc_f64_grads.py 19 20 21 32
    JAX_PLATFORMS=cpu python tests/htc_f64_grads.py --f64 19 20 21 32
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def widen():
    """float32 means float64 from here on, in both packages."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--family", default="HTC")
    args = ap.parse_args()
    if args.f64:
        widen()
    import jax
    import numpy as np
    import torch
    import torch_port_mask_cases as M
    import torch_port_rcnn_cases as C

    torch.set_num_threads(1)
    dtype = np.float64 if args.f64 else np.float32
    for seed in args.seeds:
        jfam, jm, jaux, var, tfam, tm, taux = C.built(args.family, seed)
        if args.f64:
            var = jax.tree_util.tree_map(lambda a: a.astype(dtype), var)
            tm.double()
            tm.load_state_dict(C.from_jax_variables(var, tm), strict=True)
        jb, tb = C.batches()
        if args.f64:
            jb = jb._replace(img=jb.img.astype(dtype),
                             img_shape=jb.img_shape.astype(dtype),
                             gt_boxes=jb.gt_boxes.astype(dtype))
            tb = tb._replace(img=tb.img.double(),
                             img_shape=tb.img_shape.double(),
                             gt_boxes=tb.gt_boxes.double())
        met, want = C.jax_loss_and_grads(jfam, jm, jaux, var, M.KEY, jb, tm)
        tm.zero_grad()
        total, got_met = tfam.loss(tm, taux, tb, uniforms=C.uniforms(
            args.family, M.KEY, taux.shape[0]))
        total.backward()
        params = dict(tm.named_parameters())
        top = max(float(np.abs(g.numpy()).max()) for g in want.values())
        worst, off = (0.0, ""), []
        for n, w in want.items():
            g = params[n].grad
            g = np.zeros_like(w.numpy()) if g is None else g.numpy()
            tol = max(C.GRAD_REL * float(np.abs(w.numpy()).max()),
                      1e-6 * top)
            ratio = float(np.abs(g - w.numpy()).max()) / tol
            if ratio > 1:
                off.append(n)
            worst = max(worst, (ratio, n))
        loss = max(abs(float(got_met[k].detach()) - v) / max(abs(v), 1e-12)
                   for k, v in met.items())
        print(f"seed {seed} float{64 if args.f64 else 32}: "
              f"{len(off)} of {len(want)} leaves outside; worst "
              f"{worst[1]} at {worst[0]:.3g} x its tolerance; largest "
              f"relative loss-term difference {loss:.3g}"
              + (f"; outside: {', '.join(off)}" if off else ""), flush=True)


if __name__ == "__main__":
    main()
