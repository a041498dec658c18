"""Find the ReLUs that the port and the JAX package decide differently on a
sample of the gradient parity tests.

A ReLU pre-activation within the two frameworks' f32 rounding of 0 passes
its gradient on one side and blocks it on the other, and no rounding
tolerance covers what that does to a leaf's gradient. For a case of
``test_torch_port_fastdvd.py`` (``fastdvd``, ``unet``),
``test_torch_port_dark_selsa.py`` (``lstm``, ``insert_plugins``) or
``test_torch_port_fgfa.py`` (``fgfa``) or ``test_torch_port_dff.py``
(``dff``) and a sample seed this script runs both packages' loss and
gradients, lists the leaves outside the tests' tolerance, then takes the
port's ReLU (and leaky ReLU) pre-activations nearest 0 (relative to the
largest |x| of their call) and flips each one's gradient in turn (the
other branch's gradient at that one element; the value stays, so that no
later ReLU moves). A flip after which
every leaf is within tolerance is the kink: the script prints its call
site, element and pre-activation. Where the best flip leaves fewer leaves
outside, or the worst leaf nearer its tolerance, it is kept and the search
goes on, up to MAX_FLIPS flips.

Run on the CPU from the repo root::

    JAX_PLATFORMS=cpu python tests/relu_kinks.py unet 2 4 5
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from test_torch_port_darkfarm import GRAD_FLOOR, GRAD_REL_ATOL  # noqa: E402

CANDIDATES = 24  # the pre-activations nearest 0 that are tried (default)
MAX_FLIPS = 2


class Relu:
    """``F.relu`` (and ``F.leaky_relu``, whose kink passes 1 on one side
    and its slope on the other) that records each call's input and site,
    or flips the decision at some elements: ``flips`` holds (call, flat
    index) pairs."""

    def __init__(self, model):
        self.names = {id(m): n for n, m in model.named_modules()}
        self.orig, self.orig_leaky = F.relu, F.leaky_relu
        self.calls, self.flips, self.record = [], (), False
        self.n = 0

    def __call__(self, x, inplace=False):
        return self._decide(x, self.orig(x), 1.0)

    def leaky(self, x, negative_slope=0.01, inplace=False):
        return self._decide(x, self.orig_leaky(x, negative_slope),
                            1.0 - negative_slope)

    def _decide(self, x, out, gap):
        i, self.n = self.n, self.n + 1
        if self.record:
            frame = sys._getframe(2)  # the module whose forward calls it
            while id(frame.f_locals.get("self")) not in self.names:
                frame = frame.f_back
            site = (f"{self.names[id(frame.f_locals['self'])]} "
                    f"({os.path.basename(frame.f_code.co_filename)}:"
                    f"{frame.f_lineno})")
            self.calls.append((site, x.detach().clone()))
        mine = [j for c, j in self.flips if c == i]
        if mine:  # the same value, the other branch's gradient
            turn = torch.zeros_like(x).flatten()
            turn[mine] = 1 - 2 * (x.flatten()[mine] > 0).to(x.dtype)
            out = out + (x - x.detach()) * turn.view_as(x) * gap
        return out

    def run(self, port, record=False, flips=()):
        self.n, self.record, self.flips = 0, record, flips
        F.relu, F.leaky_relu = self, self.leaky
        try:
            return port()
        finally:
            F.relu, F.leaky_relu = self.orig, self.orig_leaky


def mismatches(got, want):
    """Leaves outside the tests' tolerance: (name, worst |error| / atol)."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    out = []
    for n, w in want.items():
        atol = max(GRAD_REL_ATOL * float(w.abs().max()), floor)
        err = float((got[n] - w).abs().max())
        if err > atol:
            out.append((n, err / atol))
    return sorted(out, key=lambda t: -t[1])


def loss_and_grads(case, seed):
    if case in ("fastdvd", "unet"):
        from test_torch_port_fastdvd import loss_and_grads as fn
    elif case == "fgfa":
        from test_torch_port_fgfa import loss_and_grads as fn
    elif case == "dff":
        from test_torch_port_dff import loss_and_grads as fn
    else:
        from test_torch_port_dark_selsa import loss_and_grads as fn
    return fn(case, seed)


def probe(case, seed, candidates=CANDIDATES):
    _, want, model, port = loss_and_grads(case, seed)
    relu = Relu(model)
    _, got = relu.run(port, record=True)
    bad = mismatches(got, want)
    print(f"{case} seed {seed}: {len(bad)} leaves outside tolerance")
    for n, r in bad[:5]:
        print(f"  {n}: {r:.3g} x atol")
    if not bad:
        return
    near = []
    for i, (site, x) in enumerate(relu.calls):
        rel = (x.abs() / x.abs().max()).flatten()
        k = min(candidates, rel.numel())
        v, idx = rel.topk(k, largest=False)
        near += [(float(r), i, int(j)) for r, j in zip(v, idx)]
    near = sorted(near)[:candidates]
    flips, n_left, worst = [], len(bad), bad[0][1]
    while n_left and len(flips) < MAX_FLIPS:
        tried = []
        for rel, i, j in near:
            if (i, j) in flips:
                continue
            _, flipped = relu.run(port, flips=flips + [(i, j)])
            out = mismatches(flipped, want)
            tried.append(((len(out), out[0][1] if out else 0.0), rel, i, j))
            print(f"  flip {describe(relu, i, j, rel)} -> {len(out)} leaves "
                  f"outside, worst {tried[-1][0][1]:.3g} x atol")
            if not out:
                break
        score, rel, i, j = min(tried)
        if score >= (n_left, worst):
            break
        flips.append((i, j))
        n_left, worst = score
        print(f"  FLIP KEPT {case} seed {seed}: {describe(relu, i, j, rel)}")
        _, flipped = relu.run(port, flips=flips)
        for name, r in mismatches(flipped, want):
            print(f"  still outside: {name}: {r:.3g} x atol")
    print(f"  {case} seed {seed}: worst leaf {bad[0][0]} at {bad[0][1]:.3g}"
          f" x atol; {len(flips)} flips leave {n_left} leaves outside")


def describe(relu, i, j, rel):
    site, x = relu.calls[i]
    elem = tuple(int(e) for e in np.unravel_index(j, tuple(x.shape)))
    return (f"call {i} at {site}, element {elem} of {tuple(x.shape)}, "
            f"pre-activation {float(x.flatten()[j]):.3g} ({rel:.3g} of the "
            "call's max |x|)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", choices=("fastdvd", "unet", "lstm",
                                     "insert_plugins", "fgfa", "dff"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--candidates", type=int, default=CANDIDATES)
    args = ap.parse_args()
    torch.set_num_threads(1)
    for seed in args.seeds:
        probe(args.case, seed, args.candidates)


if __name__ == "__main__":
    main()
