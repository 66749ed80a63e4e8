"""Seeded weights, made on the device in one draw: every weight leaf is a
slice of one standard-normal draw scaled by ``1 / sqrt(fan_in)`` (LeCun
normal), biases are zero and LayerNorm scales one. The layout (names,
shapes, kinds) is the reference's (:mod:`portbench.reference.layout`),
named as the port's state dicts name them; the program loads the dict and
the reference makes it again from the same seed."""

import math

import torch


def make_weights(layout, generator, device):
    """``{name: float32 tensor}`` for ``layout``'s ``(name, shape, kind,
    fan_in)`` rows, kind one of ``normal``, ``zeros``, ``ones``."""
    sizes = [math.prod(shape) for _, shape, kind, _ in layout if kind == "normal"]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in layout:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[at : at + n].view(shape) * (1.0 / math.sqrt(fan_in))
            at += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} of {name}")
    return out


def apply_head(weights, head):
    """A cell's decisive output layer (``ctc_head`` or the joint's ``out``),
    so that seeded weights decide as a trained model's do: ``scale``
    multiplies its weights, ``blank_row`` the blank's row (the last) once
    more, and ``blank_bias`` is added to the blank's bias."""
    for key in ("ctc_head", "joint.out"):
        w = weights.get(key + ".weight")
        if w is None:
            continue
        w.mul_(float(head.get("scale", 1.0)))
        w[-1].mul_(float(head.get("blank_row", 1.0)))
        weights[key + ".bias"][-1] += float(head.get("blank_bias", 0.0))
    return weights
