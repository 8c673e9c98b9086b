"""Transcendental elementwise functions whose result for an element does not
depend on the tensor around it.

On the CPU, PyTorch evaluates exp, log, sigmoid, erf, sin and cos in SIMD
vectors and the tail of a tensor that does not fill a whole vector pair in
scalar code, whose last bit may differ; a large tensor is also split over
threads, each chunk with its own tail. So an element of a batch of B could
round differently from the same element alone, by where it falls. ``lanewise``
pads the flattened tensor to whole vector pairs (of the widest vectors,
LANES elements) and evaluates it in pieces of at most CHUNK elements (one
thread each), so every element takes the vector path: the batched paths of
the port (a plan's restarts, a training's runs, an episode batch's seeds)
then give each element exactly what it gets alone. On the card an
elementwise kernel computes every element alike, and ``lanewise`` is the
function itself.
"""

from __future__ import annotations

import torch

LANES = 64  # two vectors of the widest SIMD register, 512 bits of float32
CHUNK = 32768  # PyTorch's grain size: a piece this long runs on one thread


def lanewise(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for an elementwise fn, each element by the vector path on the
    CPU; differentiable as fn is."""
    if x.device.type != "cpu":
        return fn(x)
    n = x.numel()
    flat = x.reshape(-1)
    pad = -n % LANES
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = torch.cat([fn(part) for part in flat.split(CHUNK)]) if flat.numel() > CHUNK else fn(flat)
    return out[:n].reshape(x.shape)
