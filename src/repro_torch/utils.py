"""Small shared helpers: devices, parameter initializers, tree helpers.

Initializers draw from an explicit ``torch.Generator`` (never the global
RNG), on the generator's own device: a CPU generator gives the same
weights on every device, and a CUDA one draws a large model's weights on
the card itself.
Parameter trees are nested dicts and lists of tensors.
"""
from __future__ import annotations

import math

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no GPU is present: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return dev


def trunc_normal(gen: torch.Generator, shape, stddev: float = 0.02):
    """``stddev`` times a standard normal truncated to [-2, 2] (inverse CDF)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=gen.device)
    p = lo + (1.0 - 2.0 * lo) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return (stddev * x.clamp(-2.0, 2.0)).to(torch.float32)


def lecun_normal(gen: torch.Generator, shape, in_axis: int = -2):
    """Normal with std 1/sqrt(fan_in), fan_in = ``shape[in_axis]``."""
    fan_in = shape[in_axis] if len(shape) >= 2 else shape[0]
    return torch.randn(shape, generator=gen, device=gen.device) * (
        1.0 / math.sqrt(fan_in))


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple tree
    (NamedTuples such as decode states keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_cast(tree, dtype):
    """Cast every floating-point leaf to ``dtype``; others stay."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))
