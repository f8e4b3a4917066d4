"""Global-norm gradient clipping — the counterpart of
``repro.optim.clipping``: the squares summed per leaf in f32 (f64 stays
f64), the leaves added in the reference's leaf order."""

import torch

from ..tree import tree_leaves, tree_map


def at_least_f32(x):
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def global_norm(tree):
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(at_least_f32(leaf))) for leaf in leaves))


def clip_by_global_norm(tree, max_norm):
    """(the tree scaled by min(1, max_norm / (‖tree‖ + 1e-12)), ‖tree‖);
    each leaf scaled in f32 and cast back to its dtype, as the reference."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda leaf: (at_least_f32(leaf) * scale).to(leaf.dtype), tree), norm
