"""Parameter counting (total and active) from spec trees — the port of
``repro.analysis.params``."""
from __future__ import annotations

from repro_torch.params import ParamSpec


def _count(ps: ParamSpec) -> int:
    n = 1
    for d in ps.shape:
        n *= int(d)
    return n


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def count_params(spec_tree) -> int:
    return sum(_count(ps) for _, ps in _leaves(spec_tree))


def count_active_params(cfg, spec_tree) -> int:
    """Non-embedding parameters, a routed expert tensor (leading axis
    'experts') at top_k / num_experts: the N of the 6·N·D convention."""
    total = 0.0
    frac = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    for path, ps in _leaves(spec_tree):
        if "embed" in path or "softmax_w" in path:
            continue
        n = _count(ps)
        if cfg.moe and ps.axes and ps.axes[0] == "experts":
            total += n * frac
        else:
            total += n
    return int(total)
