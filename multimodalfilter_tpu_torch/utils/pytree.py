"""Dotted-path addressing of nested dicts (port of
``multimodalfilter_tpu/utils/pytree.py``).

The reference performs checkpoint surgery with torch module paths like
``filter_models.0.dynamics_model`` (scripts/door_task/train_door.py:270-274).
The port's state dicts are flat, keyed by those dotted paths; nested dicts
(the JAX package's param trees, whose list indices are string digit keys)
are addressed by the same paths.
"""

from __future__ import annotations

from typing import List, Tuple


def torch_path_segments(path: str) -> List[str]:
    return [seg for seg in path.split(".") if seg]


def get_by_path(tree, path: str):
    node = tree
    for seg in torch_path_segments(path):
        if not isinstance(node, dict) or seg not in node:
            raise KeyError(
                f"Path {path!r} not found (missing segment {seg!r}); "
                f"available: {list(node.keys()) if isinstance(node, dict) else type(node)}"
            )
        node = node[seg]
    return node


def set_by_path(tree, path: str, value):
    """A copy of `tree` with the subtree at `path` replaced by `value`."""
    segments = torch_path_segments(path)
    if not segments:
        return value

    def _set(node, segs: Tuple[str, ...]):
        seg, rest = segs[0], segs[1:]
        if not isinstance(node, dict) or seg not in node:
            raise KeyError(f"Path {path!r} not found (missing segment {seg!r})")
        new_node = dict(node)
        new_node[seg] = _set(node[seg], rest) if rest else value
        return new_node

    return _set(tree, tuple(segments))


def path_matches_prefix(path: Tuple[str, ...], prefix: str) -> bool:
    """True if a key path (a tuple of segments, or a flat state dict's
    dotted key split at its dots) starts with the dotted prefix."""
    segs = torch_path_segments(prefix)
    return len(path) >= len(segs) and list(path[: len(segs)]) == segs
