"""A map over the leaves of the port's state trees (dataclasses, named
tuples, tuples, lists and dicts of tensors), for the ``parallel/``
modules' column slicing and placement."""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, path=""):
    """``fn(path, tensor)`` over every tensor (or NumPy array) of a tree
    of dataclasses, named tuples, tuples, lists and dicts; other leaves
    pass unchanged."""
    if isinstance(tree, torch.Tensor) or hasattr(tree, "__array__"):
        return fn(path, tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             f"{path}.{f.name}".lstrip("."))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, f"{path}.{k}".lstrip("."))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}.{k}".lstrip("."))
                for k, v in tree.items()}
    return tree
