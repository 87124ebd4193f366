"""Workload checkpoint/resume.  Port of kubeshare_tpu/parallel/checkpoint.py.

The same files and rules as the JAX package: ``ckpt-<step>.bin`` in a
directory, written atomically (a ``.tmp`` file, flushed and fsynced,
then ``os.replace``), the latest step the largest number, and
:func:`save_checkpoint` keeping the newest ``keep``.

The format is the port's own.  JAX pickles a jax treedef, which cannot
be read without jax; the port writes ``torch.save`` of plain dicts and
lists of CPU tensors, loadable with ``torch.load(weights_only=True)``.
Neither package reads the other's files.

A tree of tensors (params) is written as it is.  A :class:`TrainState`
is written as its params, ``optimizer.state_dict()`` and step; a sharded
one (``make_train_step(mesh=...)``, every shard an optimizer parameter)
is gathered to whole tensors first.  The optimizer state is keyed by
each leaf's path, as the params are, each moment gathered like its
parameter, so the file depends neither on the mesh nor on the order in
which the tree's dicts list their keys.  :func:`restore_checkpoint` with ``into=`` copies a
file into an existing state *in place*: a :class:`CapturedTrainStep`
replays a CUDA graph that reads the parameters', moments' and step
counts' addresses, so rebinding them would leave the graph training the
old storage with no error.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from .mesh import RankMesh, ShardedTensor, shard_tensor
from .train import TrainState, tree_leaves_with_paths

_STEP_RE = re.compile(r"ckpt-(\d+)\.bin$")
FORMAT = "kubeshare_tpu_torch.checkpoint/1"


def _refuse_ranks(tree: Any) -> None:
    """``ValueError`` for a tree placed over a mesh of ranks: each rank
    holds its own shards, and a file of one rank's would be a partial
    tree (ROADMAP queue A item 11h)."""
    for _, leaf in tree_leaves_with_paths(tree):
        if isinstance(leaf, ShardedTensor) and isinstance(leaf.mesh,
                                                          RankMesh):
            raise ValueError(
                "checkpoints of a state sharded over a mesh of ranks are "
                "not written or restored yet (ROADMAP queue A item 11h); "
                "each rank holds only its own shards")


def _whole(leaf) -> torch.Tensor:
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather()
    return leaf.detach().to("cpu", copy=True)


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _host_tree(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(value) for value in tree]
    return _whole(tree)


def _optimizer_payload(state: TrainState) -> Dict:
    """``optimizer.state_dict()`` with the parameters keyed by their leaf's
    path (as the params are, so a tree whose dicts list their keys in
    another order restores the same moments): a sharded leaf's per-shard
    entries gathered into one entry (each tensor that has its parameter's
    shape placed back into the leaf's shape), every tensor on the CPU."""
    optimizer = state.opt_state
    paths = []
    per_leaf: Dict[Tuple, Dict] = {}
    for path, leaf in tree_leaves_with_paths(state.params):
        paths.append(path)
        shards = leaf.shards if isinstance(leaf, ShardedTensor) else [leaf]
        entries = [optimizer.state.get(s) for s in shards]
        if not any(entries):
            continue
        if any(not e for e in entries):
            raise ValueError(f"leaf {path}: some shards have optimizer "
                             "state and others none")
        entry = {}
        for key, value in entries[0].items():
            if (isinstance(value, torch.Tensor)
                    and isinstance(leaf, ShardedTensor)
                    and value.shape == leaf.shards[0].shape):
                value = ShardedTensor([e[key] for e in entries], leaf.spec,
                                      leaf.mesh, leaf.shape)
            entry[key] = (_whole(value) if isinstance(
                value, (torch.Tensor, ShardedTensor)) else value)
        per_leaf[path] = entry
    groups = []
    for group in optimizer.param_groups:
        groups.append({key: value for key, value in group.items()
                       if key != "params"})
    if len(groups) != 1:
        raise ValueError("a checkpoint holds one optimizer parameter group, "
                         f"got {len(groups)}")
    groups[0]["params"] = paths
    return {"state": per_leaf, "param_groups": groups}


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: int = 3) -> str:
    """Write a :class:`TrainState` or a tree of tensors to
    ``ckpt-<step>.bin``; returns its path."""
    _refuse_ranks(state.params if isinstance(state, TrainState) else state)
    os.makedirs(directory, exist_ok=True)
    if isinstance(state, TrainState):
        payload = {"format": FORMAT, "kind": "train_state",
                   "params": _host_tree(state.params),
                   "optimizer": _optimizer_payload(state),
                   "train_step": int(state.step), "step": step}
    else:
        payload = {"format": FORMAT, "kind": "tree",
                   "tree": _host_tree(state), "step": step}
    path = os.path.join(directory, f"ckpt-{step}.bin")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _garbage_collect(directory, keep)
    return path


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return None
    best: Optional[Tuple[int, str]] = None
    for name in os.listdir(directory):
        match = _STEP_RE.match(name)
        if match:
            step = int(match.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(directory, name))
    return best


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       into: Any = None) -> Any:
    """Load ``ckpt-<step>.bin`` (default: the latest).

    Without ``into``: a tree file gives its tree of CPU tensors; a
    :class:`TrainState` file gives ``{"params": tree, "optimizer":
    state dict (parameters keyed by their leaf's path, a tuple of keys
    and indices), "step": int}``.

    ``into`` a tree of tensors or a :class:`TrainState` (sharded or not,
    eager or in a captured step's hands): the file is copied into its
    tensors in place — each parameter shard receives its slice of the
    whole tensor, each moment and step count likewise; a parameter whose
    optimizer state is not yet built receives a new one, laid out as the
    optimizer builds it.  The optimizer's hyperparameters stay those of
    ``into`` (the JAX optimizer's live in its code, not its state).
    Returns ``into`` (a :class:`TrainState` with the file's step)."""
    if into is not None:
        _refuse_ranks(into.params if isinstance(into, TrainState) else into)
    if step is None:
        found = latest_checkpoint(directory)
        if found is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        _, path = found
    else:
        path = os.path.join(directory, f"ckpt-{step}.bin")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} file")
    if into is None:
        if payload["kind"] == "tree":
            return payload["tree"]
        return {"params": payload["params"],
                "optimizer": payload["optimizer"],
                "step": payload["train_step"]}
    if isinstance(into, TrainState):
        if payload["kind"] != "train_state":
            raise ValueError(f"{path} holds a tree, not a TrainState")
        _copy_tree(into.params, payload["params"])
        _copy_optimizer(into, payload["optimizer"])
        return TrainState(params=into.params, opt_state=into.opt_state,
                          step=payload["train_step"])
    tree = payload["tree"] if payload["kind"] == "tree" else payload["params"]
    _copy_tree(into, tree)
    return into


def _pieces(leaf, whole: torch.Tensor) -> List[Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """(destination, source) for every tensor of ``leaf``: each shard of a
    placed leaf and its slice of ``whole``."""
    if isinstance(leaf, ShardedTensor):
        placed = shard_tensor(whole, leaf.spec, leaf.mesh)
        return list(zip(leaf.shards, placed.shards))
    return [(leaf, whole)]


@torch.no_grad()
def _copy_tree(tree: Any, saved: Any) -> None:
    saved_leaves = dict(tree_leaves_with_paths(saved))
    for path, leaf in tree_leaves_with_paths(tree):
        whole = saved_leaves.get(path)
        if whole is None or tuple(whole.shape) != tuple(leaf.shape):
            raise ValueError(f"the checkpoint has no leaf of shape "
                             f"{tuple(leaf.shape)} at {path}")
        for dest, src in _pieces(leaf, whole):
            dest.copy_(src)


@torch.no_grad()
def _copy_optimizer(state: TrainState, saved: Dict) -> None:
    optimizer = state.opt_state
    (group,) = optimizer.param_groups
    leaves = dict(tree_leaves_with_paths(state.params))
    unknown = [path for path in saved["state"] if path not in leaves]
    if unknown:
        raise ValueError(f"the checkpoint has optimizer state for {unknown}, "
                         "which the tree lacks")
    for path, leaf in leaves.items():
        entry = saved["state"].get(path)
        if entry is None:
            continue
        for shard, pieces in _entry_pieces(path, leaf, entry):
            live = optimizer.state.get(shard)
            if live:
                for key, value in pieces.items():
                    if isinstance(live.get(key), torch.Tensor):
                        live[key].copy_(value)
                    else:
                        live[key] = value
            else:
                optimizer.state[shard] = {
                    key: _new_state_tensor(key, value, shard, group)
                    for key, value in pieces.items()}


def _entry_pieces(path: Tuple, leaf, entry: Dict):
    """(optimizer parameter, its entry) for every shard of ``leaf``: a
    tensor of the leaf's shape (a moment) is sliced like the leaf, a 0-d
    tensor (the step count) and anything not a tensor go to every shard
    as they are; a tensor of any other shape raises ``ValueError``."""
    shards = leaf.shards if isinstance(leaf, ShardedTensor) else [leaf]
    out = [(s, {}) for s in shards]
    for key, value in entry.items():
        if (isinstance(value, torch.Tensor)
                and tuple(value.shape) == tuple(leaf.shape)):
            for (shard, pieces), (_, src) in zip(out, _pieces(leaf, value)):
                pieces[key] = src
        elif isinstance(value, torch.Tensor) and value.dim() != 0:
            raise ValueError(
                f"the checkpoint's {key!r} at {path} has shape "
                f"{tuple(value.shape)}, its leaf {tuple(leaf.shape)}")
        else:
            for _, pieces in out:
                pieces[key] = value
    return out


def _new_state_tensor(key: str, value, param: torch.Tensor, group: Dict):
    """A new optimizer state entry as ``Optimizer.load_state_dict`` casts
    it: the step count stays an f32 CPU tensor unless the group is
    capturable or fused (then on the parameter's device); moments take
    the parameter's device and dtype."""
    if not isinstance(value, torch.Tensor):
        return value
    if key == "step":
        if group.get("capturable") or group.get("fused"):
            return value.to(device=param.device, dtype=torch.float32,
                            copy=True)
        return value.to(dtype=torch.float32, copy=True)
    return value.to(device=param.device, dtype=param.dtype, copy=True)


def _garbage_collect(directory: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1))
        for m in (_STEP_RE.match(n) for n in os.listdir(directory))
        if m
    )
    for step in steps[:-keep] if keep > 0 else []:
        try:
            os.unlink(os.path.join(directory, f"ckpt-{step}.bin"))
        except OSError:
            pass
