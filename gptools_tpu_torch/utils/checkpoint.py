"""Checkpoint / resume of inference state.

Counterpart of `gptools_tpu.utils.checkpoint` (orbax there). A state is any
nesting of dicts, lists, tuples and NamedTuples (`DualAveragingState`,
`WelfordState`, `SMCState`, `CheesState`, ...) whose leaves are tensors,
Python numbers, strings, None and `torch.Generator`\\ s (saved as their
``get_state()``). It is written with `torch.save` as its leaves (tensors
moved to the host) and a description of the nesting in plain containers,
so `torch.load(weights_only=True)` reads it back and no class is
unpickled. A file is written under a temporary name in its directory,
flushed to disk and renamed over the target, so a run cut mid-write leaves
the previous checkpoint whole. Resuming from a checkpoint that holds the
generator's state repeats the uninterrupted run's draws.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import torch

__all__ = ["save_state", "restore_state", "CheckpointManager"]

_FORMAT = 1


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(node, leaves: list):
    """The nesting of ``node`` in plain containers, its tensors and
    generator states appended to ``leaves``."""
    if isinstance(node, torch.Tensor):
        leaves.append(node.detach().cpu())
        return {"leaf": len(leaves) - 1}
    if isinstance(node, torch.Generator):
        leaves.append(node.get_state())
        return {"generator": len(leaves) - 1}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    if _is_namedtuple(node):
        return {"namedtuple": list(node._fields),
                "items": [_flatten(v, leaves) for v in node]}
    if isinstance(node, dict):
        if not all(isinstance(k, (str, int)) for k in node):
            raise TypeError("checkpoint dict keys must be str or int")
        return {"dict": [[k, _flatten(v, leaves)] for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return {kind: [_flatten(v, leaves) for v in node]}
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _leaf_like(value, tmpl):
    """A saved leaf as the template's leaf: its type, dtype and device."""
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(value).to(dtype=tmpl.dtype, device=tmpl.device)
    if isinstance(tmpl, (bool, int, float)) and isinstance(value, torch.Tensor):
        return type(tmpl)(value.item())
    if isinstance(tmpl, (bool, int, float)) and value is not None:
        return type(tmpl)(value)
    return value


def _unflatten(spec: dict, leaves: list, tmpl=None, has_tmpl: bool = False):
    """Rebuild a state from its description: with a template, in the
    template's containers and leaf types; without, NamedTuples come back as
    dicts of their fields and generators as their state tensors."""
    def mismatch():
        raise ValueError(f"checkpoint does not match its template at {spec!r:.80}")

    def children(items, tmpls):
        if has_tmpl and len(tmpls) != len(items):
            mismatch()
        return [_unflatten(s, leaves, t, has_tmpl)
                for s, t in zip(items, tmpls if has_tmpl else [None] * len(items))]

    if ("leaf" in spec or "value" in spec) and has_tmpl and isinstance(
            tmpl, (dict, list, tuple, torch.Generator)):
        mismatch()
    if "leaf" in spec:
        value = leaves[spec["leaf"]]
        return _leaf_like(value, tmpl) if has_tmpl else value
    if "generator" in spec:
        state = leaves[spec["generator"]]
        if not has_tmpl:
            return state
        if not isinstance(tmpl, torch.Generator):
            mismatch()
        gen = torch.Generator(device=tmpl.device)
        gen.set_state(state)
        return gen
    if "value" in spec:
        return _leaf_like(spec["value"], tmpl) if has_tmpl else spec["value"]
    if "namedtuple" in spec:
        fields = spec["namedtuple"]
        if not has_tmpl:
            return dict(zip(fields, children(spec["items"], None)))
        if not _is_namedtuple(tmpl) or list(tmpl._fields) != fields:
            mismatch()
        return type(tmpl)(*children(spec["items"], list(tmpl)))
    if "dict" in spec:
        keys = [k for k, _ in spec["dict"]]
        if has_tmpl and (not isinstance(tmpl, dict) or set(tmpl) != set(keys)):
            mismatch()
        vals = children([s for _, s in spec["dict"]], [tmpl[k] for k in keys] if has_tmpl else None)
        return dict(zip(keys, vals))
    kind = "list" if "list" in spec else "tuple"
    if has_tmpl and not isinstance(tmpl, list if kind == "list" else tuple):
        mismatch()
    vals = children(spec[kind], list(tmpl) if has_tmpl else None)
    return vals if kind == "list" else tuple(vals)


def save_state(path: str, state: Any) -> None:
    """Save an inference state to the file ``path``, atomically."""
    leaves: list = []
    payload = {"format": _FORMAT, "spec": _flatten(state, leaves), "leaves": leaves}
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".pt")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_state(path: str, template: Optional[Any] = None) -> Any:
    """Restore an inference state. With ``template`` (a state of the same
    nesting) it comes back in the template's containers, leaf types,
    dtypes and devices, generators as new generators on the template's
    device; without one, in plain containers with tensors on the host."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if payload.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this format")
    return _unflatten(payload["spec"], payload["leaves"], template, template is not None)


_STEP_FILE = re.compile(r"(\d+)\.pt")


class CheckpointManager:
    """Periodic checkpoints with retention for long sampling runs, one file
    ``<step>.pt`` per step in ``directory``: a step is saved when it is a
    multiple of ``save_every`` and past the latest saved one (orbax's
    ``save_interval_steps``), and only the newest ``max_to_keep`` are kept
    (None keeps all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3, save_every: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = int(save_every)
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.fullmatch, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any) -> bool:
        """Save ``state`` as ``step``; False (and nothing written) on a
        step the interval skips or one not past the latest."""
        latest = self.latest_step
        if step % self.save_every != 0 or (latest is not None and step <= latest):
            return False
        save_state(self._path(step), state)
        if self.max_to_keep is not None:
            for old in self._steps()[:-self.max_to_keep]:
                os.unlink(self._path(old))
        return True

    def restore(self, step: Optional[int] = None, template: Optional[Any] = None):
        """The state saved at ``step`` (default: the latest), or None when
        nothing is saved."""
        if step is None:
            step = self.latest_step
        if step is None:
            return None
        return restore_state(self._path(step), template)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing stays open between calls; kept for the reference's API."""
