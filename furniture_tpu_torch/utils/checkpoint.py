"""Training checkpoint save/restore.

The port's counterpart of ``furniture_tpu.utils.checkpoint``, with the same
function names. A checkpoint is the whole training state: the modules'
and optimizers' state dicts, the generators' states, the env states, the
buffers and the step, written with ``torch.save`` to ``ckpt_<step>.pt``
in the run dir, the reference's own name (``get_ckpt_path``,
``util/pytorch.py:27-48``). A save is atomic (tmp + rename), so an
interrupted save never corrupts the newest checkpoint; ``keep`` prunes the
older ones.

The state is any nesting of NamedTuples, tuples, lists and dicts over
``nn.Module``, ``torch.optim.Optimizer``, ``torch.Generator``, tensors and
plain numbers. It is written as plain containers, tensors and numbers
only, so it loads with ``torch.load(weights_only=True)``, and restored
into a template of the same structure (a freshly ``init``-ed state):
modules, optimizers and generators in place, tensors onto the template's
devices.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch
from torch import nn

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def ckpt_path(run_dir: str, step: int) -> str:
    """``<run_dir>/ckpt_<step>.pt`` (reference ``get_ckpt_path``,
    ``util/pytorch.py:27-48``)."""
    return os.path.join(run_dir, f"ckpt_{step}.pt")


def latest_checkpoint(run_dir: str) -> str | None:
    """Newest checkpoint file in ``run_dir``, or None."""
    if not os.path.isdir(run_dir):
        return None
    best_step, best = -1, None
    for name in os.listdir(run_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(run_dir, name)
    return best


def _saveable(obj):
    """The state as plain containers, tensors (on the CPU) and numbers."""
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        return _saveable(obj.state_dict())
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _saveable(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_saveable(v) for v in obj]
    return obj


def _restore(template, data):
    """``data`` (as :func:`_saveable` wrote it) in ``template``'s structure."""
    if isinstance(template, (nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(data)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(data)
        return template
    if isinstance(template, torch.Tensor):
        return data.to(template.device)
    if isinstance(template, dict):
        return {k: _restore(template[k], data[k]) for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_restore(t, d) for t, d in zip(template, data)))
    if isinstance(template, (tuple, list)):
        return type(template)(_restore(t, d) for t, d in zip(template, data))
    return data


def save_checkpoint(run_dir: str, state: Any, step: int, keep: int = 3) -> str:
    """Write ``state`` to ``ckpt_<step>.pt``, keeping the ``keep`` newest
    checkpoints and pruning older ones."""
    os.makedirs(run_dir, exist_ok=True)
    path = ckpt_path(run_dir, step)
    tmp = path + ".tmp"
    torch.save(_saveable(state), tmp)
    os.replace(tmp, path)

    steps = sorted(
        int(m.group(1)) for m in (_CKPT_RE.match(n) for n in os.listdir(run_dir)) if m
    )
    for old in steps[:-keep] if keep > 0 else []:
        try:
            os.remove(ckpt_path(run_dir, old))
        except OSError:
            pass
    return path


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore a state saved by :func:`save_checkpoint` into ``template``
    (the same structure, e.g. a freshly ``init``-ed training state): its
    modules, optimizers and generators are loaded in place, and the
    restored state is returned."""
    return _restore(template, torch.load(path, map_location="cpu", weights_only=True))


def checkpoint_step(path: str) -> int:
    """Step number encoded in a checkpoint filename."""
    m = _CKPT_RE.match(os.path.basename(path))
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))
