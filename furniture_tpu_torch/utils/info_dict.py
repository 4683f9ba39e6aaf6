"""Per-step info aggregation (the reference's ``util/info_dict.py:9-56``).

The port's own copy of ``furniture_tpu.utils.info_dict``: scalars (Python
numbers, 0-dim numpy arrays or tensors) reduce to a mean or a sum, other
values are kept as history lists.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


class Info:
    """Accumulates per-step info dicts."""

    def __init__(self, info=None):
        self._history = defaultdict(list)
        if info:
            self.add(info)

    def add(self, info):
        if info is None:
            return
        if isinstance(info, Info):
            for k, v in info._history.items():
                self._history[k].extend(v)
        elif isinstance(info, dict):
            for k, v in info.items():
                if isinstance(v, (list, tuple)):
                    self._history[k].extend(_host(x) for x in v)
                else:
                    self._history[k].append(_host(v))

    def get_dict(self, reduction: str = "mean", only_scalar: bool = False):
        """Scalar keys reduced (``"mean"`` or otherwise a sum), the others as
        their lists unless ``only_scalar``; the history is cleared."""
        out = {}
        for k, v in self._history.items():
            if np.isscalar(v[0]) or (hasattr(v[0], "ndim") and v[0].ndim == 0):
                arr = np.asarray(v, dtype=np.float64)
                out[k] = arr.mean() if reduction == "mean" else arr.sum()
            elif not only_scalar:
                out[k] = v
        self.clear()
        return out

    def clear(self):
        self._history = defaultdict(list)

    def __getitem__(self, k):
        return self._history[k]

    def __contains__(self, k):
        return k in self._history

    def keys(self):
        return self._history.keys()
