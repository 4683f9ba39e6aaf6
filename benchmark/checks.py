"""The comparison that decides ``correct``: gaps between what the timed
path produced and what the plain reference computes from the same inputs.

A *row* is one env of one compared step. Its gap is the widest absolute
difference over every float the step returned (observations, reward, the
next state where the env did not finish), and ``MISMATCH`` where a discrete
output (done, success, selection, groups, connects, touch flags) differs;
a non-finite value where the reference has a finite one reads ``NONFINITE``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import measure

MISMATCH = 1.0
NONFINITE = 1e9


def leaves(x):
    """The tensors of a (nested) named tuple, tuple or dict, in order."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for f in x for t in leaves(f)]
    return [x]


def rebuild(x, template):
    """``x`` (a nested named tuple of the program) in the types of
    ``template`` (the reference's), field by field."""
    if isinstance(template, tuple):
        return type(template)(*(rebuild(xi, ti) for xi, ti in zip(x, template)))
    return x


def row_gaps(a, b, B: int) -> torch.Tensor:
    """[B] float64 on the CPU: each env's widest gap between ``a`` and ``b``
    (matching nested structures whose tensors lead with B)."""
    out = torch.zeros(B, dtype=torch.float64)
    for x, y in zip(leaves(a), leaves(b), strict=True):
        x = torch.as_tensor(x).detach().to("cpu")
        y = torch.as_tensor(y).detach().to("cpu")
        if x.dim() == 0:
            x, y = x.expand(B), y.expand(B)
        x, y = x.reshape(B, -1), y.reshape(B, -1)
        if x.is_floating_point():
            d = (x.double() - y.double()).abs()
            bad = ~torch.isfinite(x) & torch.isfinite(y)
            d = torch.where(bad, torch.full_like(d, NONFINITE), torch.nan_to_num(d, nan=0.0))
            g = d.amax(-1) if d.shape[1] else torch.zeros(B, dtype=torch.float64)
        else:
            g = (x != y).any(-1).double() * MISMATCH
        out = torch.maximum(out, g)
    return out


def step_rows(got, want) -> torch.Tensor:
    """Row gaps of one step: ``got`` and ``want`` are ``(state', obs,
    reward, done, info)``; the next state counts only where neither side's
    env finished (the program's auto-reset replaces it)."""
    s_got, obs_got, r_got, d_got, i_got = got
    s_want, obs_want, r_want, d_want, i_want = want
    B = r_want.shape[0]
    g = row_gaps((obs_got, r_got, d_got, i_got), (obs_want, r_want, d_want, i_want), B)
    keep = ~(torch.as_tensor(d_got).cpu() | torch.as_tensor(d_want).cpu())
    return torch.maximum(g, torch.where(keep, row_gaps(s_got, s_want, B), torch.zeros_like(g)))


STATS = (("p50", 50), ("p90", 90), ("p99", 99), ("max", 100))
OVER = (("1e-4", 1e-4), ("1e-3", 1e-3), ("1e-2", 1e-2))


def stats(name: str, rows) -> dict:
    """``<name>_p50``, ``_p90``, ``_p99`` and ``_max`` of the pooled rows,
    and ``<name>_pct_over_<t>``, the share in % of rows whose gap exceeds
    ``t``, which sees a few bad rows that the percentiles pass: the numbers
    a mix's ``checks`` can hold (the others are printed for the readings
    limits are set from)."""
    pooled = torch.cat([r.reshape(-1) for r in rows]).numpy()
    out = {f"{name}_{s}": measure.percentile(pooled, q) for s, q in STATS}
    out.update({f"{name}_pct_over_{s}": 100.0 * float(np.mean(pooled > t)) for s, t in OVER})
    return out


def judge(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: every number within its
    limit; a number that is missing or not finite fails."""
    table = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = {"value": v, "limit": limit}
    return ok, table
