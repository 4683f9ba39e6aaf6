"""PyTorch port: the profiler spans of the env step (``utils/trace.py``).

* Under ``torch.profiler``, one ``VecEnv.step`` of the cursor env and of the
  Sawyer env under impedance control records each span at its code site
  the expected number of times, each inside the span the layer table of
  ``utils/trace.py`` puts it in;
* every recorded ``ft.*`` name is one of ``SPANS``, and each of ``SPANS``
  shows up on one of the two envs;
* with no profiler, ``record_function`` is never entered;
* a step's outputs are bit-identical with and without the profiler, from
  the same state.
"""

from collections import Counter

import pytest
import torch

import furniture_tpu_torch as ft
from furniture_tpu_torch.config import SimConfig
from furniture_tpu_torch.utils.trace import SPANS

torch.set_num_threads(1)

FAST = SimConfig(control_freq=100)
B = 2

# (span, the innermost ft.* span around it) of one VecEnv.step on which no
# env finishes; None: no ft.* span around it
EXPECTED = {
    "cursor": Counter({
        ("ft.vec.step", None): 1,
        ("ft.env.step", "ft.vec.step"): 1,
        ("ft.env.control", "ft.env.step"): 1,
        ("ft.env.connect", "ft.env.control"): 1,     # the connect attempt
        ("ft.env.physics", "ft.env.step"): 1,        # n substeps
        ("ft.env.connect", "ft.env.step"): 1,        # the post-connect snap
        ("ft.env.physics", "ft.env.connect"): 1,     # its 1-substep launch
        ("ft.env.finish", "ft.env.step"): 1,
        ("ft.env.observe", "ft.env.finish"): 1,
        ("ft.vec.sync", "ft.vec.step"): 1,
    }),
    "sawyer": Counter({
        ("ft.vec.step", None): 1,
        ("ft.env.step", "ft.vec.step"): 1,
        ("ft.env.control", "ft.env.step"): 1,
        ("ft.env.dynamics", "ft.env.step"): 1,
        ("ft.env.physics", "ft.env.step"): 1,
        ("ft.env.connect", "ft.env.step"): 1,
        ("ft.env.finish", "ft.env.step"): 1,
        ("ft.env.observe", "ft.env.finish"): 1,
        ("ft.vec.sync", "ft.vec.step"): 1,
    }),
}


@pytest.fixture(scope="module")
def vecs():
    out = {
        "cursor": ft.make_vec_env("IKEACursor-v0", B, seed=1, device="cpu", sim=FAST),
        "sawyer": ft.make_vec_env("IKEASawyer-v0", B, seed=2, device="cpu", sim=FAST,
                                  control_type="impedance"),
    }
    for v in out.values():
        v.reset()
    return out


def _action(vec, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, vec.env.dof), generator=g) * 2.0 - 1.0


def _profiled_step(vec, action):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = vec.step(action)
    return out, prof


def _span_tree(prof):
    """[(name, innermost ft.* ancestor or None)] of the recorded ft.* events."""
    out = []
    for e in prof.events():
        if not e.name.startswith("ft."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("ft."):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _flat(out, state):
    obs, rew, done, info = out
    leaves = [rew, done] + [obs[k] for k in sorted(obs)] + [info[k] for k in sorted(info)]

    def walk(x):
        if isinstance(x, tuple):
            return [y for f in x for y in walk(f)]
        return [x]

    return leaves + walk(state)


@pytest.mark.parametrize("name", ["cursor", "sawyer"])
def test_spans_nest_as_the_layer_table_says(vecs, name):
    vec = vecs[name]
    out, prof = _profiled_step(vec, _action(vec, 3))
    assert not bool(out[2].any())      # no auto-reset in this step
    assert Counter(_span_tree(prof)) == EXPECTED[name]


def test_every_span_is_named_in_spans_and_each_shows_up(vecs):
    seen = set()
    for name, vec in vecs.items():
        _, prof = _profiled_step(vec, _action(vec, 4))
        names = {n for n, _ in _span_tree(prof)}
        assert names <= set(SPANS), names - set(SPANS)
        seen |= names
    assert seen == set(SPANS)


@pytest.mark.parametrize("name", ["cursor", "sawyer"])
def test_no_profiler_no_record_function(vecs, name, monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    vec = vecs[name]
    vec.step(_action(vec, 5))


@pytest.mark.parametrize("name", ["cursor", "sawyer"])
def test_outputs_bit_identical_with_and_without_profiler(vecs, name):
    vec = vecs[name]
    a = _action(vec, 6)
    start = vec.state
    traced, _ = _profiled_step(vec, a)
    traced = _flat(traced, vec.state)
    vec._state = start
    plain = _flat(vec.step(a), vec.state)
    assert len(traced) == len(plain)
    for x, y in zip(traced, plain):
        assert x.dtype == y.dtype and torch.equal(x, y)
