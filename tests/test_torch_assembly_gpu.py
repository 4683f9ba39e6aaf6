"""PyTorch port: the connect kernel (``physics/csrc/assembly.cu``) against
its plain version, on the card.

Card-only (``gpu`` marker): each test skips itself without a CUDA card,
since a CUDA kernel has no CPU form. The file imports neither JAX nor the
JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_assembly_gpu.py

The cells' random actions rarely connect, so the kernel is held on staged
states (``torch_gpu_holds.staged_connects``: site pairs placed as
``preassemble`` places them, inside and outside each alignment threshold,
with groups welded first, envs lowered under the floor, presses off and
cursors letting go) at the cells' shapes (table_lack with the cursor at
B = 4096 and an arm at B = 512, swivel_chair with two arms at B = 512) and
on the models with the most sites (``bookcase_besta_0170``, C = 40, where a
site pair can lack a weld row) and weld rows (``bookcase_billy_0191``,
W = 37). Against the plain version on the card (``plain_attempt``,
``plain_snap_move``): where nothing connects, every output equals its input
bit for bit but the attempt counter; the discrete outputs equal; the floats
within 1e-5; one launch counted per call, none synchronising the host; two
launches bit-identical. Then the cursor's and Sawyer's main paths: one step
adds two launches (the attempt and the snap-back move) on the cursor, one
on the arm, and the step (the arm's up to its observation) makes no host
synchronisation.
"""

import pytest
import torch
from torch_gpu_holds import card, staged_connects

from furniture_tpu_torch.envs.assembly import AssemblyOps

FLOAT_TOL = 1e-5

# (furniture, B, arms: 0 for the cursor's held parts)
CASES = {
    "cursor-table_lack-b4096": ("table_lack_0825", 4096, 0),
    "sawyer-table_lack-b512": ("table_lack_0825", 512, 1),
    "baxter-swivel_chair-b512": ("swivel_chair_0700", 512, 2),
    "cursor-besta-b4096": ("bookcase_besta_0170", 4096, 0),
    "sawyer-billy-b512": ("bookcase_billy_0191", 512, 1),
}


def leaves(x):
    return [t for f in x for t in leaves(f)] if isinstance(x, tuple) else [x]


def rows_equal(a, b):
    """[B]: every entry of the env's row equal, bit for bit."""
    B = a.shape[0]
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
    return same.reshape(B, -1).all(1)


def on_card(x, dev):
    return type(x)(*(on_card(t, dev) for t in x)) if isinstance(x, tuple) else x.to(dev)


def launch(ops, fn, *args, **kw):
    """``fn`` once, with no host synchronisation, and the launches it added."""
    before = ops.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, ops.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_connect_kernel_matches_plain(case):
    dev = card()
    name, B, arms = CASES[case]
    cpu_ops, st, connect, held, touch, staged = staged_connects(name, B, seed=B + arms, arms=arms)
    ops = AssemblyOps(cpu_ops.model, cpu_ops.config, dev)
    st, connect = on_card(st, dev), connect.to(dev)
    held = None if held is None else held.to(dev)
    touch = None if touch is None else tuple(t.to(dev) for t in touch)
    kw = dict(held=held, touch=touch, num_connect_steps=0 if arms else None, snap_back=bool(arms))

    (got, got_held), n = launch(ops, ops.attempt, st, connect, **kw)
    assert n == 1
    again, again_held = ops.attempt(st, connect, **kw)
    want, want_held = ops.plain_attempt(st, connect, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))
    if arms:
        assert got_held is None and want_held is None
    else:
        assert torch.equal(got_held, want_held) and torch.equal(again_held, got_held)

    fields = ["pos", "quat", "lin_vel", "ang_vel"] + list(st._fields[1:])
    for f, g, w in zip(fields, leaves(got), leaves(want)):
        if g.is_floating_point():
            gap = (g - w).abs().max().item()
            assert gap <= FLOAT_TOL, (case, f, gap)
        else:
            assert torch.equal(g, w), (case, f, (g != w).reshape(B, -1).any(1).nonzero()[:8, 0].tolist())

    # where nothing connects, the state passes through but the counter
    snapped = want.num_connected > st.num_connected
    moved = want.connect_step > 0
    back = (st.connected_body1 >= 0) if arms else torch.zeros_like(snapped)
    miss = ~snapped & ~moved & ~back
    for f, g, x in zip(fields, leaves(got), leaves(st)):
        if f == "connect_step":
            assert bool((g[miss] == 0).all())
        else:
            assert bool(rows_equal(g, x)[miss].all()), (case, f)

    # what the staged batch reached
    gate = connect > 0
    gate &= (held >= 0).all(1) if held is not None else (touch[0] & touch[1]).any(2).any(1)
    welded_before = (st.group != torch.arange(st.group.shape[1], device=dev)).any(1)
    lifted = snapped & (want.parts.pos[..., 2] > st.parts.pos[..., 2] + 1e-4).any(1) & (
        (st.parts.pos[..., 2] < 0).any(1))
    no_row = snapped & (want.weld_active == st.weld_active).all(1)
    last = snapped & (want.subtask == -1).all(1)
    reached = {"snap": snapped, "miss": miss & gate & staged.to(dev), "gate off": ~gate,
               "merge of a welded group": snapped & welded_before, "floor lift": lifted}
    if not arms:
        reached["interpolation"] = moved
    if name == "bookcase_besta_0170":
        reached["weld_lookup -1"] = no_row
    if name in ("table_lack_0825", "swivel_chair_0700"):
        reached["last weld"] = last
    counts = {k: int(v.sum()) for k, v in reached.items()}
    assert min(counts.values()) >= 1, (case, counts)

    # the cursor's snap-back move, with and without a snap-back in the env
    b1 = torch.where(torch.arange(B, device=dev) % 2 == 0, want.connected_body1,
                     torch.randint(0, st.group.shape[1], (B,), device=dev, dtype=torch.int32))
    sb = want._replace(connected_body1=b1)
    moved_parts, n = launch(ops, ops.snap_move, sb)
    assert n == 1
    for g, w in zip(moved_parts, ops.plain_snap_move(sb)):
        assert (g - w).abs().max().item() <= FLOAT_TOL, case


# (env id, control type, B): the cursor's and Sawyer's cells
MAIN_PATHS = {"cursor-b4096": ("IKEACursor-v0", None, 4096),
              "sawyer-impedance-b512": ("IKEASawyer-v0", "impedance", 512)}


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(MAIN_PATHS))
def test_step_batch_connect_launches(path):
    """Two steps of uniform random actions through ``step_batch``: each adds
    two connect-kernel launches on the cursor (the attempt, the snap-back
    move) and one on the arm (the attempt with its snap-back), and none
    synchronises the host (the arm's step up to its observation, whose
    ``convert_quat`` synchronises by design)."""
    import furniture_tpu_torch as ft

    dev = card()
    env_id, control_type, B = MAIN_PATHS[path]
    kw = {"control_type": control_type} if control_type else {}
    env = ft.make_vec_env(env_id, num_envs=B, seed=0, **kw).env
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    s = env.reset_batch(B, gen)
    per_step = 1 if control_type else 2
    for _ in range(2):
        a = torch.rand((B, env.dof), generator=gen, device=dev) * 2 - 1
        fn = env._step_physics_batch if control_type else env.step_batch
        out, n = launch(env.ops, fn, s, a)
        assert n == per_step, (path, n)
        s = out if control_type else out[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(s.parts.pos).all())
