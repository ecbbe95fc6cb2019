"""Compile-level evidence for the halo-exchange schedule on the GPU.

Several cards are not needed to see what a multi-card run compiles: the
runners are exported for CUDA from this CPU-mesh process
(``jax.export(..., platforms=["cuda"])``), which is the StableHLO a real
multi-GPU run hands to XLA, whose collectives go to NCCL. For each layout
the step loop must hold exactly the designed collective permutes and no
reduction, and the whole program exactly the deferred psum(s) after the
loop (the analog of the reference's single post-loop MPI_Reduce,
d2q9-bgk.c:396). No hand-written kernel (custom call) may sit in the loop:
the step is plain XLA.
"""

import re

import jax.export as je
import jax.numpy as jnp
import numpy as np
import pytest

from tpulbm.core.params import LBMParams
from tpulbm.core.state import initial_state
from tpulbm.dist.mesh import get_mesh, get_mesh_2d
from tpulbm.dist.runner import make_runner
from tpulbm.dist.sharding import shard_arrays


def _export_cuda(ny, nx, mesh, n=8):
    params = LBMParams(nx=nx, ny=ny, max_iters=n, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(0)
    mask = rng.rand(ny, nx) < 0.05
    params = params.with_free_cells(ny * nx - int(mask.sum()))
    run = make_runner(params, n, mesh)
    f, obst = shard_arrays(mesh, initial_state(params), jnp.asarray(mask))
    exp = je.export(run, platforms=["cuda"])(f, obst)
    assert exp.platforms == ("cuda",)
    return exp.mlir_module()


def _balanced(txt, i):
    depth = 0
    for j in range(i, len(txt)):
        if txt[j] == "{":
            depth += 1
        elif txt[j] == "}":
            depth -= 1
            if depth == 0:
                return txt[i:j + 1], j
    raise ValueError("unbalanced region")


def _functions(txt):
    funcs = {}
    for m in re.finditer(r"func\.func\s+(?:private\s+)?@([\w$.]+)", txt):
        funcs[m.group(1)], _ = _balanced(txt, txt.index("{", m.end()))
    return funcs


def step_loop_region(txt):
    """Transitive text of every stablehlo.while DO body plus the functions
    it calls — the step loop as lowered (jax.lax.scan -> while + outlined
    scan-body function)."""
    funcs = _functions(txt)
    regions = []
    for m in re.finditer(r"stablehlo\.while", txt):
        _, jend = _balanced(txt, txt.index("{", m.start()))  # cond region
        mm = re.match(r"\s*do\s*\{", txt[jend + 1:])
        assert mm, "stablehlo.while without a do region"
        body, _ = _balanced(txt, jend + 1 + mm.end() - 1)
        regions.append(body)
    seen, out, stack = set(), [], list(regions)
    while stack:
        r = stack.pop()
        out.append(r)
        for cm in re.finditer(r"call\s+@([\w$.]+)", r):
            fn = cm.group(1)
            if fn not in seen and fn in funcs:
                seen.add(fn)
                stack.append(funcs[fn])
    assert out, "no step loop found in the module"
    return "\n".join(out)


def _counts(region):
    return {
        "collective_permute": len(re.findall(r"collective_permute", region)),
        "all_reduce": len(re.findall(r"all_reduce", region)),
        "all_gather": len(re.findall(r"all_gather", region)),
        "all_to_all": len(re.findall(r"all_to_all", region)),
        "custom_call": len(re.findall(r"custom_call", region)),
    }


# (id, ny, nx, mesh shape, permutes in the loop, psums after it)
CASES = [
    ("ring-1", 96, 128, (1,), 0, 0),
    ("ring-2", 96, 128, (2,), 2, 1),
    ("ring-4", 96, 128, (4,), 2, 1),
    ("ring-8", 96, 128, (8,), 2, 1),
    ("padded-2", 95, 100, (2,), 2, 1),
    ("padded-3", 94, 128, (3,), 2, 1),
    ("padded-4", 94, 128, (4,), 2, 1),
    ("padded-8", 94, 128, (8,), 2, 1),
    ("torus-2x2", 16, 128, (2, 2), 4, 2),
    ("torus-2x4", 16, 128, (2, 4), 4, 2),
    ("torus-4x2", 16, 128, (4, 2), 4, 2),
]


@pytest.mark.parametrize(
    "ny,nx,shape,loop_permutes,psums", [c[1:] for c in CASES],
    ids=[c[0] for c in CASES],
)
def test_step_loop_collectives(ny, nx, shape, loop_permutes, psums):
    mesh = (get_mesh(n_devices=shape[0]) if len(shape) == 1
            else get_mesh_2d(*shape))
    txt = _export_cuda(ny, nx, mesh)
    loop = _counts(step_loop_region(txt))
    # the designed halo exchange per step (one row each way per sharded
    # axis), no reduction inside the loop, and no hand-written kernel
    assert loop["collective_permute"] == loop_permutes, loop
    assert loop["all_reduce"] == loop["all_gather"] == 0, loop
    assert loop["all_to_all"] == loop["custom_call"] == 0, loop
    mod = _counts(txt)
    # the whole program: the loop's permutes, and the deferred psum(s) of
    # the |u| series after it (one per sharded mesh axis)
    assert mod["collective_permute"] == loop_permutes, mod
    assert mod["all_reduce"] == psums, mod
