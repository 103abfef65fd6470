"""Trace reduction (utils/profile.py): device time attributed to named
scopes through the compiled HLO, checked on a small CPU trace."""

import jax
import jax.numpy as jnp

from julia_raytracer.utils.profile import (
    device_time_by_scope, hlo_instruction_scopes, latest_xplane,
)


def _f(x):
    with jax.named_scope("bvh_traversal"):
        y = jax.lax.while_loop(lambda s: s[1] < 10,
                               lambda s: (jnp.sin(s[0]) * 2, s[1] + 1), (x, 0))[0]
    with jax.named_scope("shading"):
        return jnp.cos(y).sum()


def test_scopes_cover_while_body_and_fusions():
    x = jnp.ones(1000)
    hlo = jax.jit(_f).lower(x).compile().as_text()
    scopes = hlo_instruction_scopes(hlo, ["bvh_traversal", "shading"])
    whiles = [n for n in scopes if n.startswith("while")]
    assert whiles and all(scopes[n] == "bvh_traversal" for n in whiles)
    assert "bvh_traversal" in scopes.values() and "shading" in scopes.values()
    # an instruction with no scope in its op_name is not attributed
    assert all(v in ("bvh_traversal", "shading") for v in scopes.values())


def test_device_time_by_scope_on_cpu_trace(tmp_path):
    f = jax.jit(_f)
    x = jnp.ones(200_000)
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    hlo = f.lower(x).compile().as_text()
    t = device_time_by_scope(latest_xplane(str(tmp_path)), hlo,
                             ["bvh_traversal"], plane_prefix="/host:CPU")
    assert t["events"] > 0 and t["total"] > 0
    assert t["bvh_traversal"] > 0
    assert t["total"] == t["bvh_traversal"] + t["other"]
    assert t["top"][0][1] >= t["top"][-1][1]


def test_kernel_names_follow_deduplication():
    """Kernels launched from CUDA graphs are matched by kernel name: the
    instruction's, or the one it was deduplicated with, "." -> "_"; a
    kernel shared across scopes is not attributed to either."""
    hlo = "\n".join([
        "%body (p: f32[4]) -> f32[4] {",
        '  %loop_fusion.3 = f32[4] fusion(%p), metadata={op_name="jit(f)/bvh_traversal/while/body/mul"}',
        '  %loop_fusion.7 = f32[4] fusion(%p), metadata={op_name="jit(f)/bvh_traversal/while/body/add"} deduplicated_name="loop_fusion.3"',
        "}",
        "ENTRY %main (x: f32[4]) -> f32[4] {",
        '  %w = f32[4] while(%x), body=%body, metadata={op_name="jit(f)/bvh_traversal/while"}',
        '  %loop_fusion.9 = f32[4] fusion(%w), metadata={op_name="jit(f)/shading/cos"} deduplicated_name="input_fusion.2"',
        '  %input_fusion.2 = f32[4] fusion(%w), metadata={op_name="jit(f)/bvh_traversal/x"}',
        "}",
    ])
    kernels = {}
    scopes = hlo_instruction_scopes(hlo, ["bvh_traversal"], kernels)
    assert scopes["loop_fusion.7"] == "bvh_traversal" and "loop_fusion.9" not in scopes
    assert kernels["loop_fusion_3"] == "bvh_traversal"
    assert kernels["input_fusion_2"] == "other"  # shared by two scopes
