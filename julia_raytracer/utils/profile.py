"""Device time by named scope, from a `jax.profiler` trace.

A kernel event in the trace names the HLO instruction it runs (stat
`hlo_op`). The compiled HLO text maps each instruction to its
`op_name` metadata, which carries the `jax.named_scope` stack. An
instruction belongs to a scope when its op_name contains the scope, or
when it lives in a computation reachable from one that does (the body
and condition of a scoped while loop, fused computations, calls).
"""

from __future__ import annotations

import glob
import os
import re

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")  # unindented
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_REF_RE = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_DEDUP_RE = re.compile(r'deduplicated_name="([^"]*)"')


def _kernel_name(line: str, name: str) -> str:
    """The GPU kernel an instruction launches: XLA names it after the
    instruction, or after the instruction it was deduplicated with,
    "." replaced by "_"."""
    d = _DEDUP_RE.search(line)
    return (d.group(1) if d else name).replace(".", "_")


def hlo_instruction_scopes(hlo_text: str, scopes, kernels: dict | None = None
                           ) -> dict[str, str]:
    """{instruction name: scope} for every instruction of `hlo_text`
    that belongs to one of `scopes` (first match wins). When `kernels`
    is a dict, it is filled with {kernel name: scope}; a kernel shared
    by instructions of different scopes (or of none) maps to "other"."""
    comp_instrs: dict[str, list] = {}
    kernel_of: dict[str, str] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line)
        if m:
            comp = m.group(1)
            comp_instrs[comp] = []
            continue
        m = _INSTR_RE.match(line)
        if m and comp is not None:
            op = _OPNAME_RE.search(line)
            refs = _REF_RE.findall(line)
            for br in _BRANCH_RE.findall(line):
                refs += [r.strip().lstrip("%") for r in br.split(",") if r.strip()]
            comp_instrs[comp].append((m.group(1), op.group(1) if op else "", refs))
            kernel_of[m.group(1)] = _kernel_name(line, m.group(1))
    out: dict[str, str] = {}
    for scope in scopes:
        reach, todo = set(), []
        for instrs in comp_instrs.values():
            for _name, op, refs in instrs:
                if scope in op:
                    todo += refs
        while todo:
            c = todo.pop()
            if c in reach or c not in comp_instrs:
                continue
            reach.add(c)
            for _n, _o, refs in comp_instrs[c]:
                todo += refs
        for c, instrs in comp_instrs.items():
            for name, op, _refs in instrs:
                if name not in out and (scope in op or c in reach):
                    out[name] = scope
    if kernels is not None:
        for name, kernel in kernel_of.items():
            sc = out.get(name, "other")
            kernels[kernel] = sc if kernels.get(kernel, sc) == sc else "other"
    return out


def latest_xplane(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def device_time_by_scope(xplane_path: str, hlo_text: str, scopes,
                         plane_prefix: str = "/device:GPU") -> dict:
    """Sum of kernel durations (ns) per scope over the planes whose name
    starts with `plane_prefix`; "other" takes the rest, "total" all.
    "top" lists (kernel, ns, scope) for every kernel, most time first.

    An event is matched by its `hlo_op` stat, or, when that names no
    instruction (kernels XLA launches from a CUDA graph report the
    graph's `command_buffer`), by its kernel name (`_kernel_name`)."""
    from jax.profiler import ProfileData

    by_kernel: dict[str, str] = {}
    instr_scope = hlo_instruction_scopes(hlo_text, scopes, by_kernel)
    sums = {s: 0 for s in scopes}
    sums["other"] = 0
    per_kernel: dict[str, int] = {}
    n_events = 0
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op")
                if op is None:
                    continue
                n_events += 1
                op = str(op)
                key = op if op in instr_scope else str(ev.name)
                scope = instr_scope.get(op) or by_kernel.get(key, "other")
                sums[scope] += int(ev.duration_ns)
                per_kernel[key] = per_kernel.get(key, 0) + int(ev.duration_ns)
    sums["total"] = sum(sums.values())
    sums["events"] = n_events
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    sums["top"] = [(k, ns, instr_scope.get(k) or by_kernel.get(k, "other"))
                   for k, ns in top]
    return sums
