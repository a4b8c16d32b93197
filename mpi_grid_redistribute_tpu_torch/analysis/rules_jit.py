"""G002/G003: host reads on the step path (the port's counterpart of the
JAX package's ``analysis/rules_jit.py``; its scope is what ``jax.jit``
traces, the port's is the step path, :meth:`.core.Project.
step_functions`: the functions marked ``resident-path`` or
``fastpath-engine`` and everything they reach).

G002: a host read of a tensor waits for the device, so one in a step
serializes the host's issue of every later step behind the device:

* ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()``;
* ``torch.cuda.synchronize()``;
* ``int()`` / ``float()`` / ``bool()`` of a tensor (the taint pass of
  :func:`.core.tainted_names`);
* ``telemetry.phases.host_read``, the counted read of a guard.

G003: a data-dependent output shape makes the host wait for the size
(and cannot be captured in a CUDA graph), the dynamic-shape escape the
reference's capacity-padded design rules out:

* ``nonzero`` / ``argwhere`` / ``unique`` / ``unique_consecutive`` /
  ``masked_select``, and one-argument ``torch.where(cond)``;
* boolean-mask indexing ``x[mask]`` with a comparison on tensors.

Sanctioned reads (the one guard a step reads, a kernel's plain version
that stands in for a launch on the CPU) carry an inline
``# gridlint: disable=G002`` or ``G003`` with the reason.
"""

from __future__ import annotations

import ast
from typing import List, Set

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Project,
    call_name,
    expr_mentions_tainted,
    finding_at,
    last_attr,
    rule,
    tainted_names,
)

_READ_METHODS = ("item", "tolist", "cpu", "numpy")
_SIZED = ("nonzero", "argwhere", "unique", "unique_consecutive",
          "masked_select")


@rule("G002")
def check_host_reads(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.step_functions():
        taint = tainted_names(fi)
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _READ_METHODS and not node.args
                    and expr_mentions_tainted(node.func.value, taint)):
                findings.append(finding_at(
                    fi, node, "G002",
                    f".{node.func.attr}() on the step path reads the "
                    f"device from the host and waits for it; keep the "
                    f"value on the device and read it at the chunk "
                    f"boundary"))
            elif last_attr(name) == "host_read":
                findings.append(finding_at(
                    fi, node, "G002",
                    "host_read() on the step path reads the device from "
                    "the host and waits for it; keep the value on the "
                    "device and read it at the chunk boundary"))
            elif name == "torch.cuda.synchronize":
                findings.append(finding_at(
                    fi, node, "G002",
                    "torch.cuda.synchronize on the step path blocks the "
                    "host until the device drains; synchronize once, "
                    "after the step"))
            elif (name in ("int", "float", "bool") and len(node.args) == 1
                  and expr_mentions_tainted(node.args[0], taint)):
                findings.append(finding_at(
                    fi, node, "G002",
                    f"{name}() of a tensor on the step path is a host "
                    f"read; compute with a dtype cast on the device "
                    f"instead"))
    return findings


def _comparison_masks(fi: FunctionInfo, taint: Set[str]) -> Set[str]:
    """Local names assigned a comparison on tensors (boolean masks)."""
    out: Set[str] = set()
    for stmt in ast.walk(fi.node):
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, (ast.Compare, ast.BoolOp))
                and expr_mentions_tainted(stmt.value, taint)):
            out.add(stmt.targets[0].id)
    return out


@rule("G003")
def check_dynamic_shapes(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.step_functions():
        taint = tainted_names(fi)
        masks = _comparison_masks(fi, taint)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                name = call_name(node) or ""
                tail = last_attr(name)
                is_torch = name.split(".", 1)[0] == "torch"
                method = (isinstance(node.func, ast.Attribute)
                          and expr_mentions_tainted(node.func.value, taint))
                if tail in _SIZED and (is_torch or method):
                    findings.append(finding_at(
                        fi, node, "G003",
                        f"{tail} has a data-dependent output shape: the "
                        f"host waits for its size; select with "
                        f"torch.where at a fixed capacity instead"))
                elif (name == "torch.where" and len(node.args) == 1
                      and not node.keywords):
                    findings.append(finding_at(
                        fi, node, "G003",
                        "one-argument torch.where is nonzero in disguise: "
                        "a data-dependent output shape; use the "
                        "three-argument select form"))
            elif isinstance(node, ast.Subscript):
                sl = node.slice
                is_mask = isinstance(sl, (ast.Compare, ast.BoolOp)) or (
                    isinstance(sl, ast.UnaryOp)
                    and isinstance(sl.op, (ast.Not, ast.Invert)))
                if not is_mask and isinstance(sl, ast.Name):
                    is_mask = sl.id in masks
                if (is_mask and expr_mentions_tainted(sl, taint)
                        and expr_mentions_tainted(node.value, taint)):
                    findings.append(finding_at(
                        fi, node, "G003",
                        "boolean-mask indexing of a tensor has a "
                        "data-dependent result shape; use torch.where "
                        "masking or a stable pack at fixed capacity"))
    return findings
