"""G009: no host sync inside a ``# gridlint: resident-path`` function
(the port's counterpart of the JAX package's
``analysis/rules_resident.py``).

The chunked service step exists to confine host round trips to chunk
boundaries: the macro-step issues ``chunk`` steps without waiting for
the device, every per-step observable collected on the device as the
chunk's ys. A host sync slipped into the macro body re-introduces the
per-step stall while every test still passes bit for bit. A function
opts in with the marker on the line directly above its ``def``::

    # gridlint: resident-path
    def macro(pos, vel, ids, count):
        ...

Inside a marked function (lexically, nested defs and lambdas included)
the rule flags ``np.asarray`` / bare ``asarray``; ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``; ``torch.cuda.synchronize``;
and ``float()`` / ``int()`` / ``bool()`` of a non-literal. Like the
reference's, the check is lexical: helpers called from the body are not
scanned (G002 follows the calls; progcheck's J002 counts the reads a
call really makes).
"""

from __future__ import annotations

import ast
from typing import List

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    Finding,
    Project,
    call_name,
    finding_at,
    last_attr,
    marked,
    marker_re,
    rule,
)

_MARKER_RE = marker_re("resident-path")
_NUMPY_HEADS = ("np", "numpy")
_READ_METHODS = ("item", "tolist", "cpu", "numpy")
_CAST_NAMES = ("float", "int", "bool")


def _is_host_asarray(name: str) -> bool:
    if not name or last_attr(name) != "asarray":
        return False
    head = name.split(".", 1)[0]
    return head == "asarray" or head in _NUMPY_HEADS


@rule("G009")
def check_resident(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules:
        for fi in mod.functions.values():
            if not marked(fi, _MARKER_RE):
                continue
            for call in ast.walk(fi.node):
                if not isinstance(call, ast.Call):
                    continue
                name = call_name(call) or ""
                if _is_host_asarray(name):
                    findings.append(finding_at(
                        fi, call, "G009",
                        "np.asarray inside a resident-path function — a "
                        "device-to-host copy in the chunk interior; read "
                        "observables from the chunk's ys at its boundary"))
                elif (isinstance(call.func, ast.Attribute)
                      and call.func.attr in _READ_METHODS
                      and not call.args):
                    findings.append(finding_at(
                        fi, call, "G009",
                        f".{call.func.attr}() inside a resident-path "
                        f"function — a host read in the chunk interior; "
                        f"the driver reads once a chunk, at the boundary"))
                elif name == "torch.cuda.synchronize":
                    findings.append(finding_at(
                        fi, call, "G009",
                        "torch.cuda.synchronize inside a resident-path "
                        "function — a barrier in the chunk interior; the "
                        "driver waits once a chunk, at the boundary"))
                elif name in _CAST_NAMES:
                    arg = call.args[0] if call.args else None
                    if arg is not None and not isinstance(arg, ast.Constant):
                        findings.append(finding_at(
                            fi, call, "G009",
                            f"{name}() of a non-literal inside a "
                            f"resident-path function — a host read if it "
                            f"is a tensor; carry the value in the ys and "
                            f"convert at the chunk boundary"))
    return findings
