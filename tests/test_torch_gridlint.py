"""The port's share of gridlint (``analysis/core.py``'s rule driver,
``analysis/cli.py``, ``analysis/rules_*.py``) against the JAX package's
gridlint, mirroring ``tests/test_gridlint.py`` by name where a case
carries over.

Each case is a pair of fixture sources, one in jax spelling for the
reference's gridlint and one in torch spelling for the port's, and both
must give the same ``(rule, symbol)`` findings: a firing pair and a quiet
pair a rule. The reference's gridlint runs in-process (pure AST). Then
the port's tree: clean against a baseline whose entries all carry a
justification, with the reference's markers on their counterparts.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from mpi_grid_redistribute_tpu.analysis.core import (
    run_gridlint as ref_run_gridlint,
)
from mpi_grid_redistribute_tpu_torch.analysis import cli, core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mpi_grid_redistribute_tpu_torch")


def _lint(run, tmp_path, files, rules):
    for name, src in files.items():
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return run([str(tmp_path)], root=str(tmp_path), rules=rules)


def pair(tmp_path, jax_files, torch_files, rules):
    """``(reference findings, port findings)`` of the two spellings."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _lint(ref_run_gridlint, tmp_path / "jax", jax_files, rules)
    port = _lint(core.run_gridlint, tmp_path / "torch", torch_files, rules)
    return ref, port


def keys(findings):
    return sorted((f.rule, f.symbol) for f in findings)


def assert_same(tmp_path, jax_files, torch_files, rules, n):
    ref, port = pair(tmp_path, jax_files, torch_files, rules)
    assert keys(ref) == keys(port), (ref, port)
    assert len(port) == n, port
    return port


# ---------------------------------------------------------------- G002


def test_g002_fires_on_host_syncs_in_step_code(tmp_path):
    port = assert_same(tmp_path, {"mod.py": """
        import jax
        import numpy as np

        @jax.jit
        def step(x):
            n = int(x)            # host sync
            jax.device_get(x)
            return x.item() + n + np.asarray(x).sum()
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def step(x):
            n = int(x)            # host read
            torch.cuda.synchronize()
            return x.item() + n + x.cpu().sum()
        """}, ["G002"], 4)
    assert {f.symbol for f in port} == {"step"}


def test_g002_quiet_on_static_annotated_params_and_host_fns(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax
        import numpy as np

        @jax.jit
        def step(x, n_steps: int, scale: float):
            return x * float(scale) * int(n_steps)

        def host_only(x):
            return float(np.asarray(x).sum())
        """}, {"mod.py": """
        # gridlint: fastpath-engine
        def step(x, n_steps: int, scale: float):
            return x * float(scale) * int(n_steps) * x.shape[0]

        def host_only(x):
            return float(x.sum().item())
        """}, ["G002"], 0)


def test_g002_reaches_through_builders_and_helpers(tmp_path):
    port = assert_same(tmp_path, {"mod.py": """
        import jax

        def helper(x):
            return x.item()

        def build():
            def call(x):
                return helper(x)

            return jax.jit(call)
        """}, {"mod.py": """
        def helper(x):
            return x.item()

        def build():
            # gridlint: resident-path
            def call(x):
                return helper(x)

            return call
        """}, ["G002"], 1)
    assert port[0].symbol == "helper"


def test_g002_fires_on_an_unsanctioned_counted_read(tmp_path):
    """The port's counted guard read (``telemetry.phases.host_read``) is a
    host read like ``bool()``: on the step path it needs a sanction of
    its own, the reference's counterpart a ``device_get``."""
    port = assert_same(tmp_path, {"mod.py": """
        import jax

        @jax.jit
        def step(x):
            jax.device_get(x)
            return x
        """}, {"mod.py": """
        from phases import host_read

        SYNCS = {"guard": 0}

        # gridlint: fastpath-engine
        def step(x):
            host_read(SYNCS, "guard", x)
            host_read(SYNCS, "guard", x)  # gridlint: disable=G002
            return x
        """}, ["G002"], 1)
    assert port[0].symbol == "step"


# ---------------------------------------------------------------- G003


def test_g003_fires_on_dynamic_shapes(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def pick(x):
            idx = jnp.nonzero(x > 0)
            hits = jnp.where(x > 1)
            return x[x > 0], idx, hits
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def pick(x):
            idx = torch.nonzero(x > 0)
            hits = torch.where(x > 1)
            return x[x > 0], idx, hits
        """}, ["G003"], 3)


def test_g003_quiet_on_sized_and_select_forms(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def pick(x, cap: int):
            idx = jnp.nonzero(x > 0, size=cap, fill_value=0)
            sel = jnp.where(x > 1, x, 0)
            return idx, sel
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def pick(x, cap: int):
            sel = torch.where(x > 1, x, 0)
            return torch.sort(sel).values[:cap], sel
        """}, ["G003"], 0)


# ---------------------------------------------------------------- G004


def test_g004_fires_on_unguarded_fuse(tmp_path):
    src = """
        from pack import fuse_fields

        def ship(positions, fields):
            return fuse_fields(positions, fields)
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G004"], 1)


def test_g004_fires_on_unguarded_reinterpretation(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax.numpy as jnp
        from jax import lax

        def entry(x):
            return lax.bitcast_convert_type(x, jnp.uint32)
        """}, {"mod.py": """
        import torch

        def entry(x):
            return x.view(torch.int32)
        """}, ["G004"], 1)


def test_g004_quiet_when_guard_in_callee_or_caller(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax.numpy as jnp
        from jax import lax

        def fuse_fields(positions, fields):
            if positions.dtype.itemsize != 4:
                raise ValueError("4-byte rows only")
            return positions

        def ship(positions, fields):
            return fuse_fields(positions, fields)

        def entry(x):
            if x.dtype.itemsize != 4:
                raise ValueError
            return lax.bitcast_convert_type(x, jnp.uint32)
        """}, {"mod.py": """
        import torch

        def fuse_fields(positions, fields):
            if positions.element_size() != 4:
                raise ValueError("4-byte rows only")
            return positions

        def ship(positions, fields):
            return fuse_fields(positions, fields)

        def entry(x):
            if x.dtype.itemsize != 4:
                raise ValueError
            return x.view(torch.int32)
        """}, ["G004"], 0)


# ---------------------------------------------------------------- G006


def test_g006_fires_on_sort_and_arange_take_in_marked_fn(tmp_path):
    port = assert_same(tmp_path, {"mod.py": """
        import jax.numpy as jnp

        # gridlint: fastpath-engine
        def fast(x, n):
            y = jnp.sort(x)
            return jnp.take(y, jnp.arange(n))
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def fast(x, n):
            y = torch.sort(x).values
            return y.index_select(0, torch.arange(n))
        """}, ["G006"], 2)
    assert {f.symbol for f in port} == {"fast"}


def test_g006_fires_on_subscript_iota_and_nested_defs(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax.numpy as jnp

        # gridlint: fastpath-engine
        def fast(x, n):
            def inner(y):
                return jnp.argsort(y)
            return x[:, jnp.arange(n)], inner(x)
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def fast(x, n):
            def inner(y):
                return torch.argsort(y)
            return x[:, torch.arange(n)], inner(x)
        """}, ["G006"], 2)


def test_g006_quiet_on_plan_indexed_gather_and_unmarked_fn(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        import jax.numpy as jnp

        # gridlint: fastpath-engine
        def fast(x, plan):
            return jnp.take(x, plan, axis=1)

        def dense(x):
            return jnp.sort(x)
        """}, {"mod.py": """
        import torch

        # gridlint: fastpath-engine
        def fast(x, plan):
            return x.index_select(1, plan)

        def dense(x):
            return torch.sort(x)
        """}, ["G006"], 0)


# ---------------------------------------------------------------- G007


def test_g007_fires_on_device_import_and_sync_in_marked_module(tmp_path):
    assert_same(tmp_path, {"mod.py": """
        # gridlint: scrape-path
        import jax

        def scrape(x):
            return x.block_until_ready()
        """}, {"mod.py": """
        # gridlint: scrape-path
        import torch

        def scrape(x):
            return torch.cuda.synchronize()
        """}, ["G007"], 2)


def test_g007_quiet_without_marker_and_on_clean_marked_module(tmp_path):
    assert_same(tmp_path, {"a.py": """
        import jax
        """, "b.py": """
        # gridlint: scrape-path
        import json
        """}, {"a.py": """
        import torch
        """, "b.py": """
        # gridlint: scrape-path
        import json
        """}, ["G007"], 0)


# ---------------------------------------------------------------- G008


def test_g008_fires_on_bare_except_and_swallowed_handler(tmp_path):
    src = """
        # gridlint: service-path

        def run(step):
            try:
                step()
            except:
                raise
            try:
                step()
            except ValueError:
                pass
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G008"], 2)


def test_g008_quiet_without_marker_and_on_real_handling(tmp_path):
    src = """
        # gridlint: service-path

        def run(step, journal):
            try:
                step()
            except ValueError as e:
                journal(e)
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G008"], 0)


# ---------------------------------------------------------------- G009


def test_g009_fires_on_host_syncs_in_marked_fn(tmp_path):
    port = assert_same(tmp_path, {"mod.py": """
        import numpy as np

        # gridlint: resident-path
        def macro(x):
            a = np.asarray(x)
            x.block_until_ready()
            return float(x) + a
        """}, {"mod.py": """
        import numpy as np
        import torch

        # gridlint: resident-path
        def macro(x):
            a = np.asarray(x)
            torch.cuda.synchronize()
            return float(x) + a
        """}, ["G009"], 3)
    assert {f.symbol for f in port} == {"macro"}


def test_g009_unmarked_fn_and_boundary_code_are_free(tmp_path):
    src = """
        import numpy as np

        def boundary(x):
            return float(np.asarray(x).sum())

        # gridlint: resident-path
        def macro(x, dt):
            return x * 2.0 + float(1)
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G009"], 0)


def test_g009_port_flags_item_in_marked_fn(tmp_path):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        # gridlint: resident-path
        def macro(x):
            return x.sum().item()
        """))
    findings = core.run_gridlint([str(tmp_path)], root=str(tmp_path),
                                 rules=["G009"])
    assert [(f.rule, f.symbol) for f in findings] == [("G009", "macro")]


# ---------------------------------------------------------------- G010


def test_g010_fires_on_marked_fn_without_span(tmp_path):
    src = """
        # gridlint: fastpath-engine
        def fast(x):
            return x

        # gridlint: resident-path
        def macro(x):
            return x
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G010"], 2)


def test_g010_quiet_with_span_even_in_nested_body(tmp_path):
    src = """
        from phases import traced_span

        # gridlint: resident-path
        def macro(x):
            def body(y):
                with traced_span("svc:step"):
                    return y
            return body(x)
        """
    assert_same(tmp_path, {"mod.py": src}, {"mod.py": src}, ["G010"], 0)


# ------------------------------------------- suppressions and baseline


def test_inline_and_file_suppressions(tmp_path):
    src = """
        # gridlint: resident-path
        def macro(x):
            a = x.item()  # gridlint: disable=G009
            return float(x) + a
        """
    ref, port = pair(tmp_path, {"mod.py": src.replace("x.item()", "float(x)")},
                     {"mod.py": src}, ["G009"])
    assert keys(ref) == keys(port) == [("G009", "macro")]
    (tmp_path / "torch" / "mod.py").write_text(
        "# gridlint: disable-file=G009\n"
        + (tmp_path / "torch" / "mod.py").read_text())
    assert core.run_gridlint([str(tmp_path / "torch")],
                             root=str(tmp_path / "torch"),
                             rules=["G009"]) == []


def test_baseline_roundtrip_staleness_and_justification(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        from pack import fuse_fields

        def ship(positions, fields):
            return fuse_fields(positions, fields)
        """))
    bl = str(tmp_path / "bl.json")
    args = [str(tmp_path), "--root", str(tmp_path), "--baseline", bl]
    assert cli.main(args) == 1
    assert cli.main(args + ["--write-baseline"]) == 0
    assert cli.main(args) == 0  # baselined
    capsys.readouterr()
    # --check refuses an entry without a justification
    assert cli.main(args + ["--check"]) == 1
    assert "without a justification" in capsys.readouterr().out
    doc = json.load(open(bl))
    doc["findings"][0]["justification"] = "a fixture"
    json.dump(doc, open(bl, "w"))
    assert cli.main(args + ["--check"]) == 0
    # rewriting keeps the justification of a matching entry
    assert cli.main(args + ["--write-baseline"]) == 0
    assert json.load(open(bl))["findings"][0]["justification"] == "a fixture"
    # the code fixed: the entry is stale
    (tmp_path / "mod.py").write_text("x = 1\n")
    capsys.readouterr()
    assert cli.main(args + ["--check"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    assert cli.main(args + ["--check-baseline"]) == 1


def test_cli_exit_codes_formats_and_rule_list(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(textwrap.dedent("""
        # gridlint: fastpath-engine
        def fast(x):
            return x
        """))
    args = [str(tmp_path), "--root", str(tmp_path), "--no-baseline"]
    assert cli.main(args + ["--rules", "G999"]) == 2
    capsys.readouterr()
    assert cli.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in core.RULE_IDS:
        assert rid in listed
    for rid in core.NOT_APPLICABLE:
        assert f"{rid}  not applicable" in listed
    assert cli.main(args + ["--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["G010"]
    assert cli.main(args + ["--format", "sarif"]) == 1
    run = json.loads(capsys.readouterr().out)["runs"][0]
    assert run["tool"]["driver"]["name"] == "gridlint"
    assert [r["ruleId"] for r in run["results"]] == ["G010"]
    assert cli.main(args + ["--format", "github"]) == 1
    assert capsys.readouterr().out.startswith("::warning ")
    (tmp_path / "bad.py").write_text("def (:\n")
    assert cli.main(args) == 2


# ------------------------------------------------------ the port's tree


def test_exchange_wire_builders_and_migrate_fast_branch_are_marked():
    project = core.build_project([PORT], root=ROOT)
    fast = core.marker_re("fastpath-engine")
    marked = {(fi.module.relpath, fi.qualname) for m in project.modules
              for fi in m.functions.values() if core.marked(fi, fast)}
    pkg = "mpi_grid_redistribute_tpu_torch"
    assert marked == {(f"{pkg}/parallel/exchange.py", "_sparse_wire"),
                      (f"{pkg}/parallel/exchange.py", "_neighbor_wire"),
                      (f"{pkg}/parallel/migrate.py", "_fast_step")}


def test_resident_macros_are_marked():
    project = core.build_project([PORT], root=ROOT)
    res = core.marker_re("resident-path")
    marked = {(fi.module.relpath.rsplit("/", 1)[-1], fi.qualname)
              for m in project.modules for fi in m.functions.values()
              if core.marked(fi, res)}
    assert marked == {("resident.py", "make_chunk_fn.macro"),
                      ("pipeline.py", "make_pipelined_chunk_fn.macro")}


@pytest.mark.parametrize("tag,modules", [
    ("scrape-path", ["telemetry/context.py", "telemetry/metrics.py",
                     "telemetry/probes.py", "telemetry/aggregate.py",
                     "telemetry/store.py", "telemetry/query.py",
                     "telemetry/incident.py"]),
    ("service-path", ["service/driver.py", "service/faults.py",
                      "service/elastic.py", "service/supervisor.py",
                      "telemetry/rebalance.py", "tools/metrics_serve.py"]),
])
def test_marked_modules(tag, modules):
    project = core.build_project([PORT], root=ROOT)
    pat = core.marker_re(tag)
    # the rule modules quote the markers in their docstrings
    got = sorted(m.relpath.split("/", 1)[1] for m in project.modules
                 if m.marked_module(pat) and "/analysis/" not in m.relpath)
    assert got == sorted(modules)


def test_package_is_gridlint_clean_against_baseline():
    entries = cli.load_entries(cli.default_baseline_path())
    assert all(e["justification"] for e in entries)
    baseline = {(e["rule"], e["path"], e["symbol"], e["message"])
                for e in entries}
    findings = core.run_gridlint([PORT], root=ROOT)
    new = [f for f in findings if f.baseline_key() not in baseline]
    assert new == [], [f.render() for f in new]
    matched = {f.baseline_key() for f in findings}
    assert baseline <= matched, "stale baseline entries"


def test_cli_script_entry_point():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.tools."
         "gridlint", "mpi_grid_redistribute_tpu_torch/", "--check"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gridlint: 0 finding(s)" in proc.stdout
