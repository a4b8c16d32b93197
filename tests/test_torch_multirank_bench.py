"""The multi-rank bench world (``bench.multirank``, the world
``chip_smoke.py`` starts on the card) at a small width on the CPU: 8 gloo
ranks, every part run and verified against the one-process reference
(the 8-vrank loop's slab multisets, the NumPy oracle, one device's plain
densities). No kernel launches on the CPU."""

import os
import threading
import time

from mpi_grid_redistribute_tpu_torch.bench import multirank
from mpi_grid_redistribute_tpu_torch.parallel import launch


def test_multirank_world_on_the_cpu(tmp_path):
    spec = multirank.prepare(str(tmp_path), n_local=2048,
                             deposit_shape=(16, 16, 16), config1_n=16384,
                             halo_n=2048)
    results = launch.run_world(
        "mpi_grid_redistribute_tpu_torch.bench.multirank:world_main", 8,
        args=(spec,), device="cpu", timeout=240, pg_timeout=120)
    ref = multirank.reference(spec, "cpu")
    summary = multirank.verify(results, spec, ref, "cpu")
    assert summary["vranks"]["compared"] == "per slab"
    assert summary["vranks"]["ranks"] == 2
    assert summary["flat"]["compared"] == "per slab"
    errs = summary["flat"]["deposit_max_abs_err"]
    for method in ("mxu", "scan"):
        assert errs["vs_one_device"][method] <= multirank.DEPOSIT_TOL
        # on the CPU the kernels ARE their plain versions
        assert errs["vs_plain"][method] == 0.0
        assert errs["loop_vs_plain"][method] == 0.0
    assert summary["redistribute"]["grid"] == multirank.GRID
    assert "card_vs_cpu" not in summary
    # the canonical drift loop, the halo and the hierarchical engine
    # across the 8 ranks (verify raised on any difference)
    for method in ("mxu", "scan"):
        errs = summary["drift"]["deposit_max_abs_err"][method]
        assert errs["vs_plain"] == 0.0
        assert errs["vs_one"] <= multirank.DEPOSIT_TOL
        assert len(summary["drift"]["ms_per_step"][method]) == 8
    assert summary["halo"]["ghosts"] > 0
    assert summary["hier"]["n_pods"] == 2


def test_cards_world_on_the_cpu(tmp_path):
    """The 4-rank world of ``bench.multirank.main`` (one card a rank on
    the card, NCCL there; gloo on the CPU here): the vranks loop of dev
    grid (2, 2, 1) x vgrid (1, 1, 2) with slab multisets equal to the
    8-vrank run's, ``GridRedistribute(mesh=)`` byte-equal to the oracle
    over the (2, 2, 1) grid, the hierarchical engine over two pods of two
    ranks among it."""
    spec = multirank.prepare(
        str(tmp_path), n_local=1024, deposit_shape=(16, 16, 16),
        config1_n=8192, dev_grid=multirank.CARDS_DEV_GRID,
        vgrid=multirank.CARDS_VGRID, world_grid=multirank.CARDS_DEV_GRID,
        parts=("vranks", "hier"))
    results = launch.run_world(
        "mpi_grid_redistribute_tpu_torch.bench.multirank:world_main", 4,
        args=(spec,), device="cpu", timeout=240, pg_timeout=120)
    summary = multirank.verify(results, spec,
                               multirank.reference(spec, "cpu"), "cpu")
    assert summary["vranks"]["compared"] == "per slab"
    assert summary["vranks"]["ranks"] == 4
    assert summary["backend"] == "gloo"
    assert summary["redistribute"]["grid"] == multirank.CARDS_DEV_GRID
    assert "flat" not in summary
    assert summary["hier"]["n_pods"] == 2


def test_registry_part_records_the_sharded_programs(tmp_path):
    """The world's ``registry`` part (what ``chip_smoke.py`` records the
    program registry's sharded programs in): every rank's recorded runs,
    whose entries progcheck's J001 and J004 and shardcheck's S004 judge
    clean against the committed baseline."""
    from mpi_grid_redistribute_tpu_torch.analysis import (
        baseline, progcheck, rules_prog, shardcheck,
    )

    names = ["canonical_hierarchical_sharded", "canonical_sparse_pods"]
    spec = multirank.prepare(str(tmp_path), n_local=1024, config1_n=8192,
                             parts=("registry",), registry=names)
    results = launch.run_world(
        "mpi_grid_redistribute_tpu_torch.bench.multirank:world_main", 8,
        args=(spec,), device="cpu", timeout=240, pg_timeout=120)
    entries = progcheck.world_entries([r["registry"] for r in results],
                                      names)
    programs = progcheck.default_programs()
    doc = baseline.load_progprofile_doc()
    for name in names:
        assert set(entries[name]["records"]) == {"registry",
                                                 "one_rank_overflows"}
        assert rules_prog.check_j001(name, entries[name]["sequences"]) == []
        prof = rules_prog.program_profile(entries[name]["records"]["registry"])
        assert prof == doc["profiles"][name]
    wires = {n: shardcheck.wire_profile(entries[n]["records"]["registry"],
                                        programs[n]) for n in names}
    assert shardcheck.dcn_ratio(wires) == (200, 4212)


def _started_ahead(tmp_path):
    spec = multirank.prepare(
        str(tmp_path), n_local=1024, config1_n=8192,
        dev_grid=multirank.CARDS_DEV_GRID, vgrid=multirank.CARDS_VGRID,
        world_grid=multirank.CARDS_DEV_GRID, parts=("hier",))
    spec["go_file"] = str(tmp_path / "go")
    world = {}

    def run():
        try:
            world["results"] = launch.run_world(
                "mpi_grid_redistribute_tpu_torch.bench.multirank:"
                "world_main", 4, args=(spec,), device="cpu", timeout=240,
                pg_timeout=120, nice=5)
        except launch.RankFailed as exc:
            world["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    return spec, world, thread


def test_world_started_ahead_waits_for_its_go(tmp_path):
    """A world started ahead of its turn (``chip_smoke.py`` starts it at
    niceness 10 while earlier phases run) makes its set-up, then runs
    its parts only once the go file exists."""
    spec, world, thread = _started_ahead(tmp_path)
    time.sleep(1.0)
    go = time.time()
    open(spec["go_file"], "w").close()
    thread.join(240)
    assert "error" not in world
    results = world["results"]
    assert all(r["niceness"] == min(os.nice(0) + 5, 19) for r in results)
    assert all(r["clock"]["parts_from"] >= go for r in results)
    assert all(r["clock"]["entered"] <= r["clock"]["set_up"]
               <= r["clock"]["ready"] <= r["clock"]["parts_from"]
               <= r["clock"]["parts_to"] for r in results)
    assert all(r["clock"]["ready"] >= go for r in results)
    summary = multirank.verify(results, spec,
                               multirank.reference(spec, "cpu"), "cpu")
    assert summary["hier"]["n_pods"] == 2


def test_world_started_ahead_stops_on_abort(tmp_path):
    """The ``.abort`` file beside the go file (the caller exits before
    the go) makes every waiting rank fail instead of waiting on."""
    spec, world, thread = _started_ahead(tmp_path)
    open(spec["go_file"] + ".abort", "w").close()
    thread.join(240)
    assert "results" not in world
    assert "stopped before its go" in str(world["error"])
