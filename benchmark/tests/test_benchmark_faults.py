"""Runs with the timed path broken underneath: the harness's look for a
card skipped, everything else as in a run, and ``correct`` has to come out
false for each fault a cell can have."""

import itertools
import multiprocessing as mp
import socket

import pytest
import torch

from benchmark import program
from benchmark.tests.test_benchmark_cell import measure, tiny_cell


def _wrap_build(monkeypatch, after):
    """Plant ``after(state_in, state_out, rho) -> (state, rho)`` behind
    every call of the loop."""
    real = program.build

    def build(cell, device, mesh=None):
        step = real(cell, device, mesh)

        def broken(st):
            out, rho = step(st)
            return after(st, out, rho)

        return broken

    monkeypatch.setattr(program, "build", build)


def _unchanged(st, out, rho):
    return (st[0].reshape(-1), st[1].reshape(-1), st[2], out[3]), rho


def _half_left_out(st, out, rho):
    alive = out[2].clone()
    live = alive.nonzero().squeeze(1)
    alive[live[::2]] = False
    return (out[0], out[1], alive, out[3]), rho


def _velocity_altered(st, out, rho):
    vel = out[1].clone()
    col = int(out[2].nonzero()[0])
    vel.view(torch.int32)[col] += 1  # one ulp more on every call
    return (out[0], vel, out[2], out[3]), rho


def _density_altered(st, out, rho):
    rho = rho.clone()
    rho.view(-1)[0] += 1e-3 * float(rho.mean())
    return out, rho


def _on_parity(fault, parity):
    """``fault`` on the calls of one parity only (``None``: on every
    call)."""
    if parity is None:
        return fault
    calls = itertools.count()

    def planted(st, out, rho):
        if next(calls) % 2 == parity:
            return fault(st, out, rho)
        return out, rho

    return planted


U, CIC, LGN = "uniform_2x2x2", "uniform_2x2x2_cic128", "lognormal_4x4x4"


@pytest.mark.parametrize("fault,config,traffic,parity", [
    (_unchanged, U, "m2_s4", None), (_half_left_out, U, "m2_s4", None),
    (_velocity_altered, U, "m2_s4", None), (_unchanged, CIC, "m2_s1", None),
    (_half_left_out, CIC, "m2_s1", None),
    (_velocity_altered, CIC, "m2_s1", None),
    (_density_altered, CIC, "m2_s1", None),
    # the clustered rows turn at phases of their own: each fault on the
    # calls of either parity alone
    (_unchanged, LGN, "m2_s4", 0), (_unchanged, LGN, "m2_s4", 1),
    (_half_left_out, LGN, "m2_s4", 0), (_half_left_out, LGN, "m2_s4", 1)])
def test_fault_is_not_correct(monkeypatch, fault, config, traffic, parity):
    _wrap_build(monkeypatch, _on_parity(fault, parity))
    line = measure(tiny_cell(config, traffic), 2**31 + 5)
    assert not line["correct"], (fault.__name__, parity, line["checks"])


def test_landing_left_out_is_not_correct(monkeypatch):
    """Kernel 2's landing skipped: the movers leave and never arrive."""
    from mpi_grid_redistribute_tpu_torch.ops import overlay

    monkeypatch.setattr(overlay, "overlay_scatter_planar_plain",
                        lambda flat, targets, cols: flat)
    line = measure(tiny_cell("uniform_2x2x2", "m2_s4"), 17)
    assert not line["correct"]
    assert line["checks"]["count_gap"]["value"] > 0


def _rank_main(rank, world, port, queue):
    import torch.distributed as dist

    from benchmark import spec, worker
    from mpi_grid_redistribute_tpu_torch.parallel import collectives

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        cell = tiny_cell("uniform_2x2x2_4card", "m2_s4", slots=2048)
        assert spec.load_cell(cell.name).chips == world
        mesh = program.make_mesh(cell)
        comm = worker.Group(rank, world)
        out = {}
        for fault in ("none", "exchange_left_out"):
            if fault == "exchange_left_out":
                collectives.all_to_all = (
                    lambda x, mesh, *a, **k: torch.zeros_like(x))
            res = worker.run_rank(cell, 2**31 + 77, 0.3, False, rank, comm,
                                  torch.device("cpu"), mesh=mesh)
            out[fault] = res["checks"]
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def test_four_ranks_over_gloo_and_exchange_left_out():
    """The 4-card cell's path on four CPU processes: sound, then with the
    exchange between cards left out."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, 4, port, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=240) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    sound, broken = got[0]["none"], got[0]["exchange_left_out"]
    assert all(c["value"] == 0 for c in sound.values()), sound
    assert broken["count_gap"]["value"] + broken["misplaced_rows"]["value"] > 0
    assert all(got[r] == got[0] for r in range(4))
